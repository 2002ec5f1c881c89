"""Offline instance-label generation CLI.

Counterpart of ``label_gen/gen_instance_labels.py`` (reference): floodfill
instance ids over thing-class voxels.  The native C++ connected-components
kernel makes this minutes instead of the reference's ~10 h
(README.md:206).

The port's copy of ``scripts_tpu/gen_instance_labels.py`` (the same flags),
on ``pasco_torch.data.label_gen``; it needs no card.

Run: python scripts_torch/gen_instance_labels.py --dataset_root ... \
        --output_root .../instance_labels_v2
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--output_root", required=True)
    p.add_argument("--n_process", type=int, default=8)
    p.add_argument("--frame_interval", type=int, default=5)
    p.add_argument(
        "--sequences", nargs="*", default=None,
        help="default: all train+val sequences",
    )
    args = p.parse_args()

    from pasco_torch.data.label_gen import generate_all
    from pasco_torch.data.semantic_kitti.params import SPLIT_SEQUENCES

    seqs = args.sequences or (
        SPLIT_SEQUENCES["train"] + SPLIT_SEQUENCES["val"]
    )
    t0 = time.time()
    outs = generate_all(
        args.dataset_root,
        args.output_root,
        seqs,
        n_processes=args.n_process,
        frame_interval=args.frame_interval,
    )
    print(f"wrote {len(outs)} label files in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
