"""Visualize dumped panoptic outputs (counterpart of
``scripts/visualize.py``): load the pickles written by
``scripts_torch/save_outputs_panoptic.py``, optionally median-filter the
label volume, and export semantic / panoptic / uncertainty PLY point
clouds.  The port's
copy of ``scripts_tpu/visualize.py`` (the same flags), on
``pasco_torch.utils.visualization``; it needs no card.

Run: python scripts_torch/visualize.py --input frame_000000.pkl --median_filter 3
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True, help="frame_*.pkl from save_outputs")
    p.add_argument("--output_dir", default=None)
    p.add_argument("--output_index", type=int, default=-1,
                   help="which output head (subnet index or -1 = ensemble)")
    p.add_argument("--median_filter", type=int, default=0,
                   help="median filter size (0 = off)")
    args = p.parse_args()

    from pasco_torch.utils.visualization import (
        export_panoptic_ply,
        export_semantic_ply,
        export_uncertainty_ply,
        median_filter_3d,
    )

    with open(args.input, "rb") as f:
        data = pickle.load(f)
    out = data["outputs"][args.output_index]
    out_dir = args.output_dir or os.path.dirname(args.input)
    base = os.path.join(
        out_dir, os.path.basename(args.input).replace(".pkl", "")
    )

    semantic = out["semantic_seg_dense"]
    if args.median_filter:
        semantic = median_filter_3d(semantic, args.median_filter)
    export_semantic_ply(base + "_semantic.ply", semantic)
    export_panoptic_ply(
        base + "_panoptic.ply", out["panoptic_seg_dense"], out["segments_info"]
    )
    if "ssc_confidence" in out:
        export_uncertainty_ply(
            base + "_uncertainty.ply", out["ssc_confidence"], semantic
        )
    print(f"wrote {base}_{{semantic,panoptic,uncertainty}}.ply")


if __name__ == "__main__":
    main()
