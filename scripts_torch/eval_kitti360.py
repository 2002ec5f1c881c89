"""SSCBench-KITTI360 evaluation CLI of the port (counterpart of
``scripts_tpu/eval_kitti360.py``, itself the reference's
``scripts/eval_kitti360.py`` with its val/test switch at ``:69-75``): the
split's loader with augmentation on (each subnet sees a differently
augmented copy), the latest checkpoint of ``--model_path`` (a directory
without one leaves the seeded random init, as the reference CLI does),
every scan through the scene-adaptive forward, the ensembling and the
``Evaluator`` (19 classes, things 1..6), then the README tables.

    python scripts_torch/eval_kitti360.py --dataset_root <kitti360> \\
        --label_root <sscbench labels> --match_file kitti_360_match.txt \\
        --model_path <checkpoint dir> --n_infers 2

Runs on the card (``--device cuda``, the default; raises without one);
``--device cpu`` runs the plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--instance_label_root", default="")
    p.add_argument("--label_root", default="",
                   help="SSCBench-KITTI360 *_1_1.npy label volumes")
    p.add_argument("--match_file", default="",
                   help="kitti_360_match.txt (raw frame-id mapping)")
    p.add_argument("--model_path", required=True)
    p.add_argument("--n_infers", type=int, default=1)
    p.add_argument("--split", default="test", choices=["val", "test"])
    p.add_argument("--limit_batches", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from pasco_torch.core.config import kitti360_config
    from pasco_torch.data.kitti360.dataset import Kitti360Dataset
    from pasco_torch.data.kitti360.params import CLASS_FREQUENCIES, CLASS_NAMES
    from pasco_torch.inference import evaluate as ev
    from pasco_torch.metrics.tables import print_all

    cfg = kitti360_config(n_infers=args.n_infers)
    ds = Kitti360Dataset(
        root=args.dataset_root, label_root=args.label_root,
        instance_label_root=args.instance_label_root, match_file=args.match_file,
        split=args.split, n_subnets=args.n_infers, data_aug=True, seed=args.seed)
    net = ev.load_net(cfg, args.device, model_path=args.model_path)
    summary, inf_times, ens_times = ev.evaluate(
        ds, cfg, ev.adaptive_forward(cfg, net, CLASS_FREQUENCIES), args.limit_batches)
    print_all(summary, cfg.model.n_infers, CLASS_NAMES,
              inference_time=ev.mean_after_first(inf_times),
              ensemble_time=ev.mean_after_first(ens_times))


if __name__ == "__main__":
    main()
