"""SSCBench-KITTI360 training CLI of the port (counterpart of
``scripts_tpu/train_kitti360.py``: 19 classes, 8 raw input channels, 80
epochs, reference ``scripts/train_kitti360.py:111,115,152``), driving
``pasco_torch.training.loop.train`` on ``--device`` (the card by default;
it raises without one).

    python scripts_torch/train_kitti360.py --dataset_root <kitti360> \\
        --label_root <sscbench labels> --match_file kitti_360_match.txt --n_infers 2

The run's metrics and checkpoints go to
``<log_dir>/pasco_tpu_kitti360_np<n_infers>`` (the reference CLI's name, so
that both packages name a run alike); a run started again with the same
flags resumes from its latest checkpoint.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--instance_label_root", default="")
    p.add_argument("--label_root", default="",
                   help="SSCBench-KITTI360 *_1_1.npy label volumes")
    p.add_argument("--match_file", default="",
                   help="kitti_360_match.txt (raw frame-id mapping)")
    p.add_argument("--log_dir", default="logs")
    p.add_argument("--n_infers", type=int, default=1)
    p.add_argument("--max_epochs", type=int, default=80)
    p.add_argument("--mask_weight", type=float, default=40.0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--limit_train_batches", type=int, default=None)
    p.add_argument("--limit_val_batches", type=int, default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def build_config(args):
    """``kitti360_config(n_infers)`` with the flags' loss and optimizer
    settings (``scripts_tpu/train_kitti360.py:38-42``)."""
    from pasco_torch.core.config import LossConfig, OptimConfig, kitti360_config

    return kitti360_config(n_infers=args.n_infers).replace(
        loss=LossConfig(mask_weight=args.mask_weight),
        optim=OptimConfig(lr=args.lr, weight_decay=args.weight_decay))


def main(argv=None):
    args = parse_args(argv)
    from pasco_torch.data.kitti360.dataset import Kitti360Dataset
    from pasco_torch.data.kitti360.params import CLASS_FREQUENCIES
    from pasco_torch.training.loop import train

    roots = dict(root=args.dataset_root, label_root=args.label_root,
                 instance_label_root=args.instance_label_root, match_file=args.match_file,
                 n_subnets=args.n_infers, seed=args.seed)
    return train(
        build_config(args), Kitti360Dataset(split="train", **roots),
        val_dataset=Kitti360Dataset(split="val", **roots), n_epochs=args.max_epochs,
        log_dir=os.path.join(args.log_dir, f"pasco_tpu_kitti360_np{args.n_infers}"),
        class_frequencies=CLASS_FREQUENCIES, seed=args.seed,
        limit_train_batches=args.limit_train_batches,
        limit_val_batches=args.limit_val_batches, device=args.device)


if __name__ == "__main__":
    main()
