"""SemanticKITTI training CLI of the port (counterpart of
``scripts_tpu/train.py``): the same flags, dropout schedule and experiment
name, driving ``pasco_torch.training.loop.train`` on ``--device`` (the
card by default; it raises without one).

    python scripts_torch/train.py --dataset_root /path/to/semkitti \\
        --n_infers 1 --log_dir logs

The run's metrics, TensorBoard scalars (where ``tensorboard`` imports) and
checkpoints go to ``<log_dir>/<exp_name>``; a run started again with the
same flags resumes from its latest checkpoint.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def exp_name(args) -> str:
    """Config-encoding experiment name (reference ``train.py:90-109``),
    the reference's ``pasco_tpu_`` prefix included, so that both packages
    name a run alike."""
    name = f"pasco_tpu_{args.dataset}_np{args.n_infers}"
    name += f"_f{args.f}_nq{args.num_queries}"
    name += f"_maskWeight{args.mask_weight}"
    if args.heavy_decoder:
        name += "_heavyDecoder"
    name += f"_drop{args.net_3d_dropout}_aug{int(args.data_aug)}"
    return name


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="semantic_kitti")
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--dataset_preprocess_root", default="")
    p.add_argument("--instance_label_root", default="")
    p.add_argument("--log_dir", default="logs")
    p.add_argument("--n_infers", type=int, default=1)
    p.add_argument("--f", type=int, default=64)
    p.add_argument("--num_queries", type=int, default=100)
    p.add_argument("--mask_weight", type=float, default=40.0)
    p.add_argument("--heavy_decoder", action="store_true")
    p.add_argument("--use_se_layer", action="store_true")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--max_epochs", type=int, default=60)
    p.add_argument("--transformer_dropout", type=float, default=0.2)
    p.add_argument("--net_3d_dropout", type=float, default=0.0)
    p.add_argument("--n_dropout_levels", type=int, default=3)
    p.add_argument("--point_dropout_ratio", type=float, default=0.05)
    p.add_argument("--data_aug", type=lambda x: x == "True", default=True)
    p.add_argument("--max_angle", type=float, default=30.0)
    p.add_argument("--translate_distance", type=float, default=0.2)
    p.add_argument("--scale_range", type=float, default=0.0)
    p.add_argument("--no_voxel_query_loss", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--limit_train_batches", type=int, default=None)
    p.add_argument("--limit_val_batches", type=int, default=None)
    p.add_argument("--accum_batch", type=int, default=1)
    p.add_argument("--n_fuse_scans", type=int, default=1)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def build_config(args):
    """The ``PaSCoConfig`` of the flags, with the reference's dropout
    schedule (``train.py:83-87``): ``--point_dropout_ratio`` at
    ``encoder_dropouts[0]``, ``--net_3d_dropout`` on the last
    ``--n_dropout_levels`` encoder stages and the first decoder stages."""
    from pasco_torch.core.config import (
        LossConfig, ModelConfig, OptimConfig, PaSCoConfig, TransformerConfig)

    encoder_dropouts = [args.point_dropout_ratio, 0.0, 0.0, 0.0, 0.0, 0.0]
    decoder_dropouts = [0.0] * 5
    for level in range(args.n_dropout_levels):
        encoder_dropouts[-level - 1] = args.net_3d_dropout
        decoder_dropouts[level] = args.net_3d_dropout
    return PaSCoConfig(
        model=ModelConfig(
            f=args.f, n_infers=args.n_infers, num_queries=args.num_queries,
            heavy_decoder=args.heavy_decoder, use_se_layer=args.use_se_layer,
            encoder_dropouts=tuple(encoder_dropouts),
            decoder_dropouts=tuple(decoder_dropouts),
            transformer=TransformerConfig(num_queries=args.num_queries,
                                          dropout=args.transformer_dropout),
        ),
        loss=LossConfig(mask_weight=args.mask_weight,
                        use_voxel_query_loss=not args.no_voxel_query_loss),
        optim=OptimConfig(lr=args.lr, weight_decay=args.weight_decay),
    )


def main(argv=None):
    args = parse_args(argv)
    from pasco_torch.data.semantic_kitti.dataset import KittiDataset
    from pasco_torch.training.loop import train

    roots = dict(root=args.dataset_root, preprocess_root=args.dataset_preprocess_root,
                 instance_label_root=args.instance_label_root,
                 n_subnets=args.n_infers, data_aug=args.data_aug, seed=args.seed)
    train_ds = KittiDataset(
        split="train", max_angle=args.max_angle, scale_range=args.scale_range,
        max_translation=(args.translate_distance, args.translate_distance,
                         args.translate_distance / 2),
        n_fuse_scans=args.n_fuse_scans, **roots)
    val_ds = KittiDataset(split="val", **roots)
    return train(
        build_config(args), train_ds, val_dataset=val_ds, n_epochs=args.max_epochs,
        log_dir=os.path.join(args.log_dir, exp_name(args)), seed=args.seed,
        limit_train_batches=args.limit_train_batches,
        limit_val_batches=args.limit_val_batches, accum_steps=args.accum_batch,
        device=args.device)


if __name__ == "__main__":
    main()
