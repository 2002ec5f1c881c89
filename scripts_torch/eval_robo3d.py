"""SemanticKITTI-C (Robo3D) corruption evaluation CLI of the port
(counterpart of ``scripts_tpu/eval_robo3d.py``): the path of
``scripts_torch/eval.py`` over ``KittiDatasetRobo3D``, one condition and
severity level per run.

    python scripts_torch/eval_robo3d.py --dataset_root <kitti> \\
        --dataset_preprocess_root <dumps> --model_path <dir> --condition fog --level light
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from pasco_torch.inference.evaluate import PRESETS

    p = argparse.ArgumentParser()
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--dataset_preprocess_root", default="")
    p.add_argument("--instance_label_root", default="")
    p.add_argument("--model_path", required=True)
    p.add_argument("--n_infers", type=int, default=1)
    p.add_argument("--condition", default="fog")
    p.add_argument("--level", default="light")
    p.add_argument("--limit_batches", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--config", default="flagship", choices=PRESETS,
                   help="model/scene preset; the others are for smoke runs and the CPU")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    from pasco_torch.data.semantic_kitti.collate import collate
    from pasco_torch.data.semantic_kitti.params import CLASS_NAMES
    from pasco_torch.data.semantic_kitti.robo3d import KittiDatasetRobo3D
    from pasco_torch.inference import evaluate as ev
    from pasco_torch.metrics.tables import print_all

    cfg = ev.eval_config(args.config, args.n_infers)
    ds = KittiDatasetRobo3D(
        root=args.dataset_root, preprocess_root=args.dataset_preprocess_root,
        instance_label_root=args.instance_label_root, split="val",
        n_subnets=args.n_infers, data_aug=True, condition=args.condition,
        level=args.level, seed=args.seed)
    first = collate(ds[0], cfg)
    cfg = ev.fit_in_channels(cfg, args.config, first.point_feats.shape[-1])
    net = ev.load_net(cfg, args.device, model_path=args.model_path)
    summary, _, _ = ev.evaluate(ds, cfg, ev.adaptive_forward(cfg, net), args.limit_batches)
    print(f"== Robo3D {args.condition} / {args.level} ==")
    print_all(summary, cfg.model.n_infers, CLASS_NAMES)


if __name__ == "__main__":
    main()
