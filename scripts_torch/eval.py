"""SemanticKITTI evaluation CLI of the port (counterpart of
``scripts_tpu/eval.py``, itself the reference's ``scripts/eval.py:13-81``):
the val loader with augmentation on (each subnet sees a differently
augmented copy), the weights of a released reference ``.ckpt``
(``--torch_ckpt``) or of a checkpoint directory (``--model_path``), every
scan through the scene-adaptive forward, the ensembling and the
``Evaluator``, then the README tables.

    python scripts_torch/eval.py --dataset_root <kitti> --torch_ckpt pasco_single.ckpt
    python scripts_torch/eval.py --dataset_root <kitti> --model_path <dir> --n_infers 3

Runs on the card (``--device cuda``, the default; raises without one);
``--device cpu`` runs the plain versions of the kernels.
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
    p.add_argument("--model_path", default="", help="CheckpointManager directory")
    p.add_argument("--torch_ckpt", default="",
                   help="released reference .ckpt (e.g. pasco_single.ckpt), converted "
                   "on the fly by pasco_torch/training/convert_torch.py")
    p.add_argument("--n_infers", type=int, default=1)
    p.add_argument("--split", default="val")
    p.add_argument("--limit_batches", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--config", default="flagship", choices=PRESETS,
                   help="model/scene preset; the others are for smoke runs and the CPU")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    if not (args.model_path or args.torch_ckpt):
        p.error("one of --model_path / --torch_ckpt is required")

    from pasco_torch.data.semantic_kitti.collate import collate
    from pasco_torch.data.semantic_kitti.dataset import KittiDataset
    from pasco_torch.data.semantic_kitti.params import CLASS_NAMES
    from pasco_torch.inference import evaluate as ev
    from pasco_torch.metrics.tables import print_all

    cfg = ev.eval_config(args.config, args.n_infers)
    ds = KittiDataset(
        root=args.dataset_root, preprocess_root=args.dataset_preprocess_root,
        instance_label_root=args.instance_label_root, split=args.split,
        n_subnets=args.n_infers, data_aug=True, seed=args.seed)
    first = collate(ds[0], cfg)
    cfg = ev.fit_in_channels(cfg, args.config, first.point_feats.shape[-1])
    net = ev.load_net(cfg, args.device, args.torch_ckpt, args.model_path)

    def progress(i, n):
        if i % 10 == 0:
            print(f"[{i}/{n}] scenes evaluated", file=sys.stderr)

    summary, inf_times, ens_times = ev.evaluate(
        ds, cfg, ev.adaptive_forward(cfg, net), args.limit_batches, progress)
    print_all(summary, cfg.model.n_infers, CLASS_NAMES,
              inference_time=ev.mean_after_first(inf_times),
              ensemble_time=ev.mean_after_first(ens_times))


if __name__ == "__main__":
    main()
