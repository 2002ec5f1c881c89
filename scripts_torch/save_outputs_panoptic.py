"""Dump the port's panoptic inference outputs for chosen val frames
(counterpart of ``scripts_tpu/save_outputs_panoptic.py``): a pickle of
each frame's predictions and, with ``--export_ply``, PLY point clouds of
the ensemble's semantic, panoptic and uncertainty volumes.

    python scripts_torch/save_outputs_panoptic.py --dataset_root <kitti> \\
        --model_path <dir> --output_dir <out> --frames 0 5 --export_ply
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--dataset_preprocess_root", default="")
    p.add_argument("--instance_label_root", default="")
    p.add_argument("--model_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--n_infers", type=int, default=1)
    p.add_argument("--frames", nargs="*", default=None,
                   help="frame indices into the val split")
    p.add_argument("--export_ply", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    import numpy as np

    from pasco_torch.data.semantic_kitti.collate import collate
    from pasco_torch.data.semantic_kitti.dataset import KittiDataset
    from pasco_torch.inference import evaluate as ev
    from pasco_torch.utils.visualization import (
        export_panoptic_ply, export_semantic_ply, export_uncertainty_ply)

    cfg = ev.eval_config("flagship", args.n_infers)
    ds = KittiDataset(
        root=args.dataset_root, preprocess_root=args.dataset_preprocess_root,
        instance_label_root=args.instance_label_root, split="val",
        n_subnets=args.n_infers, data_aug=True, seed=args.seed)
    fwd = ev.adaptive_forward(cfg, ev.load_net(cfg, args.device, model_path=args.model_path))

    os.makedirs(args.output_dir, exist_ok=True)
    frames = [int(f) for f in (args.frames or range(min(10, len(ds))))]
    for fi in frames:
        scene = collate(ds[fi], cfg)
        results = ev.scene_results(fwd, scene, cfg)
        out_path = os.path.join(args.output_dir, f"frame_{fi:06d}.pkl")
        with open(out_path, "wb") as f:
            pickle.dump({
                "outputs": [{k: v for k, v in o.items() if k != "sem_prob_dense"}  # large
                            for o in results["outputs"]],
                "Ts": np.asarray(scene.Ts),
            }, f)
        if args.export_ply:
            ens = results["outputs"][-1]
            base = os.path.join(args.output_dir, f"frame_{fi:06d}")
            export_semantic_ply(base + "_semantic.ply", ens["semantic_seg_dense"])
            export_panoptic_ply(base + "_panoptic.ply", ens["panoptic_seg_dense"],
                                ens["segments_info"])
            export_uncertainty_ply(base + "_uncertainty.ply", ens["ssc_confidence"],
                                   ens["semantic_seg_dense"])
        print(f"saved {out_path}")


if __name__ == "__main__":
    main()
