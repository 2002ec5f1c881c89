"""WaffleIron point-feature extraction CLI of the port (counterpart of
``scripts_tpu/extract_point_features.py``, itself the reference's
``WaffleIron_mod/extract_point_features.py``): the Segmenter with
``--num_votes`` test-time-augmented passes per scan (vote 0 untransformed,
then ``generate_random_transformation(rng, max_angle=180, flip=True)``
from ``RandomState(0)``), the softmax votes averaged, and one pickle
``{embedding [votes, C, N], coords [N, 4], vote [N, n_classes]}`` per scan
under ``<output_root>/waffleiron_v2/sequences/<seq>/seg_feats_tta/``: the
files the port's ``KittiDataset`` reads as PaSCo's 283-column point
features.

    python scripts_torch/extract_point_features.py --dataset_root <kitti> \\
        --output_root <dir> --checkpoint <weights>

The Segmenter reads ``[intensity, x, y, z, |xyz|]``, the reference
extractor's layout (the reference trainer's differs: ROADMAP queue 3),
of the first ``--max_points`` points of a scan; only those rows are
computed and written.  ``--checkpoint`` takes the reference's ``.npz``
(``variables``), a JAX trainer's ``ckpt_*.pkl`` or the port's
(``pasco_torch/convert.py:load_waffleiron_state_dict``); without one the
weights are the port's seeded init.  Runs on the card (``--device cuda``,
the default; raises without one).
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--output_root", required=True)
    p.add_argument("--sequences", nargs="*", default=["08"])
    p.add_argument("--num_votes", type=int, default=10)
    p.add_argument("--max_points", type=int, default=131072)
    p.add_argument("--checkpoint", default=None,
                   help="WaffleIron weights: .npz of variables or a ckpt_*.pkl (optional)")
    p.add_argument("--frame_interval", type=int, default=5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from pasco_torch.convert import load_waffleiron_state_dict
    from pasco_torch.data.semantic_kitti import io_data
    from pasco_torch.data.transform_utils import generate_random_transformation, transform_xyz
    from pasco_torch.models.waffleiron import (
        Segmenter,
        grid_cell_indices,
        knn_indices,
        segmenter_device,
    )

    dev = segmenter_device(args.device)
    net = Segmenter(n_classes=19, in_channels=5)
    if args.checkpoint:
        net.load_state_dict(load_waffleiron_state_dict(args.checkpoint))
    else:
        net.reset_parameters(torch.Generator().manual_seed(0))
    net = net.to(dev).eval()
    P = args.max_points

    def prep(xyz, intensity, rng=None):
        if rng is not None:
            T = generate_random_transformation(rng, max_angle=180, flip=True)
            xyz = transform_xyz(xyz, T)
        n = min(len(xyz), P)
        feats = np.zeros((n, 5), np.float32)
        feats[:, 0] = intensity[:n, 0]
        feats[:, 1:4] = xyz[:n]
        feats[:, 4] = np.linalg.norm(xyz[:n], axis=1)
        nbrs = knn_indices(xyz[:n], 16)
        cells = grid_cell_indices(xyz[:n])

        def put(a, dtype):
            return torch.from_numpy(a).to(device=dev, dtype=dtype)

        return (put(feats, torch.float32), put(nbrs, torch.int64), put(cells, torch.int64),
                torch.ones(n, dtype=torch.bool, device=dev))

    rng = np.random.RandomState(0)
    for seq in args.sequences:
        vel = os.path.join(args.dataset_root, "dataset", "sequences", seq, "velodyne")
        if not os.path.isdir(vel):
            continue
        out_dir = os.path.join(args.output_root, "waffleiron_v2", "sequences", seq,
                               "seg_feats_tta")
        os.makedirs(out_dir, exist_ok=True)
        frames = sorted(f[:-4] for f in os.listdir(vel) if f.endswith(".bin"))
        for frame in frames[:: args.frame_interval]:
            pc = io_data.read_pointcloud(os.path.join(vel, f"{frame}.bin"))
            xyz, intensity = pc[:, :3].astype(np.float64), pc[:, 3:4]
            embeddings, votes = [], None
            for v in range(args.num_votes):
                with torch.no_grad():
                    logits, tokens = net(*prep(xyz, intensity, rng if v > 0 else None))
                    prob = torch.softmax(logits, dim=-1).cpu().numpy()
                votes = prob if votes is None else votes + prob
                embeddings.append(tokens.cpu().numpy().T)
            out = {
                "embedding": np.stack(embeddings),      # [votes, C, N]
                "coords": np.concatenate([xyz[: len(votes)], intensity[: len(votes)]], axis=1),
                "vote": votes / args.num_votes,
            }
            with open(os.path.join(out_dir, f"{frame}.pkl"), "wb") as f:
                pickle.dump(out, f)
            print(f"{seq}/{frame}: {len(votes)} points")


if __name__ == "__main__":
    main()
