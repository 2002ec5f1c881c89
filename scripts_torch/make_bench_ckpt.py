"""Train the flagship briefly on synthetic scenes through the port's
trainer and save an npz for ``BENCH_TRAINED_CKPT`` (counterpart of
``scripts_tpu/make_bench_ckpt.py``).

    python scripts_torch/make_bench_ckpt.py --steps 300 --out build/bench_ckpt.npz
    BENCH_TRAINED_CKPT=build/bench_ckpt.npz python scripts_torch/bench.py

At random init the completion heads keep nearly every decoder cell
((C-1)/C of them pass ``argmax != 0``); a trained PaSCo keeps about the
occupied fraction.  A few hundred steps of the real loss on synthetic
scenes move the keep sets toward the scenes' occupancy, so the bench can
time the kernels on sparser decoder masks.  ``PaSCoConfig()`` at
n_infers 1 trains through ``pasco_torch.training.loop.train`` at the
(256, 256, 32) train box on a ``SyntheticKittiDataset`` of
``min(steps, 8)`` scenes (120000 points, random 0.8 crops), one step per
scene, for whole epochs: ``--steps`` rounded up to a multiple of the pool
(300 -> 304).  The weights do not depend on the box.  The npz holds the
``params/...`` and ``batch_stats/...`` arrays in f32
(:func:`pasco_torch.convert.torch_to_flax`), which ``scripts_torch/
bench.py`` loads with ``strict=True``.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "bench_ckpt.npz"))
    args = ap.parse_args(argv)

    from pasco_torch.convert import torch_to_flax
    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.data.synthetic import SyntheticKittiDataset
    from pasco_torch.training.loop import read_metrics, train

    cfg = PaSCoConfig()
    n = min(args.steps, 8)
    dataset = SyntheticKittiDataset(
        n_scenes=n, n_subnets=1, scene_size=cfg.scene.scene_size,
        n_points=min(cfg.capacity.num_points, 120000),
        point_feat_dim=cfg.model.in_channels - 6, split="train")
    epochs = -(-args.steps // n)
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="bench_ckpt_") as log_dir:
        state = train(cfg, dataset, n_epochs=epochs, log_dir=log_dir,
                      ckpt_every_epochs=epochs)
        epoch_s = [r["epoch_time"] for r in read_metrics(log_dir) if "epoch" in r]
    hist = state.history
    # time inside the steps (CUDA events around each) per epoch; the rest
    # of an epoch the card waits on the loader
    step_s = [sum(r["event_ms"] for r in hist if r["epoch"] == e) / 1e3
              for e in range(len(epoch_s))]
    later = sum(step_s[1:]) / max(sum(epoch_s[1:]), 1e-9)
    print(f"{state.step} steps in {time.time() - t0:.0f} s, median "
          f"{statistics.median(r['step_s'] for r in hist):.4f} s/step; in steps "
          f"{100 * sum(step_s) / sum(epoch_s):.1f}% of the epochs' {sum(epoch_s):.1f} s, "
          f"{100 * later:.1f}% after the first; total_loss {hist[0]['total_loss']:.4f} "
          f"-> {hist[-1]['total_loss']:.4f}", flush=True)
    flat = torch_to_flax(state.net.state_dict())
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **flat)
    print(f"saved {len(flat)} arrays to {args.out}", flush=True)


if __name__ == "__main__":
    main()
