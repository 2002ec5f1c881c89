"""Train the flagship briefly on synthetic scenes and save an npz for
``BENCH_TRAINED_CKPT`` (counterpart of ``scripts_tpu/make_bench_ckpt.py``).

    python scripts_torch/make_bench_ckpt.py --steps 300 --out build/bench_ckpt.npz
    BENCH_TRAINED_CKPT=build/bench_ckpt.npz python scripts_torch/bench.py

At random init the completion heads keep nearly every decoder cell
((C-1)/C of them pass ``argmax != 0``); a trained PaSCo keeps about the
occupied fraction.  A few hundred steps of the real loss on synthetic
scenes move the keep sets toward the scenes' occupancy, so the bench can
time the kernels on sparser decoder masks.

The recipe is the reference script's: ``PaSCoConfig()`` at n_infers 1 at
the (256, 256, 32) train box, a pool of 8 synthetic scenes (120000 points,
random 0.8 crops) drawn once from ``RandomState(0)`` and collated, then
exactly ``--steps`` steps of ``training/step.py:train_step`` cycling the
pool in order (step ``i`` takes scene ``i % 8``), the loss printed every
``--log_every`` steps and at the last.  The weights do not depend on the
box.  The npz holds the ``params/...`` and ``batch_stats/...`` arrays in
f32 (:func:`pasco_torch.convert.torch_to_flax`), which ``scripts_torch/
bench.py`` loads with ``strict=True``.  Runs on the card (``--device
cuda``, the default; raises without one).
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
POOL = 8      # scenes, cycled in order (scripts_tpu/make_bench_ckpt.py:110)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "bench_ckpt.npz"))
    ap.add_argument("--log_every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from pasco_torch.convert import torch_to_flax
    from pasco_torch.core import config
    from pasco_torch.data.semantic_kitti.collate import collate
    from pasco_torch.data.semantic_kitti.dataset import process_scene
    from pasco_torch.data.semantic_kitti.params import CLASS_FREQUENCIES
    from pasco_torch.data.synthetic import make_scene
    from pasco_torch.models.unet import scene_to_model_input
    from pasco_torch.training import loop
    from pasco_torch.training import step as tstep

    cfg = loop.train_config(config.PaSCoConfig())
    rng = np.random.RandomState(0)

    def draw_scene():
        sc = make_scene(rng, scene_size=cfg.scene.scene_size,
                        n_points=min(cfg.capacity.num_points, 120000),
                        point_feat_dim=cfg.model.in_channels - 6)
        return collate([process_scene(sc, None, rng, train_crop=True)], cfg)

    scenes = [draw_scene() for _ in range(POOL)]
    state = loop.new_train_state(cfg, args.device, seed=0)
    dev = next(state.net.parameters()).device
    lw, cw = loop.loss_weights(cfg, CLASS_FREQUENCIES, dev)
    t0 = time.perf_counter()
    step_s, losses = [], []
    for i in range(args.steps):
        sc = scenes[i % POOL]
        t = time.perf_counter()
        logs = tstep.train_step(state, scene_to_model_input(sc, dev),
                                tstep.targets_to_device(sc.targets, dev), lw, cw, cfg, seed=1)
        losses.append(float(logs["total_loss"]))     # one sync per step
        step_s.append(time.perf_counter() - t)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i}: loss={losses[-1]:.2f} ({time.perf_counter() - t0:.0f}s)",
                  flush=True)
    if step_s:
        print(f"{state.step} steps in {time.perf_counter() - t0:.0f} s, median "
              f"{statistics.median(step_s):.4f} s/step; total_loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}", flush=True)
    flat = torch_to_flax(state.net.state_dict())
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **flat)
    print(f"saved {len(flat)} arrays to {args.out}", flush=True)


if __name__ == "__main__":
    main()
