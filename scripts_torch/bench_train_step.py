"""The flagship training step on the card (counterpart of
``scripts_tpu/bench_train_step.py``): ``PaSCoConfig()``, n_infers 1, one
``train_step`` (every loss, one optimizer update) after another on one
synthetic scene (``pasco_torch.training.loop.synthetic_train_scenes``,
120000 points, collated at the (256, 256, 32) train box).

    python scripts_torch/bench_train_step.py [--steps 6]

One warm-up step, then ``--steps`` timed steps on the same scene, each
synchronised.  Earlier lines give the card's name and power limit, each
step's host seconds and the ms between CUDA events recorded before and
after it (``loop.StepTimer``: host work inside the step that the card waits
on, the matching, counts; the card's busy time is ``profile_forward.py
--train``'s), the medians and the peak memory; the last
line is ``{"metric": "train_sec_per_step", "value": <median s>, "unit":
"s/step"}``.  The original PaSCo publishes no time per step, so the line
has no ``vs_baseline``.  Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scripts_torch/bench_train_step.py: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.models.unet import scene_to_model_input
    from pasco_torch.training import step as tstep
    from pasco_torch.training.loop import (StepTimer, loss_weights, new_train_state,
                                           synthetic_train_scenes, train_config)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
        flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = PaSCoConfig()
    tcfg = train_config(cfg)
    scene = synthetic_train_scenes(cfg, 1, seed=0)[0]
    state = new_train_state(cfg, dev, seed=0)
    lw, cw = loss_weights(cfg, None, dev)
    inp = scene_to_model_input(scene, dev)
    tgt = tstep.targets_to_device(scene.targets, dev)
    recs = []
    for i in range(args.steps + 1):
        timer = StepTimer(dev)
        logs = tstep.train_step(state, inp, tgt, lw, cw, tcfg, 0)
        recs.append(timer.stop())
        print(f"step {i + 1}: {recs[-1]['step_s']:.4f} s, {recs[-1]['event_ms']:.2f} ms "
              f"between events, total_loss {float(logs['total_loss']):.4f}", flush=True)
    timed = recs[1:]
    sec = statistics.median(r["step_s"] for r in timed)
    ev_ms = statistics.median(r["event_ms"] for r in timed)
    print(f"median over {len(timed)} steps: {sec:.4f} s/step, {ev_ms:.2f} ms between events, "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
    print(json.dumps({"metric": "train_sec_per_step", "value": round(sec, 4),
                      "unit": "s/step"}))


if __name__ == "__main__":
    main()
