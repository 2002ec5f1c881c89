"""Where the time of the ``up_preamble`` and ``down2_fused`` kernels goes, by
ablation, on one GPU.

    python scripts_torch/updown_ablation.py [--out build/updown_ablation.json]

Times both kernels as built and five variants
(``UPDOWN_ABLATE`` in ``pasco_torch/csrc/{up_preamble,down2_fused}.cu``):
four with one part removed (the weight-slab loads, the ``wgmma``
products, the output stores, and, the up-preamble only, the elementwise
math of its two epilogues), which compute wrong results and exist only to
be timed, and one that runs the up-preamble's dec_s1 on the weight ring
of dec_s2/s4 in place of its resident weights (right results).  Each variant
runs in its own process, whose kernels are built with the define added to
the nvcc flags (``pasco_torch.kernels.EXTRA_FLAGS_ENV``).  The cases are
``chip_smoke.py``'s main-path shapes on the first synthetic scan: the
up-preamble at dec_s4/s2/s1 near dense, the down step at enc_s2/s4/s8 on
the scan's occupancy.  For each: the time per call of ``chip_smoke.time_ms``
over 7 batches (``ms``, back-to-back calls, as ``chip_smoke.py`` times
them) and the kernel's own device time from the profiler (``device_ms``).
Prints the card and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

VARIANTS = ("as built", "no weight-slab loads", "no wgmma", "no output stores",
            "no epilogue math", "dec_s1 on the weight ring")


def device_ms(fn, pattern, reps=7):
    """Mean device time (ms) per call of the kernels whose name matches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if re.search(pattern, e.key):
            us += getattr(e, "device_time_total", None) or e.cuda_time_total
    return us / reps / 1e3


def cases(gen):
    """(label, call, kernel-name pattern) of every main-path case."""
    import chip_smoke as cs
    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.ops import deconv, down
    from pasco_torch.ops.dense_ops import bbox_mask, maxpool2_mask, upsample2_mask

    dev = torch.device("cuda", 0)
    cfg = PaSCoConfig()
    inp = cs.make_scans(cfg, 1, dev)[0][1]
    randn, vec, masked = cs._rand_fns(gen, dev)
    fm = cfg.model.f_maps
    box, occ, _ = cs.scan_masks(cfg, inp)
    occs = {1: occ}
    for sc in (2, 4, 8):
        occs[sc] = maxpool2_mask(occs[sc // 2])
    out = []
    for i, sc in enumerate((2, 4, 8)):
        ci, co = fm[i], fm[i + 1]
        m, m2 = occs[sc // 2], occs[sc]
        args = (masked(randn(*m.shape, ci), m), m, m2, randn(8, ci, co, scale=(8 * ci) ** -0.5),
                vec(co), (vec(co, 0.5, 1.5), vec(co)), (vec(co, 0.5, 1.5), vec(co)))
        tiles = down.down_tiles(m2)
        out.append((f"down2_fused enc_s{sc} scan occupancy",
                    lambda a=args, t=tiles: down.down2_fused(*a, tiles=t), "down2_kernel"))
    for i, sc in ((2, 4), (1, 2), (0, 1)):
        ci, co = fm[i + 1], fm[i]
        bbox = bbox_mask(box, sc, inp.global_min, inp.global_max)
        pkeep = maxpool2_mask(bbox)
        child = upsample2_mask(pkeep) & bbox
        union = child | occs[sc]
        X, Z, Y = child.shape
        args = (randn(X // 2, Z // 2, Y // 2, ci), pkeep, child, union,
                masked(randn(X, Z, Y, co), occs[sc]), box, sc,
                randn(8, ci, co, scale=(8 * ci) ** -0.5), vec(co),
                (vec(co, 0.5, 1.5), vec(co)), (vec(co + 3, 0.5, 1.5), vec(co + 3)),
                randn(co + 3, co, scale=0.1), vec(co))
        tiles = deconv.up_tiles(union)
        out.append((f"up_preamble dec_s{sc} near dense",
                    lambda a=args, t=tiles: deconv.up_preamble(*a, tiles=t),
                    "up_preamble_kernel"))
    return out


def time_variant():
    from chip_smoke import time_ms

    return {label: dict(ms=time_ms(fn, reps=7), device_ms=device_ms(fn, pat))
            for label, fn, pat in cases(torch.Generator().manual_seed(0))}


def main():
    from pasco_torch import kernels

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "updown_ablation.json"))
    ap.add_argument("--variant", type=int, default=None,
                    help="time one variant in this process and print its JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("updown_ablation.py: no CUDA device")
    if args.variant is not None:
        print(json.dumps(time_variant()))
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    times = {}
    for i, name in enumerate(VARIANTS):
        env = dict(os.environ)
        env[kernels.EXTRA_FLAGS_ENV] = f"-DUPDOWN_ABLATE={i}" if i else ""
        res = subprocess.run([sys.executable, __file__, "--variant", str(i)], env=env,
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"{name}: exit {res.returncode}\n{res.stdout}{res.stderr}")
        times[name] = json.loads(res.stdout.strip().splitlines()[-1])
    for label in times[VARIANTS[0]]:
        print(f"{label}: " + "; ".join(
            f"{n} {t[label]['ms']:.3f} ms (device {t[label]['device_ms']:.3f})"
            for n, t in times.items()), flush=True)
    res = dict(card=card, times=times)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
