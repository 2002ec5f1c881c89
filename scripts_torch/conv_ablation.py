"""Where the time of the ``masked_conv3`` kernel goes, by ablation, on one
GPU.

    python scripts_torch/conv_ablation.py [--out build/conv_ablation.json]

Times the kernel as built and four variants with one part of its per-tap
loop removed (``MASKED_CONV3_ABLATE`` in ``pasco_torch/csrc/
masked_conv3.cu``): the weight-slab loads, the per-tap barrier, the
``ldmatrix`` of the A fragments, and the ``wgmma`` products themselves.
The variants compute wrong results and exist only to be timed.  Each
variant runs in its own process, whose kernels are built with the define
added to the nvcc flags (``pasco_torch.kernels.EXTRA_FLAGS_ENV``).  Times
(median of 7, CUDA events) the full launch form (BN prologue, bias, skip,
relu) and the flipped data-gradient form at the near-dense shapes of the
main path (a 90% random mask over the s1/s2/s4 boxes), beside one
``F.conv3d`` on the masked input (TF32 off), and prints the card and one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

VARIANTS = ("as built", "no weight-slab loads", "no per-tap barrier", "no ldmatrix",
            "no wgmma")   # MASKED_CONV3_ABLATE = index
SHAPES = ((352, 32, 352, 64), (176, 16, 176, 128), (88, 8, 88, 256))


def time_variant():
    """This process's build of the kernel at every shape: a list of
    (library_ms, full_ms, dx_ms)."""
    from chip_smoke import conv3d_library, time_ms
    from pasco_torch.ops import conv

    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for X, Z, Y, c in SHAPES:
        m = torch.rand((X, Z, Y), generator=g, device=dev) < 0.9
        x = torch.randn((X, Z, Y, c), generator=g, device=dev).to(bf)
        w = (torch.randn((27, c, c), generator=g, device=dev) * (27 * c) ** -0.5).to(bf)
        kw = dict(bias=torch.rand(c, generator=g, device=dev) * 0.2,
                  affine=(torch.rand(c, generator=g, device=dev) + 0.5,
                          torch.rand(c, generator=g, device=dev) * 0.1),
                  relu_in=True, skip=torch.randn((X, Z, Y, c), generator=g, device=dev).to(bf),
                  relu_out=True)
        tiles = conv.conv_tiles(m)
        xm = torch.where(m[..., None], x, torch.zeros((), dtype=bf, device=dev))
        out.append((time_ms(conv3d_library(xm, w), reps=7),
                    time_ms(lambda: conv.masked_conv3(x, m, w, tiles=tiles, **kw), reps=7),
                    time_ms(lambda: conv.conv3_dx(x, m, w, tiles), reps=7)))
    return out


def main():
    from pasco_torch import kernels

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "conv_ablation.json"))
    ap.add_argument("--variant", type=int, default=None,
                    help="time one variant in this process and print its JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_ablation.py: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
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
        env[kernels.EXTRA_FLAGS_ENV] = f"-DMASKED_CONV3_ABLATE={i}" if i else ""
        res = subprocess.run([sys.executable, __file__, "--variant", str(i)], env=env,
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"{name}: exit {res.returncode}\n{res.stdout}{res.stderr}")
        times[name] = json.loads(res.stdout.strip().splitlines()[-1])
    rows = []
    for k, (X, Z, Y, c) in enumerate(SHAPES):
        row = dict(shape=[X, Z, Y, c], library_ms=times[VARIANTS[0]][k][0])
        row.update({n: dict(full_ms=t[k][1], dx_ms=t[k][2]) for n, t in times.items()})
        print(f"{(X, Z, Y, c)}: library {row['library_ms']:.3f} ms; " + "; ".join(
            f"{n} {row[n]['full_ms']:.3f} / {row[n]['dx_ms']:.3f}" for n in VARIANTS),
            flush=True)
        rows.append(row)
    res = dict(card=card, rows=rows)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
