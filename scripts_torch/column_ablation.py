"""Where the time of the ``column_conv3`` kernel (row 7) goes, by
ablation, and how accurate it is, on one GPU.

    python scripts_torch/column_ablation.py [--out build/column_ablation.json]

Times the kernel as built and four variants (``COLUMN_CONV3_ABLATE`` in
``pasco_torch/csrc/column_conv3.cu``): without the wgmmas, with one TF32
product instead of three, without the halo loads, without the fill of
the unlisted columns, without the weight copies (these five compute
wrong results and exist only to be timed), and with every product
accumulated in the slab's sum instead of a per-tap accumulator (right, but
less accurate).  Each variant runs in its own process, whose kernels are
built with the define added to the nvcc flags
(``pasco_torch.kernels.EXTRA_FLAGS_ENV``).  The case is
``chip_smoke.column_conv_phase``'s: the first synthetic scan's s1
occupancy, C = D = 64, at every occupied column and at half of them;
times are ``chip_smoke.time_ms`` (median of 7).  For the variants that
compute the function, the error against an f64 conv at visited cells,
as max and mean of ``|d| / max|ref|``; beside the kernel as built, the
same for the plain version (cuDNN's f32 conv) and its emulations of one
and of two TF32 products.  Prints the card and one JSON line.
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

VARIANTS = ("as built", "no wgmma", "one TF32 product", "no halo loads",
            "no per-tap accumulator", "no fill of unlisted columns",
            "no weight copies")   # COLUMN_CONV3_ABLATE = index
RIGHT = (0, 4)                          # variants whose results are the function's


def time_variant(mask_path, variant):
    """This process's build at both cases: a list of (ms, max_rel, mean_rel),
    and for the kernel as built the plain versions' (max_rel, mean_rel) by
    name."""
    from chip_smoke import time_ms
    from pasco_torch.ops import column_conv as cc

    dev = torch.device("cuda", 0)
    mask = torch.load(mask_path).to(dev)
    X, Y, Z = mask.shape
    c = 64
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((X, Y, Z, c), generator=g, device=dev)
    x = torch.where(mask[..., None], x, torch.zeros((), device=dev))
    w = torch.randn((27, c, c), generator=g, device=dev) * (27 * c) ** -0.5
    b = torch.rand((c,), generator=g, device=dev) * 0.2 - 0.1
    n_cols = -(-X // 8) * -(-Y // 8)
    n_occ = int(cc.active_columns(mask, n_cols)[1])
    out, plain = [], {}
    for cap in (n_cols, n_occ // 2):
        ms = time_ms(lambda: cc.block_sparse_conv3(x, w, mask, cap, bias=b), reps=7)
        err = (None, None)
        if variant in RIGHT:
            ids, n = cc.active_columns(mask, cap)
            vis = cc.visited_cells(ids, n, X, Y)[..., None].expand(X, Y, Z)
            ref = cc.conv3_xyz(x.double(), w.double())
            ref = torch.where(mask[..., None], ref + b.double(), ref)
            mag = ref[vis].abs().max().item()

            def rel(got):
                d = (got.double() - ref)[vis].abs()
                return d.max().item() / mag, d.mean().item() / mag

            err = rel(cc.block_sparse_conv3(x, w, mask, cap, bias=b))
            if variant == 0 and cap == n_cols:
                plain["f32 plain (cuDNN)"] = rel(cc.block_sparse_conv3_plain(x, w, mask, cap,
                                                                             bias=b))
                for k in (1, 2):
                    plain[f"{k} TF32 product(s)"] = rel(cc.block_sparse_conv3_split(
                        x, w, mask, cap, bias=b, products=k))
            del ref
        out.append((ms, *err))
    return out, plain


def main():
    from pasco_torch import kernels

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "column_ablation.json"))
    ap.add_argument("--variant", type=int, default=None,
                    help="time one variant in this process and print its JSON")
    ap.add_argument("--mask", default=str(ROOT / "build" / "column_ablation_mask.pt"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("column_ablation.py: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    if args.variant is not None:
        print(json.dumps(time_variant(args.mask, args.variant)))
        return
    import chip_smoke as cs
    from pasco_torch.core.config import PaSCoConfig

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cfg = PaSCoConfig()
    inp = cs.make_scans(cfg, 1, torch.device("cuda", 0))[0][1]
    os.makedirs(os.path.dirname(args.mask), exist_ok=True)
    torch.save(cs.scan_masks(cfg, inp)[1].permute(0, 2, 1).contiguous().cpu(), args.mask)
    res = dict(card=card, cases=["every occupied column", "half the occupied columns"])
    for i, name in enumerate(VARIANTS):
        env = dict(os.environ)
        env[kernels.EXTRA_FLAGS_ENV] = f"-DCOLUMN_CONV3_ABLATE={i}" if i else ""
        run = subprocess.run([sys.executable, __file__, "--variant", str(i), "--mask",
                              args.mask], env=env, capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"{name}: exit {run.returncode}\n{run.stdout}{run.stderr}")
        res[name], plain = json.loads(run.stdout.strip().splitlines()[-1])
        print(f"{name}: " + "; ".join(
            f"{ms:.3f} ms" + (f" (max {mx:.3g}, mean {mn:.3g} of max|ref|)" if mx is not None
                              else "") for ms, mx, mn in res[name]), flush=True)
        for k, (mx, mn) in plain.items():
            res[k] = (mx, mn)
            print(f"  {k}, every occupied column: max {mx:.3g}, mean {mn:.3g} of max|ref|",
                  flush=True)
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
