"""Where the time of the ``stream_extract`` and ``featurizer`` kernels goes,
by ablation, on one GPU.

    python scripts_torch/extract_ablation.py [--out build/extract_ablation.json]

Times both kernels as built and three variants of each, built with
``-DEXTRACT_ABLATE=k -DFEATURIZER_ABLATE=k`` (``pasco_torch/csrc/
{stream_extract,featurizer}.cu``), each with one part removed; they
compute wrong results and exist only to be timed:

=====  ==========================  ==============================
k      ``stream_extract``           ``featurizer``
=====  ==========================  ==============================
1      no look-back (spread base)   no zero stores at empty cells
2      no payload gather            no 1x1 (the bias alone)
3      no tail zeroing              no feature reads
=====  ==========================  ==============================

Each variant runs in its own process (``pasco_torch.kernels.EXTRA_FLAGS_ENV``).
The cases are ``chip_smoke.py``'s: the extraction at dec_s1 (E = 20), at the
refiner's s1 (E = 64) and rows only (training), and the featurizer on the
first synthetic scan's points through a seeded net's point MLP.  For each:
``ms``, the time per call of ``chip_smoke.time_ms`` (back-to-back calls);
``device_ms``, the call's device time from the profiler, and
``kernel_ms``, its kernel's alone (median over calls); for the
as-built variant also ``host_ms``, the wrapper's host time per call
(host clock over 200 calls enqueued without a synchronisation, so the
device never holds the host back), and for the featurizer ``sort_ms``, the
device time of its index preparation (``sort_points``) alone.  Prints the
card and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

VARIANTS = ("as built", "1", "2", "3")
NAMES = {"stream_extract": ("as built", "no look-back", "no payload gather", "no tail"),
         "featurizer": ("as built", "no zero stores", "no 1x1", "no feature reads")}


def host_ms(fn, n=200):
    """Host time (ms) per call of ``fn`` enqueued back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return t


def cases():
    """(kernel, label, call, kernel-name pattern, index preparation or None)."""
    import chip_smoke as cs
    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.core.sparse import Box
    from pasco_torch.models.unet import build_net
    from pasco_torch.ops import extract
    from pasco_torch.ops import featurizer as fz

    dev = torch.device("cuda", 0)
    cfg = PaSCoConfig()
    inp = cs.make_scans(cfg, 1, dev)[0][1]
    gen = torch.Generator().manual_seed(0)
    randn, _, _ = cs._rand_fns(gen, dev)
    _, occ1, bbox1 = cs.scan_masks(cfg, inp)
    X, Z, Y = occ1.shape
    keep_ref = bbox1 & (torch.rand((X, Z, Y), generator=gen) < 0.7).to(dev)
    out = []
    for label, keep, pay, cap in (
            ("dec_s1", bbox1, randn(X, Z, Y, cfg.model.n_classes), cfg.capacity.dec_s1),
            ("refiner s1", keep_ref, randn(X, Z, Y, cfg.model.f), cfg.capacity.panop_s1),
            ("dec_s1 rows only", bbox1, None, cfg.capacity.dec_s1)):
        out.append(("stream_extract", label,
                    lambda k=keep, c=cap, p=pay: extract.stream_extract(k, c, p),
                    "extract_kernel", None))
    net = build_net(cfg, dev)
    net.reset_parameters(torch.Generator().manual_seed(0))
    box = Box.create(inp.global_min, cfg.scene.box_extent)
    ex, ey, ez = box.extent
    with torch.no_grad():
        f = net.point_mlp(inp.point_feats, inp.point_mask)
    rel = inp.point_coords[:, 1:] - box.minimum[None]
    in_box = inp.point_mask & (rel >= 0).all(-1) & (rel[:, 0] < ex) \
        & (rel[:, 1] < ey) & (rel[:, 2] < ez)
    w = net.enc_in.kernel[0].detach()
    b = torch.zeros((w.shape[1],), device=dev)
    args = (f, rel, in_box, w, b, box.extent, torch.bfloat16)
    out.append(("featurizer", "first scan", lambda: fz.featurizer_fused(*args),
                "featurizer_kernel", lambda: fz.sort_points(rel, in_box, box.extent)))
    return out


def time_variant(variant):
    from chip_smoke import device_ms, profile_call, time_ms

    res = {}
    for kernel, label, fn, pattern, prep in cases():
        calls = profile_call(fn)
        r = dict(ms=time_ms(fn, reps=7), device_ms=device_ms(calls),
                 kernel_ms=device_ms(calls, pattern))
        if variant == 0:
            r["host_ms"] = host_ms(fn)
            if prep is not None:
                r["sort_ms"] = device_ms(profile_call(prep))
        res[f"{kernel} {label}"] = r
    return res


def main():
    from pasco_torch import kernels

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "extract_ablation.json"))
    ap.add_argument("--variant", type=int, default=None,
                    help="time one variant in this process and print its JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("extract_ablation.py: no CUDA device")
    if args.variant is not None:
        print(json.dumps(time_variant(args.variant)))
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    times = {}
    for i, name in enumerate(VARIANTS):
        env = dict(os.environ)
        env[kernels.EXTRA_FLAGS_ENV] = (f"-DEXTRACT_ABLATE={i} -DFEATURIZER_ABLATE={i}"
                                        if i else "")
        res = subprocess.run([sys.executable, __file__, "--variant", str(i)], env=env,
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"variant {i}: exit {res.returncode}\n{res.stdout}{res.stderr}")
        times[i] = json.loads(res.stdout.strip().splitlines()[-1])
    for label in times[0]:
        kernel = label.split()[0]
        print(f"{label}: " + "; ".join(
            f"{NAMES[kernel][i]} {t[label]['ms']:.4f} ms (device {t[label]['device_ms']:.4f}, "
            f"kernel {t[label]['kernel_ms']:.4f})" for i, t in times.items())
            + "; " + ", ".join(f"{k} {v:.4f}" for k, v in times[0][label].items()
                               if k in ("host_ms", "sort_ms")), flush=True)
    res = dict(card=card, times={NAMES["stream_extract"][i] + " / " + NAMES["featurizer"][i]: t
                                 for i, t in times.items()})
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
