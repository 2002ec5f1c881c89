"""Device-time breakdown of the port's flagship forward on one GPU.

Usage:
    python scripts_torch/profile_forward.py [--seed 0] [--out build/profile]

One synthetic scan (drawn as ``chip_smoke.py`` draws them) goes through
``PaSCoConfig()`` at n_infers=1 with seeded random init, after two
warm-ups.  Prints

1. wall and device ms of one forward without the profiler (medians of 3;
   device time from CUDA events) and the peak device memory;
2. device ms per top-level module, from CUDA events recorded in forward
   hooks; ``(between modules)`` is the rest of the forward (featurizer
   scatter, masks, extraction);
3. from a ``torch.profiler`` trace of one more forward: the summed kernel
   time, the device span from the first kernel's start to the last one's
   end, kernel time by group (the four hand-written kernels, cuDNN
   convolutions, GEMMs, other torch kernels) and the top kernels.

Writes ``forward_profile.json`` (all of the above) and the Chrome trace
``forward_trace.json`` into ``--out``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OWN_KERNELS = {
    "masked_conv3": r"masked_conv3_kernel",
    "down2_fused": r"down2_kernel",
    "up_preamble": r"up_preamble_kernel",
    "stream_extract": r"\(anonymous namespace\)::(count|scan|rank|gather)_kernel\b",
}


def kernel_group(name: str) -> str:
    for group, pattern in OWN_KERNELS.items():
        if re.search(pattern, name):
            return group
    low = name.lower()
    if re.search(r"convolve|fprop|cudnn|conv[23]d", low):
        return "cuDNN convolution"
    if "gemm" in low:
        return "GEMM"
    return "other torch kernels"


def device_ms(fn) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def module_times(net, inp) -> dict:
    """Device ms per top-level module of one forward (CUDA events)."""
    marks = []
    hooks = []
    for name, mod in net.named_children():
        def pre(_m, _a, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev, None))

        def post(_m, _a, _o, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            i = max(j for j, m in enumerate(marks) if m[0] == name and m[2] is None)
            marks[i] = (name, marks[i][1], ev)

        hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    total = device_ms(lambda: net(inp))
    for h in hooks:
        h.remove()
    per = defaultdict(float)
    for name, a, b in marks:
        per[name] += a.elapsed_time(b)
    per["(between modules)"] = total - sum(per.values())
    return {"forward": total, **per}


def kernel_table(trace_path: str) -> dict:
    with open(trace_path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("cat") == "kernel"]
    if not events:
        raise RuntimeError("the profiler trace holds no device kernels")
    by_group = defaultdict(lambda: [0.0, 0])
    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        for table, key in ((by_group, kernel_group(e["name"])), (by_name, e["name"])):
            table[key][0] += e["dur"] / 1e3
            table[key][1] += 1
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "kernel_ms": sum(e["dur"] for e in events) / 1e3,
        "span_ms": (end - start) / 1e3,
        "groups": {k: {"ms": v[0], "launches": v[1]}
                   for k, v in sorted(by_group.items(), key=lambda kv: -kv[1][0])},
        "top": [{"name": k[:120], "ms": v[0], "launches": v[1]} for k, v in top],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward.py: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import make_scans
    from pasco_tpu.core.config import PaSCoConfig
    from pasco_torch.models.unet import build_net

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda", 0)
    cfg = PaSCoConfig()
    (_, inp), = make_scans(cfg, 1, dev, seed=args.seed)
    net = build_net(cfg)
    net.reset_parameters(torch.Generator().manual_seed(args.seed))
    net = net.to(dev)

    res = {}
    with torch.no_grad():
        for _ in range(2):
            net(inp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        walls, devs = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            devs.append(device_ms(lambda: net(inp)))
            walls.append(1e3 * (time.perf_counter() - t0))
        res["wall_ms"] = statistics.median(walls)
        res["device_ms"] = statistics.median(devs)
        res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        res["modules_ms"] = module_times(net, inp)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            net(inp)
            torch.cuda.synchronize()
    trace = os.path.join(args.out, "forward_trace.json")
    prof.export_chrome_trace(trace)
    res.update(kernel_table(trace))

    print(f"forward: wall {res['wall_ms']:.3f} ms, device {res['device_ms']:.3f} ms, "
          f"peak {res['peak_gb']:.3f} GB")
    print("device ms per module (CUDA events):")
    for k, v in res["modules_ms"].items():
        print(f"  {k:24s} {v:9.3f}")
    print(f"profiled forward: kernel time {res['kernel_ms']:.3f} ms over a device "
          f"span of {res['span_ms']:.3f} ms ({100 * res['kernel_ms'] / res['span_ms']:.1f}% busy)")
    for k, v in res["groups"].items():
        print(f"  {k:24s} {v['ms']:9.3f} ms  {100 * v['ms'] / res['kernel_ms']:5.1f}%  "
              f"{v['launches']} launches")
    print("top kernels:")
    for t in res["top"]:
        print(f"  {t['ms']:9.3f} ms  {t['launches']:4d}  {t['name']}")
    with open(os.path.join(args.out, "forward_profile.json"), "w") as fh:
        json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
