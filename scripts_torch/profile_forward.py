"""Device-time breakdown of the port's flagship forward, or of one train
step, on one GPU.

Usage:
    python scripts_torch/profile_forward.py [--n-infers 1] [--seed 0] [--out build/profile]
    python scripts_torch/profile_forward.py --train [--n-infers 1] [--seed 0] [--out build/profile]

One synthetic scan (drawn as ``chip_smoke.py`` draws them: ``--n-infers``
augmented views of one scene) goes through ``PaSCoConfig()`` at
``n_infers`` (1: PaSCo-single, 3: the MIMO ensemble) with seeded random
init, after two warm-ups.  Prints

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
``forward_trace.json`` into ``--out``.

With ``--train``: ``PaSCoConfig()`` at ``n_infers`` on the train box,
seeded random init, one synthetic scene with targets (as ``chip_smoke.py``
draws them: a distinct scan per subnet); after
two warm-up steps it prints

1. wall and device ms of one step without the profiler (median of 3) and
   the peak device memory;
2. device ms per phase of the step (CUDA events): forward + losses,
   backward, running statistics + optimizer update;
3. from a ``torch.profiler`` trace of one more step: kernel time by group
   as above, the conv kernel's launches split into forward and ``dx`` (the
   launch counters), the device time of the weight gradient's per-tap
   products (``aten::mm`` calls whose contraction runs over the volume's
   cells) and the top kernels.

and writes ``train_profile.json`` and ``train_trace.json``.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import dataclasses
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


def weight_grad_ms(prof, min_rows: int = 100000) -> dict:
    """Device ms and count of the ``aten::mm`` calls that contract over at
    least ``min_rows`` rows: the weight gradient's per-tap products."""
    ms, n = 0.0, 0
    for evt in prof.key_averages(group_by_input_shape=True):
        shapes = evt.input_shapes
        if evt.key != "aten::mm" or not shapes or len(shapes[0]) != 2:
            continue
        if shapes[0][1] >= min_rows:
            dev_us = getattr(evt, "device_time_total", None)
            if dev_us is None:
                dev_us = evt.cuda_time_total
            ms += dev_us / 1e3
            n += evt.count
    return {"ms": ms, "calls": n}


def train_profile(args) -> None:
    """The ``--train`` mode (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import train_scenes
    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch import kernels
    from pasco_torch.models.norm import commit_batch_stats
    from pasco_torch.models.unet import build_net, scene_to_model_input
    from pasco_torch.training import step as tstep
    from pasco_torch.training.loop import train_config
    from pasco_torch.data.semantic_kitti.params import CLASS_FREQUENCIES

    dev = torch.device("cuda", 0)
    base = PaSCoConfig()
    base = base.replace(model=dataclasses.replace(base.model, n_infers=args.n_infers))
    cfg = train_config(base)
    (col,) = train_scenes(base, 1, seed=args.seed)
    inp = scene_to_model_input(col, dev)
    tgt = tstep.targets_to_device(col.targets, dev)
    lw = {s: torch.as_tensor(v, device=dev)
          for s, v in tstep.labelweights_for(cfg, CLASS_FREQUENCIES).items()}
    cw = torch.as_tensor(tstep.class_weight_vector(
        cfg.model.n_classes, cfg.loss.no_object_weight), device=dev)
    net = build_net(cfg, dev)
    net.reset_parameters(torch.Generator().manual_seed(args.seed))
    state = tstep.create_train_state(net, cfg)

    def step():
        tstep.train_step(state, inp, tgt, lw, cw, cfg, args.seed)

    def phases() -> dict:
        """Device ms of the step's phases, as ``train_step`` runs them."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        net.train()
        for p in state.opt.params.values():
            p.grad = None
        gen = tstep.step_generator(args.seed, state.step, dev)
        ev[0].record()
        total, _ = tstep.compute_losses(net, inp, tgt, lw, cw, cfg, gen)
        ev[1].record()
        total.backward()
        ev[2].record()
        commit_batch_stats(net)
        state.opt.step({k: p.grad for k, p in state.opt.params.items()})
        state.step += 1
        ev[3].record()
        ev[3].synchronize()
        return {"forward + losses": ev[0].elapsed_time(ev[1]),
                "backward": ev[1].elapsed_time(ev[2]),
                "running stats + optimizer": ev[2].elapsed_time(ev[3])}

    res = {}
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    walls, devs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        devs.append(device_ms(step))
        walls.append(1e3 * (time.perf_counter() - t0))
    res["wall_ms"] = statistics.median(walls)
    res["device_ms"] = statistics.median(devs)
    res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    res["phases_ms"] = phases()
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step()
        torch.cuda.synchronize()
    res["launches"] = dict(kernels.LAUNCHES)
    res["weight_grad"] = weight_grad_ms(prof)
    trace = os.path.join(args.out, "train_trace.json")
    prof.export_chrome_trace(trace)
    res.update(kernel_table(trace))

    print(f"train step: wall {res['wall_ms']:.3f} ms, device {res['device_ms']:.3f} ms, "
          f"peak {res['peak_gb']:.3f} GB")
    print("device ms per phase (CUDA events):")
    for k, v in res["phases_ms"].items():
        print(f"  {k:28s} {v:9.3f}")
    print(f"profiled step: kernel time {res['kernel_ms']:.3f} ms over a device span of "
          f"{res['span_ms']:.3f} ms ({100 * res['kernel_ms'] / res['span_ms']:.1f}% busy); "
          f"launches {res['launches']}")
    for k, v in res["groups"].items():
        print(f"  {k:24s} {v['ms']:9.3f} ms  {100 * v['ms'] / res['kernel_ms']:5.1f}%  "
              f"{v['launches']} launches")
    print(f"  weight-gradient per-tap products (in GEMM): {res['weight_grad']['ms']:.3f} ms "
          f"in {res['weight_grad']['calls']} calls")
    print("top kernels:")
    for t in res["top"]:
        print(f"  {t['ms']:9.3f} ms  {t['launches']:4d}  {t['name']}")
    with open(os.path.join(args.out, "train_profile.json"), "w") as fh:
        json.dump(res, fh, indent=1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-infers", type=int, default=1, help="MIMO subnets (1 or 3)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    ap.add_argument("--train", action="store_true",
                    help="profile one train step instead of one forward")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward.py: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    if args.train:
        train_profile(args)
        return
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import make_scans
    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.models.unet import build_net

    dev = torch.device("cuda", 0)
    cfg = PaSCoConfig()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, n_infers=args.n_infers))
    (_, inp), = make_scans(cfg, 1, dev, seed=args.seed)
    net = build_net(cfg, dev)
    net.reset_parameters(torch.Generator().manual_seed(args.seed))

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
