"""Device-time breakdown of the port's flagship forward, or of one train
step, on one GPU.

Usage:
    python scripts_torch/profile_forward.py [--n-infers 1] [--seed 0] [--scan 0] [--box 352]
        [--iters 3] [--top 40] [--out build/profile] [--substrate sparse]
    python scripts_torch/profile_forward.py --train [--n-infers 1] [--seed 0] [--out build/profile]
    python scripts_torch/profile_forward.py [--train] --report-only [--iters 3] [--top 40]
        [--out build/profile]
    python scripts_torch/profile_forward.py --waffleiron [--train] [--iters 3] [--top 40]

One synthetic scan (drawn as ``chip_smoke.py`` and ``bench.py`` draw them:
``--n-infers`` augmented views of one scene; ``--scan k`` takes the k-th of
the seed's draws) goes through ``PaSCoConfig()`` at ``n_infers`` (1:
PaSCo-single, 3: the MIMO ensemble) with seeded random init, after two
warm-ups, at the working box ``--box SIDE`` (``SIDE x SIDE x 32``; by
default the configured 352 box).  Prints

1. wall and device ms of one forward without the profiler (medians of 3;
   device time from CUDA events) and the peak device memory;
2. device ms per top-level module, from CUDA events recorded in forward
   hooks; ``(between modules)`` is the rest of the forward (featurizer
   scatter, masks, extraction);
3. from a ``torch.profiler`` trace of ``--iters`` more forwards (default
   3): per forward, the summed kernel time, the device span from the first
   kernel's start to the last one's end, kernel time by group (the four
   hand-written kernels, cuDNN convolutions, GEMMs, other torch kernels)
   and the ``--top`` kernels (default 40);
   the program's tracing (``pasco_torch/utils/timing.py``) is on for
   these forwards, which run through ``AdaptiveForward``, so the trace
   holds the ``pasco.*`` stage and kernel spans, and the table of spans
   gives, per forward, ``pasco.dispatch``, each stage and ``(dispatch)``
   (the dispatch outside its stages): host ms (the recorder's, under the
   profiler), ``driver_ms`` (in CUDA runtime calls inside the span), own
   host ms (host less ``driver_ms``), launches and syncs (runtime calls that enqueue
   device work, and that wait for it), starved ms (device idle time that
   began inside the span) and device ms (the span's CUDA events); then the
   program's counters per forward;

4. per decoder scale, the kept cells (``top_class != 0`` for some subnet,
   before the cap) against the stage's valid cells, and the extracted
   (capped) count.

``--substrate sparse`` profiles the sparse substrate's ``PaSCoNet``
instead (the same scan and box): step 2 then also times the decoder's
blocks and refiners one by one, and step 4 prints the kept (capped)
cells per scale.

``BENCH_TRAINED_CKPT=<npz>`` loads trained weights (the file of
``scripts_torch/make_bench_ckpt.py``, n_infers 1) in place of the random
init.  Writes ``forward_profile.json`` (all of the above) and the Chrome
trace ``forward_trace.json`` into ``--out``.

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

``--waffleiron`` profiles PaSCo's point-feature frontend instead: the
full-width ``Segmenter()`` in eval mode on ``chip_smoke.waffle_scan``'s
120000-point scan (wall and device ms of one forward, medians of 3 after
two warm-ups, the peak, then the kernel leaderboard of ``--iters``
forwards), or with ``--train`` one ``waffleiron_train_step`` at the
trainer's defaults (two synthetic scans of ``train_waffleiron.py``,
padded to 20000 points; after two warm-up steps, the same numbers of one
step and its leaderboard); it writes ``waffleiron_{forward,train}_
profile.json`` and ``..._trace.json``.

``--report-only`` takes no measurement: it reads the Chrome trace saved in
``--out`` (``forward_trace.json``, with ``--train`` ``train_trace.json``;
with ``--waffleiron`` the ``waffleiron_`` ones)
and prints the same leaderboard over its ``--iters`` iterations, on any
machine (as the reference's ``--report-only`` re-reads its xplane trace).
A trace with no device kernels (one taken on the CPU) gives the host ops'
inclusive time instead, labelled so.
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
    "stream_extract": r"extract_kernel",
}


def kernel_group(name: str) -> str:
    for group, pattern in OWN_KERNELS.items():
        if re.search(pattern, name):
            return group
    low = name.lower()
    if re.search(r"convolve|fprop|cudnn|conv[23]d|depthwise", low):
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


def module_times(net, forward, inner=()) -> dict:
    """Device ms per top-level module of one ``forward()`` of ``net`` (CUDA
    events), and per child of each top-level module named in ``inner``."""
    marks = []
    hooks = []
    top = list(net.named_children())
    children = [(f"{n}.{c}", m) for n in inner for c, m in getattr(net, n).named_children()]
    for name, mod in top + children:
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
    total = device_ms(forward)
    for h in hooks:
        h.remove()
    per = defaultdict(float)
    for name, a, b in marks:
        per[name] += a.elapsed_time(b)
    per["(between modules)"] = total - sum(per[n] for n, _ in top)
    return {"forward": total, **per}


def kept_cells(net, forward) -> dict:
    """Per decoder scale of one ``forward()``: the valid cells, the kept
    ones (some subnet's argmax is not "empty") and the extracted count."""
    seen = {}
    hooks = [getattr(net, f"dec_s{sc}").register_forward_hook(
        lambda _m, _a, o, sc=sc: seen.__setitem__(sc, (o[2], o[4])))
        for sc in (4, 2, 1)]
    try:
        out = forward()
    finally:
        for h in hooks:
            h.remove()
    res = {}
    for sc, (top, msk) in seen.items():
        valid, kept = int(msk.sum()), int(((top != 0).any(-1) & msk).sum())
        res[f"s{sc}"] = {"valid": valid, "kept": kept, "fraction": kept / max(valid, 1),
                         "extracted": int(out.sem_grids[sc].mask.sum())}
    return res


def kernel_table(trace_path: str, top: int = 40, iters: int = 1,
                 category: str = "kernel") -> dict:
    """The trace's events of ``category`` (device kernels by default) per
    iteration of the ``iters`` it holds: summed time, span, groups (kernels
    only) and the ``top`` names by time, with their launches."""
    with open(trace_path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("cat") == category and "dur" in e]
    if not events:
        raise RuntimeError(f"the profiler trace holds no {category} events")
    by_group = defaultdict(lambda: [0.0, 0])
    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        tables = [(by_name, e["name"])]
        if category == "kernel":
            tables.append((by_group, kernel_group(e["name"])))
        for table, key in tables:
            table[key][0] += e["dur"] / 1e3 / iters
            table[key][1] += 1
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "iters": iters,
        "kernel_ms": sum(e["dur"] for e in events) / 1e3 / iters,
        "span_ms": (end - start) / 1e3 / iters,
        "groups": {k: {"ms": v[0], "launches": v[1] / iters}
                   for k, v in sorted(by_group.items(), key=lambda kv: -kv[1][0])},
        "top": [{"name": k[:120], "ms": v[0], "launches": v[1] / iters} for k, v in ranked],
    }


# CUDA runtime API calls (``cuda*``, ``cu*``) on the host timeline of a profile
RUNTIME = re.compile(r"cu(da)?[A-Z]")
SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize"}


def is_launch(name: str) -> bool:
    """A runtime call that enqueues device work: a kernel launch, an async
    copy or memset (not ``cudaEventRecord``)."""
    return name.startswith(("cudaLaunch", "cuLaunch")) or name in (
        "cudaMemcpyAsync", "cudaMemsetAsync")


def profile_events(prof):
    """(host events ``[(start_us, end_us, name)]``: the program's
    ``pasco.*`` spans and the CUDA runtime calls; device intervals
    ``[(start_us, end_us)]``: device work, without the spans' device-side
    annotations) of a finished ``torch.profiler`` profile."""
    from torch.autograd import DeviceType

    from pasco_torch.utils.timing import PREFIX

    host, dev = [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith(PREFIX)):
                dev.append((s, t))
        elif e.name.startswith(PREFIX) or RUNTIME.match(e.name):
            host.append((s, t, e.name))
    return sorted(host), sorted(dev)


def idle_gaps(device):
    """Gaps ``[(start_us, end_us)]`` between the union of device intervals."""
    gaps, end = [], None
    for s, e in sorted(device):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def dispatch_split(host, device) -> list:
    """Each ``pasco.dispatch`` span of a profile (``profile_events``'s
    lists) reduced to ``launches`` and ``syncs`` (runtime calls inside it,
    as :func:`is_launch` and ``SYNCS`` class them),
    ``driver_ms`` (the summed time of every runtime call inside it),
    ``starved_ms`` (device idle time whose gap begins inside it, so while
    the host is in the program) and the same numbers by ``stages``: the
    dispatch's outermost child spans, calls outside them under
    ``(dispatch)``."""
    from pasco_torch.utils.timing import PREFIX

    spans = [h for h in host if h[2].startswith(PREFIX)]
    calls = [h for h in host if not h[2].startswith(PREFIX)]
    gaps = idle_gaps(device)
    out = []
    for d0, d1, name in spans:
        if name != PREFIX + "dispatch":
            continue
        stages = []   # outermost first where two spans start together
        for s, e, n in sorted(spans, key=lambda h: (h[0], -h[1])):
            if d0 <= s and e <= d1 and (s, e, n) != (d0, d1, name) \
                    and not (stages and s < stages[-1][1]):
                stages.append((s, e, n))

        def stage_of(t):
            for s, e, n in stages:
                if s <= t < e:
                    return n
            return "(dispatch)"

        res = dict(launches=0, syncs=0, driver_ms=0.0, starved_ms=0.0, stages={})

        def add(t, **kv):
            st = res["stages"].setdefault(stage_of(t), dict(
                launches=0, syncs=0, driver_ms=0.0, starved_ms=0.0))
            for k, v in kv.items():
                res[k] += v
                st[k] += v

        for s, e, n in calls:
            if d0 <= s < d1:
                add(s, launches=int(is_launch(n)), syncs=int(n in SYNCS),
                    driver_ms=(e - s) / 1e3)
        for g0, g1 in gaps:
            if d0 <= g0 < d1:
                add(g0, starved_ms=(g1 - g0) / 1e3)
        out.append(res)
    return out


def span_table(drained: dict, split: list) -> dict:
    """Per span name, the mean over the profiled forwards: host ms and
    device ms from the program's recorder (``timing.drain()``), and
    ``driver_ms``, launches, syncs and starved ms from
    :func:`dispatch_split` (the dispatch and its stages); own host ms is
    host ms less ``driver_ms``."""
    n = max(1, len(split))
    table = defaultdict(lambda: defaultdict(float))
    for r in drained["rows"]:
        if r["name"].startswith("pasco.kernel."):
            continue
        t = table[r["name"]]
        t["host_ms"] += r["host_ms"] / n
        if r["parent"] is None:
            table["(dispatch)"]["host_ms"] += r["self_ms"] / n
        if r["device_ms"] is not None:
            t["device_ms"] += r["device_ms"] / n
    for d in split:
        for name, vals in [("pasco.dispatch", d), *d["stages"].items()]:
            for k in ("driver_ms", "launches", "syncs", "starved_ms"):
                table[name][k] += vals[k] / n
    for t in table.values():
        t["own_ms"] = t["host_ms"] - t["driver_ms"]
    return {k: dict(v) for k, v in table.items()}


def print_spans(table: dict, n: int) -> None:
    cols = ("host_ms", "driver_ms", "own_ms", "launches", "syncs", "starved_ms", "device_ms")
    print(f"program spans, mean of {n} profiled forwards (host times under the profiler):")
    print(f"  {'span':22s}" + "".join(f"{c:>12s}" for c in cols))
    for name, t in table.items():
        print(f"  {name:22s}" + "".join(f"{t.get(c, 0.0):12.3f}" for c in cols))


def print_kernels(res: dict, what: str = "profiled forward") -> None:
    """The leaderboard of :func:`kernel_table`: per iteration."""
    print(f"{what} (per iteration of {res['iters']}): kernel time {res['kernel_ms']:.3f} ms "
          f"over a device span of {res['span_ms']:.3f} ms "
          f"({100 * res['kernel_ms'] / res['span_ms']:.1f}% busy)")
    for k, v in res["groups"].items():
        print(f"  {k:24s} {v['ms']:9.3f} ms  {100 * v['ms'] / res['kernel_ms']:5.1f}%  "
              f"{v['launches']:g} launches")
    print("top kernels:")
    for t in res["top"]:
        print(f"  {t['ms']:9.3f} ms  {t['launches']:6g}  {t['name']}")


def report(trace: str, top: int, iters: int) -> None:
    """``--report-only``: the leaderboard of a saved trace."""
    with open(trace) as fh:
        has_kernels = any(e.get("cat") == "kernel" for e in json.load(fh)["traceEvents"])
    if has_kernels:
        print_kernels(kernel_table(trace, top, iters), f"trace {trace}")
        return
    res = kernel_table(trace, top, iters, category="cpu_op")
    print(f"trace {trace} holds no device kernels: host ops, inclusive time per "
          f"iteration of {iters}")
    for t in res["top"]:
        print(f"  {t['ms']:9.3f} ms  {t['launches']:6g}  {t['name']}")


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

    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch import kernels
    from pasco_torch.models.norm import commit_batch_stats
    from pasco_torch.models.unet import build_net, scene_to_model_input
    from pasco_torch.training import step as tstep
    from pasco_torch.training.loop import synthetic_train_scenes, train_config
    from pasco_torch.data.semantic_kitti.params import CLASS_FREQUENCIES

    dev = torch.device("cuda", 0)
    base = PaSCoConfig()
    base = base.replace(model=dataclasses.replace(base.model, n_infers=args.n_infers))
    cfg = train_config(base)
    (col,) = synthetic_train_scenes(base, 1, seed=args.seed)
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
    res.update(kernel_table(trace, args.top, 1))

    print(f"train step: wall {res['wall_ms']:.3f} ms, device {res['device_ms']:.3f} ms, "
          f"peak {res['peak_gb']:.3f} GB")
    print("device ms per phase (CUDA events):")
    for k, v in res["phases_ms"].items():
        print(f"  {k:28s} {v:9.3f}")
    print(f"profiled step: launches {res['launches']}")
    print(f"  weight-gradient per-tap products (in GEMM): {res['weight_grad']['ms']:.3f} ms "
          f"in {res['weight_grad']['calls']} calls")
    print_kernels(res, "profiled step")
    with open(os.path.join(args.out, "train_profile.json"), "w") as fh:
        json.dump(res, fh, indent=1)


def waffleiron_profile(args) -> None:
    """The ``--waffleiron`` mode (see the module docstring)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import WAFFLE_POINTS, waffle_args, waffle_scan
    from pasco_torch.models.waffleiron import Segmenter
    from pasco_torch.training import waffleiron_train as wt
    from scripts_torch.train_waffleiron import synthetic_cloud

    dev = torch.device("cuda", 0)
    net = Segmenter()
    net.reset_parameters(torch.Generator().manual_seed(args.seed))
    net = net.to(dev)
    if args.train:
        rng = np.random.RandomState(args.seed)
        clouds, labels = zip(*[synthetic_cloud(rng) for _ in range(2)])
        batch = wt.build_point_batch(list(clouds), list(labels), 20000, device=dev)
        tx = wt.make_waffleiron_optimizer()
        state = [wt.create_waffle_state(net, tx)]

        def run():
            state[0], logs = wt.waffleiron_train_step(state[0], batch, net=net, tx=tx)
            return logs

        name, iters, what = "waffleiron_train", 1, "train step at 2 x 20000 points"
        grad = torch.enable_grad
    else:
        args_ = waffle_args(waffle_scan(WAFFLE_POINTS, args.seed), dev)
        net.eval()

        def run():
            return net(*args_)

        name, iters, what = "waffleiron_forward", args.iters, f"forward at {WAFFLE_POINTS} points"
        grad = torch.no_grad
    res = {"what": what}
    with grad():
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        walls, devs = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            devs.append(device_ms(run))
            walls.append(1e3 * (time.perf_counter() - t0))
        res.update(wall_ms=statistics.median(walls), device_ms=statistics.median(devs),
                   peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                run()
            torch.cuda.synchronize()
    trace = os.path.join(args.out, f"{name}_trace.json")
    prof.export_chrome_trace(trace)
    res.update(kernel_table(trace, args.top, iters))
    print(f"WaffleIron {what} on {torch.cuda.get_device_name(dev)}: wall "
          f"{res['wall_ms']:.3f} ms, device {res['device_ms']:.3f} ms (medians of "
          f"3), peak {res['peak_gb']:.3f} GB")
    print_kernels(res, f"profiled WaffleIron {what}")
    with open(os.path.join(args.out, f"{name}_profile.json"), "w") as fh:
        json.dump(res, fh, indent=1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-infers", type=int, default=1, help="MIMO subnets (1 or 3)")
    ap.add_argument("--scan", type=int, default=0, help="which of the seed's scans")
    ap.add_argument("--box", type=int, default=0,
                    help="working box side (256/288/320/352); 0: the configured box")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    ap.add_argument("--train", action="store_true",
                    help="profile one train step instead of one forward")
    ap.add_argument("--iters", type=int, default=3,
                    help="forwards in the profiler trace (the leaderboard is per forward)")
    ap.add_argument("--top", type=int, default=40, help="kernels in the leaderboard")
    ap.add_argument("--substrate", default="dense", choices=("dense", "sparse"),
                    help="the network of cfg.model.substrate (forward only)")
    ap.add_argument("--waffleiron", action="store_true",
                    help="profile the WaffleIron Segmenter (forward, or a train step)")
    ap.add_argument("--report-only", action="store_true",
                    help="print the leaderboard of the trace saved in --out; no measurement")
    args = ap.parse_args()
    if args.report_only:
        prefix = "waffleiron_" if args.waffleiron else ""
        report(os.path.join(args.out, f"{prefix}train_trace.json" if args.train else
                            f"{prefix}forward_trace.json"), args.top,
               1 if args.train else args.iters)
        return
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward.py: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    if args.waffleiron:
        waffleiron_profile(args)
        return
    if args.train:
        train_profile(args)
        return
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import make_scans
    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.inference.dispatch import AdaptiveForward
    from pasco_torch.models.unet import build_net
    from pasco_torch.utils import timing

    dev = torch.device("cuda", 0)
    cfg = PaSCoConfig()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, n_infers=args.n_infers,
                                                substrate=args.substrate))
    sparse = args.substrate != "dense"
    _, inp = make_scans(cfg, args.scan + 1, dev, seed=args.seed)[args.scan]
    box = (args.box, args.box, cfg.scene.box_extent[2]) if args.box else cfg.scene.box_extent
    net = build_net(cfg, dev)
    net.reset_parameters(torch.Generator().manual_seed(args.seed))
    trained = os.environ.get("BENCH_TRAINED_CKPT", "")
    if trained:
        import numpy as np

        from pasco_torch.convert import flax_to_torch

        data = np.load(trained)
        net.load_state_dict(flax_to_torch({k: data[k] for k in data.files}), strict=True)

    fwd = AdaptiveForward(net)

    def forward():
        return fwd(inp, box)

    def eager():   # module hooks run in an eager forward, not in a replayed graph
        return net(inp, box_extent=box)

    res = {"box": list(box), "weights": trained or "seeded random init"}
    with torch.no_grad():
        for _ in range(2):
            forward()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        walls, devs = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            devs.append(device_ms(forward))
            walls.append(1e3 * (time.perf_counter() - t0))
        res["wall_ms"] = statistics.median(walls)
        res["device_ms"] = statistics.median(devs)
        res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        res["modules_ms"] = module_times(net, eager, ("decoder",) if sparse else ())
        if sparse:
            out = forward()
            res["kept"] = {f"s{sc}": int(out.sem_grids[sc].mask.sum()) for sc in (4, 2, 1)}
        else:
            res["kept"] = kept_cells(net, eager)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            timing.tracing(True)
            for _ in range(args.iters):
                forward()
            timing.tracing(False)
            torch.cuda.synchronize()
    trace = os.path.join(args.out, "forward_trace.json")
    prof.export_chrome_trace(trace)
    res.update(kernel_table(trace, args.top, args.iters))
    drained = timing.drain()
    res["spans"] = span_table(drained, dispatch_split(*profile_events(prof)))
    res["counters"] = drained["counters"]

    print(f"forward at box {tuple(box)}: wall {res['wall_ms']:.3f} ms, device "
          f"{res['device_ms']:.3f} ms, peak {res['peak_gb']:.3f} GB")
    print("device ms per module (CUDA events):")
    for k, v in res["modules_ms"].items():
        print(f"  {k:24s} {v:9.3f}")
    print_kernels(res)
    print_spans(res["spans"], args.iters)
    print(f"program counters per forward: {res['counters']}")
    print(f"kept cells per decoder scale ({res['weights']}):")
    for k, v in res["kept"].items():
        if sparse:
            print(f"  {k}: {v} kept (capped)")
        else:
            print(f"  {k}: {v['kept']} of {v['valid']} valid ({100 * v['fraction']:.2f}%), "
                  f"{v['extracted']} extracted")
    with open(os.path.join(args.out, "forward_profile.json"), "w") as fh:
        json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
