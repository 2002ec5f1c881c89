"""Traffic of kind ``eval_scans``: evaluation over a driving log, a closed
loop with one scan in flight, as the evaluation script runs.

Set-up makes the pool of distinct scans from the seed, the program's
network with the benchmark's weights, and warms every scan's box.  The
window then cycles through the pool: each scan goes through the program's
``AdaptiveForward`` at the box the host scene gives, its outputs that the
host stages read are copied to the host, and it is done when they are
there.  One completion of every pool scan, drawn from the seed and after
the traced passes, is judged: once its outputs are on the host, its
attention masks follow them, for the reference to follow.  After the
window those completions are held against the plain reference.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import devtrace, program, scans, weights
from benchmark.reference.compare import compare_scan, over_scans
from benchmark.reference.model import Reference

TRACED_PASSES = 2   # passes over the pool that the profiler records with --trace 1
JUDGED_PASSES = 3   # the judged completion of a scan lies in one of the passes after those


def p95(samples: List[float]) -> float:
    """The 95th percentile of all samples (linear between order
    statistics, numpy's default)."""
    return float(np.percentile(np.asarray(samples, np.float64), 95))


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


class HostBuffers:
    """Pinned host buffers for the outputs of each pool scan, two sets a
    scan (the completion that is judged, and every other), allocated at
    the first copy, so that no copy in the window allocates."""

    def __init__(self):
        self.sets = {}

    def copy(self, outs: Dict[str, torch.Tensor], key) -> Dict[str, torch.Tensor]:
        """``outs`` copied into set ``key`` without waiting (the caller
        synchronises the stream)."""
        if key not in self.sets:
            self.sets[key] = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=v.is_cuda)
                              for k, v in outs.items()}
        bufs = self.sets[key]
        for k, v in outs.items():
            bufs[k].copy_(v, non_blocking=True)
        return bufs


def one_scan(fwd, inp, box, bufs: HostBuffers, key, judged=False):
    """One scan through the program: (host copy, host seconds of the
    enqueue, host seconds to outputs on the host).  A judged scan's host
    copy also gets its attention masks, copied once the outputs are there."""
    t0 = time.perf_counter()
    with torch.no_grad(), torch.profiler.record_function("bench.forward"):
        out = fwd(inp, box)
    t1 = time.perf_counter()
    with torch.profiler.record_function("bench.copy_out"):
        host = bufs.copy(program.host_outputs(out), key)
        sync(inp.point_feats.device)
    t2 = time.perf_counter()
    if judged:
        with torch.no_grad(), torch.profiler.record_function("bench.copy_judged"):
            host = dict(host, **bufs.copy(program.attention_masks(out), (key, "attn")))
            sync(inp.point_feats.device)
    return host, t1 - t0, t2 - t0


class ModuleTimer:
    """CUDA events in forward pre/post hooks of one module of the
    network: device milliseconds per call."""

    def __init__(self, module):
        self.pairs = []
        self.hooks = [module.register_forward_pre_hook(self._pre),
                      module.register_forward_hook(self._post)]

    def _pre(self, *_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.pairs.append([ev, None])

    def _post(self, *_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.pairs[-1][1] = ev

    def close(self) -> List[float]:
        for h in self.hooks:
            h.remove()
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs if b is not None]


def run(ctx: Dict) -> Dict:
    cfg, traffic, seed, dev = ctx["config"], ctx["traffic"], ctx["seed"], ctx["device"]
    phases = {"start": time.perf_counter() - ctx["t0"]}
    pool = scans.make_pool(traffic, cfg, seed, traffic["workers"])
    phases["pool"] = time.perf_counter() - ctx["t0"]
    shapes = program.parameter_shapes(cfg)
    fwd = program.build_forward(cfg, weights.make_weights(shapes, seed, dev), dev)
    gc.collect()
    phases["net"] = time.perf_counter() - ctx["t0"]
    inps = [program.model_input(s, dev) for s in pool]
    boxes = [program.pick_box(fwd, s) for s in pool]
    n = len(pool)
    bufs = HostBuffers()
    for j in range(n):                      # warm every box and every host buffer
        for kept in (True, False):
            one_scan(fwd, inps[j], boxes[j], bufs, (j, kept), judged=kept)
    cuda = torch.device(dev).type == "cuda"
    setup_s = time.perf_counter() - ctx["t0"]

    rng = scans.seeded_rng(seed, 1 << 20)
    # which pass of each scan is judged
    pick = [TRACED_PASSES + int(rng.randint(0, JUDGED_PASSES)) for _ in range(n)]
    checked: Dict[int, dict] = {}
    latency, enqueue, traced = [], [], {}
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    prof = timers = None
    if ctx["trace"]:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        timers = {k: ModuleTimer(getattr(fwd.net, k)) for k in ("transformer", "bottleneck")}
        window_span = torch.profiler.record_function("bench.window")
        window_span.__enter__()
    i = 0
    start = time.perf_counter()
    while True:
        j = i % n
        kept = i // n == pick[j]
        host, t_enq, t_done = one_scan(fwd, inps[j], boxes[j], bufs, (j, kept), judged=kept)
        latency.append(t_done)
        enqueue.append(t_enq)
        if kept:
            checked[j] = host
        i += 1
        if prof is not None and i == TRACED_PASSES * n:
            window_span.__exit__(None, None, None)
            traced = {k: t.close() for k, t in timers.items()}
            traced["scans"] = [k % n for k in range(i)]
            prof.__exit__(None, None, None)
            traced["trace"] = devtrace.reduce(prof)
            prof = None
        if time.perf_counter() - start >= ctx["seconds"] and prof is None \
                and len(checked) == n:
            break
    window_s = time.perf_counter() - start
    if ctx["trace"]:
        # the profiler slows the host, so the enqueue is read after it
        traced["enqueue"] = enqueue[TRACED_PASSES * n:]
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    ctx["close_window"]()

    fill = kept_of_cap(checked.values())
    del fwd, inps, host
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings, counts = check(cfg, seed, shapes, pool, checked, dev)
    return dict(
        attempted=i, failed=0,
        end_to_end=dict(scans_per_s=i / window_s, scan_p95_ms=1e3 * p95(latency),
                        peak_mem_gb=peak / 1e9, setup_s=setup_s),
        readings=readings,
        trace=dict(traced, pool_calls=counts) if ctx["trace"] else None,
        memory_peak_bytes=peak,
        info=dict(window_s=window_s, scans=i, boxes=[list(b) for b in boxes], setup_at=phases,
                  kept_of_cap=fill,
                  scan_median_ms=1e3 * statistics.median(latency)),
    )


def kept_of_cap(hosts) -> Dict[str, List[int]]:
    """For every extraction (``sem<s>.mask``, ``panop<s>.mask``): the most
    cells that one scan (and subnet) of ``hosts`` kept, and the capacity."""
    hosts = list(hosts)
    out = {}
    for k, m in hosts[0].items():
        if k.endswith(".mask"):
            most = max(int(h[k].reshape(-1, m.shape[-1]).sum(-1).max()) for h in hosts)
            out[k] = [most, m.shape[-1]]
    return out


def check(cfg, seed, shapes, pool, checked, dev):
    """The plain reference on every judged scan (float32, TF32 off),
    against the program's host copy: (the run's reading of every number,
    the reference's recorded products per pool scan)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = weights.make_weights(shapes, seed, dev)
    ref = Reference(cfg, w)
    readings, counts = [], {}
    with torch.no_grad():
        for j, scan in enumerate(pool):
            if j not in checked:
                continue
            readings.append(compare_scan(checked[j], ref, scan, cfg["model"]["n_infers"], dev))
            counts[j] = list(ref.calls)
    return over_scans(readings), counts


def trace_fields(trace) -> Dict:
    """``busy_s``/``window_s`` and the breakdown of the traced window."""
    t = trace["trace"]
    return dict(busy_s=t["busy_s"], window_s=t["window_s"]), dict(
        device_ops=t["device_ops"], idle_gaps=t["idle_gaps"])
