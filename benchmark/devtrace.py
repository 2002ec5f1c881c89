"""Reduction of a ``torch.profiler`` trace of the traced window: the device's
busy time, the time by device operation, and the idle gaps named by what
the host was doing (the harness's own ``record_function`` spans)."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW = "bench.window"


def _events(prof):
    """(device intervals [(start_us, end_us, name)], host spans of the
    harness [(start_us, end_us, name)]) of a finished profile.  The
    profiler also lays every ``record_function`` span on the device's
    timeline as an annotation; those are no device work."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.name.startswith("bench."):
            if e.device_type == DeviceType.CPU:
                host.append((start, end, e.name))
        elif e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            dev.append((start, end, e.name))
    return sorted(dev), sorted(host)


def reduce(prof) -> Dict[str, object]:
    """``window_s`` (the ``bench.window`` span), ``busy_s`` (the union of
    device intervals inside it), ``device_ops`` (seconds by name, largest
    first), ``idle_gaps`` (the longest gaps between device intervals, each
    named by the innermost harness span around its start) and
    ``kernel_s`` (seconds by name, for the readers)."""
    dev, host = _events(prof)
    windows = [(s, e) for s, e, n in host if n == WINDOW]
    if not windows or not dev:
        return {}
    w0, w1 = windows[0]
    busy, by_name, gaps = 0.0, defaultdict(float), []
    cur_end = w0
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        by_name[name] += (e - s) / 1e6
        if s > cur_end:
            gaps.append((cur_end, s))
        busy += max(0.0, e - max(s, cur_end))
        cur_end = max(cur_end, e)
    if w1 > cur_end:
        gaps.append((cur_end, w1))
    spans = [(s, e, n) for s, e, n in host if n != WINDOW]

    def doing(t):
        inner = [(e - s, n) for s, e, n in spans if s <= t < e]
        return min(inner)[1] if inner else "host, outside the harness's spans"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy / 1e6,
        "kernel_s": dict(by_name),
        "device_ops": top(by_name.items(), 10),
        "idle_gaps": [[doing(s), (e - s) / 1e6] for s, e in longest],
    }


def top(items, n: int) -> List[List[object]]:
    ranked: List[Tuple[str, float]] = sorted(items, key=lambda kv: -kv[1])[:n]
    return [[name[:160], secs] for name, secs in ranked]
