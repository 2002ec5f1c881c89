"""The port's tracing: spans and counters where the work happens, kept in
memory and read once after the traced forwards; and the seed helper.

    from pasco_torch.utils import timing

    timing.tracing(True)
    ...                       # forwards: spans open and counters add up
    timing.tracing(False)
    rows = timing.drain()     # one synchronise, then every row

The program marks its work with ``with timing.span("encoder"):`` and
``timing.count("masked_conv3.tile_cells", n_active, 256)``; a counter whose
value takes work to compute asks :func:`enabled` first.  Callers switch
tracing with :func:`tracing` only.

Off (the default) :func:`span` returns one shared no-op context after a
single check of a module flag, and :func:`count` returns at once: no
``record_function``, no CUDA event, no allocation, no launch.

On, a span

* opens ``torch.profiler.record_function("pasco.<name>")``, so that under
  ``torch.profiler`` the program's spans lie on the clock of the profiler's
  device activity;
* reads ``time.perf_counter_ns()`` at both edges;
* where ``events`` is true and CUDA is initialised (the stage spans; not the
  kernel wrappers' spans), records a CUDA event at both edges on the
  current stream, from a pool that :func:`drain` refills;
* stores its ``id``, its ``parent`` and its ``forward``: the sequence
  number of its root span, so that every span of one scan shares it.  A
  root span also keeps its forward's delta of ``kernels.LAUNCHES``.

A counter adds ``value * scale`` to its name in the current forward.  A
value that is a tensor is kept by reference and read at :func:`drain`,
never while the forwards run, so that no counter waits for the card.

Spans nest on one stack: trace from one thread.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from pasco_torch import kernels

PREFIX = "pasco."


class _Off:
    """The span while tracing is off: one shared object that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, typ, val, tb):
        return False


_OFF = _Off()


class _Row:
    __slots__ = ("name", "id", "parent", "forward", "t0", "t1", "ev0", "ev1", "launches")

    def __init__(self, name, id_, parent, forward):
        self.name, self.id, self.parent, self.forward = name, id_, parent, forward
        self.t0 = self.t1 = 0
        self.ev0 = self.ev1 = self.launches = None


class _Recorder:
    """Rows, open spans, counters and the event pool of the traced
    forwards since the last :func:`drain`."""

    def __init__(self):
        self.rows: List[_Row] = []
        self.stack: List[_Row] = []
        self.forwards = 0
        self.counters: Dict[Optional[int], Dict[str, list]] = defaultdict(lambda: defaultdict(list))
        self.pool: List[torch.cuda.Event] = []

    def event(self) -> torch.cuda.Event:
        ev = self.pool.pop() if self.pool else torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev


_on = False
_rec = _Recorder()


class _Span:
    __slots__ = ("name", "events", "row", "rf")

    def __init__(self, name: str, events: bool):
        self.name, self.events = name, events

    def __enter__(self):
        rec = _rec
        parent = rec.stack[-1] if rec.stack else None
        if parent is None:
            forward = rec.forwards
            rec.forwards += 1
        else:
            forward = parent.forward
        row = self.row = _Row(PREFIX + self.name, len(rec.rows),
                              None if parent is None else parent.id, forward)
        rec.rows.append(row)
        rec.stack.append(row)
        self.rf = torch.profiler.record_function(row.name)
        self.rf.__enter__()
        if parent is None:
            row.launches = dict(kernels.LAUNCHES)
        if self.events and torch.cuda.is_initialized():
            row.ev0 = rec.event()
        row.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        row = self.row
        row.t1 = time.perf_counter_ns()
        if row.ev0 is not None:
            row.ev1 = _rec.event()
        if row.launches is not None:
            row.launches = {k: v - row.launches[k] for k, v in kernels.LAUNCHES.items()
                            if v != row.launches[k]}
        _rec.stack.pop()
        self.rf.__exit__(*exc)
        return False


def tracing(on: bool) -> None:
    """Switch the program's spans and counters on or off.  What was
    recorded stays until :func:`drain`."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    """Whether tracing is on: a caller that must compute a counter's value
    (a reduction on the card) does it only then."""
    return _on


def span(name: str, events: bool = True):
    """Context of one span ``pasco.<name>`` (see the module docstring);
    ``events=False`` for the kernel wrappers' spans, which take no CUDA
    event."""
    if not _on:
        return _OFF
    return _Span(name, events)


def count(name: str, value, scale: int = 1) -> None:
    """Add ``value * scale`` to counter ``name`` of the current forward
    (``None`` outside every span).  A tensor ``value`` of one element is
    read at :func:`drain`."""
    if not _on:
        return
    rec = _rec
    forward = rec.stack[0].forward if rec.stack else None
    rec.counters[forward][name].append((value, scale))


def drain() -> Dict[str, object]:
    """Every row and counter since the last drain, and a fresh start.
    Synchronises once where a row holds CUDA events, and reads the
    tensor counters in one copy.

    Returns ``{"rows": [...], "counters": {forward: {name: total}}}``; a
    row is ``name``, ``id``, ``parent``, ``forward``, ``host_ms``,
    ``self_ms`` (host ms not inside a child span), ``device_ms`` (between
    its events, or None) and, on a root row, ``launches`` (its forward's
    launches by ``kernels.LAUNCHES`` key)."""
    global _rec
    rec = _rec
    if rec.stack:
        raise RuntimeError(f"drain() inside the open span {rec.stack[-1].name}")
    if any(r.ev0 is not None for r in rec.rows):
        torch.cuda.synchronize()
    child_ns = defaultdict(int)
    for r in rec.rows:
        if r.parent is not None:
            child_ns[r.parent] += r.t1 - r.t0
    rows = []
    for r in rec.rows:
        row = dict(name=r.name, id=r.id, parent=r.parent, forward=r.forward,
                   host_ms=(r.t1 - r.t0) / 1e6, self_ms=(r.t1 - r.t0 - child_ns[r.id]) / 1e6,
                   device_ms=None if r.ev0 is None else r.ev0.elapsed_time(r.ev1))
        if r.parent is None:
            row["launches"] = r.launches
        rows.append(row)
    tensors = [v for per in rec.counters.values() for vals in per.values()
               for v, _ in vals if isinstance(v, torch.Tensor)]
    read = iter(torch.stack([t.detach().reshape(()).double() for t in tensors]).cpu().tolist()
                if tensors else ())
    counters = {}
    for forward, per in rec.counters.items():
        counters[forward] = {
            name: sum((next(read) if isinstance(v, torch.Tensor) else v) * s for v, s in vals)
            for name, vals in per.items()}
    _rec = _Recorder()
    _rec.pool = rec.pool + [e for r in rec.rows for e in (r.ev0, r.ev1) if e is not None]
    return {"rows": rows, "counters": counters}


def set_random_seed(seed: int) -> torch.Generator:
    """Seed NumPy and torch (reference ``torch_util.py:19-32``); returns a
    CPU generator seeded with ``seed`` for explicit draws."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
