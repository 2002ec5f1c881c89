"""Scene-adaptive working-box dispatch (counterpart of
``pasco_tpu/inference/dispatch.py``).

The dense-with-masks substrate computes over an axis-aligned box, so its
work scales with the box volume, while a scan's bbox varies with the
augmentation draw (an unaugmented SemanticKITTI scene spans 256x256x32, a
30-degree rotation up to ~350x350x32).  :class:`AdaptiveForward` runs each
scan at the smallest of ``SceneConfig.box_candidates`` that covers its
bbox, through ONE network: the box extent is an argument of
:meth:`DensePaSCoNet.forward`, so there is one parameter set on the card
and nothing is built per box.

The output does not depend on the box that covers the scan: convs and BN
are per channel, the bbox masks read the runtime ``global_min/max``, the
transformer's positional encoding comes from the cell coordinates, and the
extractions keep the flat-index order of ``[X, Z, Y]``, which for a shared
box minimum is the same order in every box that covers the scan.

The sparse substrate (``models/unet.py:PaSCoNet``, one scan per call) takes
the same call: its cell tables and its dense bottleneck span the box.

On the card the dense network's inference forward is replayed from a CUDA
graph, one per key (the box and every input tensor's shape, dtype and
device), in place of the ~1800 launches that Python would otherwise
enqueue a scan.  Every shape of that forward follows from the box
and the capacities, and it makes the host wait for the card nowhere, so a
captured forward runs the same kernels in the same order on the same
dtypes: its outputs are bit for bit the eager forward's.  Training, a
gradient, the CPU, the program's tracing on, and the sparse substrate (its
pace is the card's) run eagerly.  :data:`GRAPHS` counts both paths.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pasco_torch import kernels
from pasco_torch.core.config import PaSCoConfig
from pasco_torch.utils import timing

Extent = Tuple[int, int, int]

# Forwards by path: graphs captured, graphs replayed, eager forwards
# (``kernels.reset_launches`` zeroes it with ``kernels.LAUNCHES``).  A
# replay runs no wrapper, so it adds nothing to ``kernels.LAUNCHES``: the
# capture counted its forward's launches there once.
GRAPHS = kernels.counters("captures", "replays", "eager")


def candidate_boxes(cfg: PaSCoConfig) -> Tuple[Extent, ...]:
    """The candidate boxes, smallest volume first; the configured box
    alone where no candidates are set."""
    cands = cfg.scene.box_candidates
    if not cands:
        return (tuple(cfg.scene.box_extent),)
    return tuple(sorted(set(tuple(c) for c in cands), key=np.prod))


def pick_box(cands: Tuple[Extent, ...], global_min, global_max) -> Extent:
    """Smallest candidate covering ``[global_min, global_max]``; the largest
    where none does (its out-of-box cells are masked off, as with a fixed
    box)."""
    ext = np.asarray(global_max) - np.asarray(global_min) + 1
    for cand in cands:
        if np.all(ext <= np.asarray(cand)):
            return cand
    return cands[-1]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def graph_key(inp, box: Extent) -> tuple:
    """What a captured forward is fixed to: the box, and every input
    tensor's shape, dtype and device."""
    return tuple(box), tuple((tuple(t.shape), t.dtype, t.device) for t in inp)


def _map(obj, fn, leaf):
    """``obj`` (a forward's output: named tuples, dataclasses, dicts, lists
    and tuples) with each ``leaf``-typed value ``v`` replaced by
    ``fn(v)``."""
    if isinstance(obj, leaf):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map(v, fn, leaf) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map(v, fn, leaf) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(v, fn, leaf) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _map(getattr(obj, f.name), fn, leaf)
                                           for f in dataclasses.fields(obj)})
    return obj


class _Region:
    """Device bytes at a fixed address, seen through the CUDA array
    interface."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {"shape": (nbytes,), "typestr": "|u1",
                                         "data": (ptr, False), "version": 2}


def _unowned(t: torch.Tensor) -> torch.Tensor:
    """A tensor over the bytes of the contiguous ``t`` that owns nothing:
    when ``t`` is freed, its memory goes back to the allocator and the view
    still reads it."""
    raw = torch.as_tensor(_Region(t.data_ptr(), t.numel() * t.element_size()), device=t.device)
    return raw.view(t.dtype).view(t.shape)


class _Captured(NamedTuple):
    """One key's graph: its static inputs, and its output with each tensor
    an :func:`_unowned` view of where the graph leaves it."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple
    template: object


class AdaptiveForward:
    """Callable ``inp -> ModelOutput`` running ``net`` at each scan's box.

    ``box_for`` reads the scan's bbox on the host; a caller that keeps the
    card busy across scans passes the box it took from the host scene
    (``pick_box(fwd.cands, scene.global_min, scene.global_max)``) so that
    no call waits for the card.

    The dense network's inference forward on the card is a CUDA graph per
    key (:meth:`graphed`), captured at the key's first call.  The first
    capture after the parameters were set runs one eager forward first
    (lazy loads, cuBLAS's workspace, the parameters' casts and packed
    affines: the forward's one-time state is per process, stream and
    parameter version, none of it per shape) and releases that forward's
    cache.  Every key's graph shares one memory pool and one side stream.
    A call copies its input into the key's static inputs, replays, and
    clones the outputs out of the pool, so the caller owns what it gets:
    every key's graph writes its outputs into pool memory that the next
    replay reuses, and the pool holds no output set per key.  The graphs
    and their pool are dropped, and captured again, when a parameter or
    buffer of the net changes (its version or its storage)."""

    def __init__(self, net: torch.nn.Module,
                 labelweights: Optional[Dict[int, torch.Tensor]] = None):
        self.net = net
        self.labelweights = labelweights
        self.cands = candidate_boxes(net.cfg)
        self._graphs: Dict[tuple, _Captured] = {}
        self._inputs: Dict[tuple, tuple] = {}    # static inputs by input signature
        self._pool = self._stream = self._last = self._stamp = None
        self._slots: Optional[List[dict]] = None

    def box_for(self, inp) -> Extent:
        return pick_box(self.cands, _host(inp.global_min), _host(inp.global_max))

    def __call__(self, inp, box: Optional[Extent] = None):
        """One scan's forward, the root span ``pasco.dispatch`` of its
        trace (:mod:`pasco_torch.utils.timing`)."""
        with timing.span("dispatch"):
            box = tuple(box if box is not None else self.box_for(inp))
            if not self.graphed(inp):
                GRAPHS["eager"] += 1
                timing.count("graphs.eager", 1)
                return self.net(inp, self.labelweights, box_extent=box)
            return self._replay(inp, box)

    def graphed(self, inp) -> bool:
        """Whether this call replays a CUDA graph: the dense network's
        inference forward on the card, with the program's tracing off."""
        return (self.net.cfg.model.substrate == "dense" and inp.point_feats.is_cuda
                and not self.net.training and not torch.is_grad_enabled()
                and not timing.enabled())

    def graph_for(self, inp, box: Extent) -> "_Captured":
        """The graph of this call's key (:func:`graph_key`), captured at the
        key's first call; every graph is dropped first where the net's
        parameters changed."""
        stamp = self._parameter_stamp()
        if stamp != self._stamp:
            self._graphs.clear()
            self._pool = None
            self._stamp = stamp
        key = graph_key(inp, box)
        cap = self._graphs.get(key)
        if cap is None:
            cap = self._graphs[key] = self._capture(key, inp, box)
            GRAPHS["captures"] += 1
        return cap

    def _replay(self, inp, box: Extent):
        stream = torch.cuda.current_stream(inp.point_feats.device)
        if self._last not in (None, stream):   # the last replay's pool and inputs
            stream.wait_stream(self._last)
        self._last = stream
        cap = self.graph_for(inp, box)
        for dst, src in zip(cap.inputs, inp):
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        cap.graph.replay()
        GRAPHS["replays"] += 1
        clones = {}   # one clone a view: outputs that were one tensor stay one

        def clone(view: torch.Tensor) -> torch.Tensor:
            got = clones.get(id(view))
            if got is None:
                got = clones[id(view)] = view.clone()
            return got

        return _map(cap.template, clone, torch.Tensor)

    def _parameter_stamp(self) -> tuple:
        """Version and storage of every parameter and buffer of the net,
        read from each module's own parameter and buffer dicts, listed once:
        a replaced tensor shows in its dict.  Walking ``net.parameters()``
        instead costs a millisecond or more a call, which a replay waits
        for."""
        if self._slots is None:
            self._slots = [d for m in self.net.modules() for d in (m._parameters, m._buffers)]
        return tuple((t._version, t.data_ptr())
                     for d in self._slots for t in d.values() if t is not None)

    def _capture(self, key, inp, box: Extent) -> _Captured:
        """The key's capture on the side stream into the pool, after the
        warm-up where it is the first since the parameters were set.  The
        wrappers count both forwards' launches in ``kernels.LAUNCHES``."""
        dev = inp.point_feats.device
        static = self._inputs.get(key[1])
        if static is None:
            static = self._inputs[key[1]] = tuple(t.clone() for t in inp)
        static_inp = type(inp)(*static)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        torch.cuda.synchronize(dev)
        if self._pool is None:
            # Outside the pool, and its cache released: a pool that first
            # held an eager forward keeps that forward's block sizes and
            # grows around them when captured into.
            with torch.cuda.stream(self._stream):
                self.net(static_inp, self.labelweights, box_extent=box)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            self._pool = torch.cuda.MemPool()
        graph = torch.cuda.CUDAGraph()
        flat = {}   # a contiguous form of each output tensor, alive to the capture's end
        with torch.cuda.graph(graph, pool=self._pool.id, stream=self._stream):
            out = self.net(static_inp, self.labelweights, box_extent=box)
            _map(out, lambda t: flat.setdefault(id(t), t.contiguous()), torch.Tensor)
        views = {k: _unowned(t) for k, t in flat.items()}
        template = _map(out, lambda t: views[id(t)], torch.Tensor)
        return _Captured(graph, static, template)

    @torch.no_grad()
    def warmup(self, inp) -> None:
        """One forward per candidate, so that the caching allocator, cuDNN's
        per-shape algorithm choice and each box's CUDA graph are settled
        before a box's first timed call."""
        for cand in self.cands:
            self(inp, cand)
        if inp.point_feats.is_cuda:
            torch.cuda.synchronize(inp.point_feats.device)
