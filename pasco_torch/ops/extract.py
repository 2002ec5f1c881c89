"""Kernel 4: ``stream_extract``, the stream compaction of kept cells
(replaces ``pasco_tpu/ops/pallas_extract.py:stream_extract_z2``, both of
its kernels).

Returns ``(vals [cap, E], src [cap] int32, valid [cap] bool, total [] int32)``
in the flat-index order of the reference's ``compact_src``: the first
``cap`` kept cells, ascending.  Rows past ``min(total, cap)`` are zero.
A batch ``keep [B, X, Z, Y]`` (``payload [B, X, Z, Y, E]``) extracts each
scan on its own, ``cap`` rows each, and stacks the results: the kernel
launches once per scan (its single-pass look-back and its capacity are
per call, as ``jax.vmap`` of the reference gives each scan the whole cap).
A CPU tensor takes :func:`stream_extract_plain`; a CUDA tensor launches
``csrc/stream_extract.cu`` or raises.  The kernel note is at the top of
the CUDA source.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch

from pasco_torch import kernels
from pasco_torch.utils import timing


def compact_src(keep_f: torch.Tensor, capacity: int):
    """(src, valid, total) of a flat keep vector: ``src[j]`` is the flat
    index of the j-th kept cell (zero past the kept count)."""
    idx = keep_f.nonzero().squeeze(1)
    total = torch.tensor(idx.numel(), dtype=torch.int32, device=keep_f.device)
    n = min(idx.numel(), capacity)
    src = torch.zeros((capacity,), dtype=torch.int32, device=keep_f.device)
    src[:n] = idx[:n].to(torch.int32)
    valid = torch.arange(capacity, device=keep_f.device) < n
    return src, valid, total


def _per_scan(fn, keep, capacity, payload):
    """``fn`` on each scan of a batch, the results stacked."""
    outs = [fn(keep[b], capacity, None if payload is None else payload[b])
            for b in range(keep.shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def stream_extract_plain(keep, capacity, payload=None):
    """The same function in plain PyTorch (``nonzero()[:cap]`` + gather)."""
    if keep.dim() == 4:
        return _per_scan(stream_extract_plain, keep, capacity, payload)
    src, valid, total = compact_src(keep.reshape(-1), capacity)
    e = 0 if payload is None else payload.shape[-1]
    dtype = torch.bfloat16 if payload is None else payload.dtype
    vals = torch.zeros((capacity, e), dtype=dtype, device=keep.device)
    if payload is not None:
        n = int(valid.sum())
        vals[:n] = payload.reshape(-1, e)[src[:n].long()]
    return vals, src, valid, total


class _Workspace:
    """The kernel's look-back flags on one (device, stream): one int64 word
    per tile, zeroed once when allocated.  Every call takes a new epoch,
    which tags the flag words it writes, so no call needs a memset; calls on
    one stream run in order, so they never share the words at once.  A call
    captured into a CUDA graph takes no workspace (:func:`_launch`)."""

    __slots__ = ("buf", "tiles", "epoch", "lock")

    def __init__(self):
        self.buf, self.tiles, self.epoch = None, -1, 0
        self.lock = threading.Lock()

    def take(self, n_tiles: int, dev: torch.device) -> Tuple[torch.Tensor, int, int]:
        """(buffer, its tiles, a new epoch) for one call of ``n_tiles``."""
        with self.lock:
            if n_tiles > self.tiles:
                self.buf = torch.zeros((n_tiles,), dtype=torch.int64, device=dev)
                self.tiles = n_tiles
            self.epoch += 1
            if self.epoch >= 1 << 32:           # an old word could carry this epoch
                self.buf.zero_()
                self.epoch = 1
            return self.buf, self.tiles, self.epoch


TILE = 16384   # cells per tile (csrc/stream_extract.cu; the kernel checks the workspace)
_WORKSPACES: Dict[Tuple[int, int], _Workspace] = {}


def stream_extract(
    keep: torch.Tensor,                       # [X, Z, Y] or [B, X, Z, Y] bool
    capacity: int,
    payload: Optional[torch.Tensor] = None,   # [..., X, Z, Y, E] bf16
):
    if not keep.is_cuda:
        return stream_extract_plain(keep, capacity, payload)
    if keep.dim() == 4:
        return _per_scan(_launch, keep, capacity, payload)
    return _launch(keep, capacity, payload)


def _launch(keep, capacity, payload):
    """One launch of ``csrc/stream_extract.cu`` on one scan (counted)."""
    with timing.span("kernel.stream_extract", events=False):
        dev = keep.device
        kernels.require(keep, "keep", torch.bool)
        n = keep.numel()
        if n >= 1 << 30:
            raise ValueError(f"stream_extract takes fewer than 2^30 cells, got {n}")
        e = 0
        if payload is not None:
            e = payload.shape[-1]
            kernels.require(payload, "payload", torch.bfloat16, (*keep.shape, e), dev)
        stream = kernels.stream_ptr(keep)
        if torch.cuda.is_current_stream_capturing():
            # A CUDA graph replays the epoch it captured, so each replay
            # would read the flags of the last one as its own: the captured
            # call zeroes flag words of its own first.
            buf = torch.zeros((-(-n // TILE),), dtype=torch.int64, device=dev)
            tiles, epoch = buf.numel(), 1
        else:
            key = (dev.index, stream)
            ws = _WORKSPACES.get(key) or _WORKSPACES.setdefault(key, _Workspace())
            buf, tiles, epoch = ws.take(-(-n // TILE), dev)
        vals = torch.empty((capacity, e), dtype=torch.bfloat16, device=dev)
        src = torch.empty((capacity,), dtype=torch.int32, device=dev)
        valid = torch.empty((capacity,), dtype=torch.bool, device=dev)
        total = torch.empty((), dtype=torch.int32, device=dev)
        err = kernels.lib().pasco_stream_extract(
            keep.data_ptr(), kernels.ptr(payload), n, e, capacity, buf.data_ptr(), tiles, epoch,
            vals.data_ptr(), src.data_ptr(), valid.data_ptr(), total.data_ptr(), stream)
        kernels.check(err, "stream_extract")
    kernels.LAUNCHES["stream_extract"] += 1
    return vals, src, valid, total
