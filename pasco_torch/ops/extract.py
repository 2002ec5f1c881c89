"""Kernel 4: ``stream_extract``, the stream compaction of kept cells
(replaces ``pasco_tpu/ops/pallas_extract.py:stream_extract_z2``, both of
its kernels).

Returns ``(vals [cap, E], src [cap] int32, valid [cap] bool, total [] int32)``
in the flat-index order of the reference's ``compact_src``: the first
``cap`` kept cells, ascending.  Rows past ``min(total, cap)`` are zero.
A CPU tensor takes :func:`stream_extract_plain`; a CUDA tensor launches
``csrc/stream_extract.cu`` or raises.  The kernel note is at the top of
the CUDA source.
"""

from __future__ import annotations

from typing import Optional

import torch

from pasco_torch import kernels

CELLS = 1024   # cells per block (kernel constant)


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


def stream_extract_plain(keep, capacity, payload=None):
    """The same function in plain PyTorch (``nonzero()[:cap]`` + gather)."""
    src, valid, total = compact_src(keep.reshape(-1), capacity)
    e = 0 if payload is None else payload.shape[-1]
    dtype = torch.bfloat16 if payload is None else payload.dtype
    vals = torch.zeros((capacity, e), dtype=dtype, device=keep.device)
    if payload is not None:
        n = int(valid.sum())
        vals[:n] = payload.reshape(-1, e)[src[:n].long()]
    return vals, src, valid, total


def stream_extract(
    keep: torch.Tensor,                       # [X, Z, Y] bool
    capacity: int,
    payload: Optional[torch.Tensor] = None,   # [X, Z, Y, E] bf16
):
    if not keep.is_cuda:
        return stream_extract_plain(keep, capacity, payload)
    dev = keep.device
    kernels.require(keep, "keep", torch.bool)
    n = keep.numel()
    e = 0
    if payload is not None:
        e = payload.shape[-1]
        kernels.require(payload, "payload", torch.bfloat16, (*keep.shape, e), dev)
    nb = -(-n // CELLS)
    counts = torch.empty((nb,), dtype=torch.int32, device=dev)
    offsets = torch.empty((nb,), dtype=torch.int32, device=dev)
    vals = torch.zeros((capacity, e), dtype=torch.bfloat16, device=dev)
    src = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    valid = torch.zeros((capacity,), dtype=torch.bool, device=dev)
    total = torch.zeros((1,), dtype=torch.int32, device=dev)
    err = kernels.lib().pasco_stream_extract(
        keep.data_ptr(), kernels.ptr(payload), n, e, capacity,
        counts.data_ptr(), offsets.data_ptr(), vals.data_ptr(),
        src.data_ptr(), valid.data_ptr(), total.data_ptr(),
        kernels.stream_ptr(keep),
    )
    kernels.check(err, "stream_extract")
    kernels.LAUNCHES["stream_extract"] += 1
    return vals, src, valid, total[0]
