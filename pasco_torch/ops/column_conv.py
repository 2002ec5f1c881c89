"""Kernel 7: ``block_sparse_conv3``, the 'same' 3x3x3 conv over the occupied
8x8xZ columns of an unpacked volume (replaces
``pasco_tpu/ops/pallas_conv.py:block_sparse_conv3``, ``active_columns`` and
the Pallas body ``_kernel``).

Layout and meaning are the reference's: ``x [X, Y, Z, C]``, ``weight
[27, C, D]`` with taps in ``kernel_offsets(3)`` order (x-major, z fastest),
``mask [X, Y, Z]``.  The conv visits only the columns listed by
:func:`active_columns`; every cell of a visited column, masked or not,
gets the raw 27-tap conv of ``x`` (the halo reads the unvisited neighbours'
inputs as they are), and cells of unvisited columns get no conv (exactly
0), also where ``capacity`` truncates the list.  The bias is then added at
mask cells only, visited or not (``pallas_conv.py:1369-1372``).  The
inputs are rounded to ``compute_dtype`` and the products are computed in
f32; the output has ``x.dtype``.  Unlike the port's other ops
this does NOT zero mask-invalid cells of visited columns: that is the
reference's contract (its callers re-mask).

The reference's ``Z % 8 == 0`` and 128-lane padding are TPU limits and are
not kept; ``X`` and ``Y`` need not be multiples of 8 either (the edge
columns are partial).  A CPU tensor takes :func:`block_sparse_conv3_plain`;
a CUDA tensor launches ``csrc/column_conv3.cu`` or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from pasco_torch import kernels

BLOCK = 8   # x/y column extent


def _col_grid(X: int, Y: int) -> Tuple[int, int]:
    return -(-X // BLOCK), -(-Y // BLOCK)


def active_columns(mask: torch.Tensor, capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 8x8 columns of ``mask [X, Y, Z]`` that hold any mask cell, as
    flat ids ``bx * ceil(Y/8) + by`` in ascending order, the first
    ``capacity`` of them (zero-padded to ``capacity``), and ``n_active =
    min(total, capacity)`` as an int32 ``[1]`` tensor.  Built on the
    tensor's device with no host sync (``pallas_conv.py:96-112``)."""
    X, Y, Z = mask.shape
    bx, by = _col_grid(X, Y)
    m = torch.zeros((bx * BLOCK, by * BLOCK, Z), dtype=torch.bool, device=mask.device)
    m[:X, :Y] = mask
    occ = m.reshape(bx, BLOCK, by, BLOCK, Z).any(4).any(3).any(1).reshape(-1)
    new_pos = torch.cumsum(occ.to(torch.int32), 0) - 1
    total = new_pos[-1:] + 1
    dest = torch.where(occ & (new_pos < capacity), new_pos,
                       torch.full_like(new_pos, capacity)).long()
    src = torch.zeros((capacity + 1,), dtype=torch.int32, device=mask.device)
    src.scatter_(0, dest, torch.arange(occ.numel(), dtype=torch.int32, device=mask.device))
    return src[:capacity], torch.clamp(total, max=capacity).to(torch.int32)


def visited_cells(ids: torch.Tensor, n_active: torch.Tensor, X: int, Y: int) -> torch.Tensor:
    """``[X, Y]`` bool: the cells of the listed columns (no host sync)."""
    bx, by = _col_grid(X, Y)
    listed = torch.arange(ids.numel(), device=ids.device) < n_active
    col = torch.zeros((bx * by + 1,), dtype=torch.bool, device=ids.device)
    col[torch.where(listed, ids.long(), torch.full_like(ids.long(), bx * by))] = True
    cells = col[:-1].reshape(bx, 1, by, 1).expand(bx, BLOCK, by, BLOCK)
    return cells.reshape(bx * BLOCK, by * BLOCK)[:X, :Y]


def conv3_xyz(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """'Same' 3x3x3 conv of ``x [X, Y, Z, C]`` with ``weight [27, C, D]``
    (taps x-major, z fastest), in ``x``'s dtype."""
    ci, co = weight.shape[1], weight.shape[2]
    w = weight.reshape(3, 3, 3, ci, co).permute(4, 3, 0, 1, 2)
    return F.conv3d(x.permute(3, 0, 1, 2)[None], w.to(x.dtype), padding=1)[0].permute(1, 2, 3, 0)


def _finish(out, mask, bias, dtype):
    if bias is not None:
        out = torch.where(mask[..., None], out + bias.float(), out)
    return out.to(dtype)


def block_sparse_conv3_plain(x, weight, mask, block_capacity: int, bias=None,
                             compute_dtype=None) -> torch.Tensor:
    """The same function in plain PyTorch: the dense conv in f32 of the
    rounded inputs, zeroed outside the visited columns."""
    cd = compute_dtype or x.dtype
    X, Y, _ = mask.shape
    ids, n_active = active_columns(mask, block_capacity)
    out = conv3_xyz(x.to(cd).float(), weight.to(cd).float())
    vis = visited_cells(ids, n_active, X, Y)
    out = torch.where(vis[:, :, None, None], out, torch.zeros((), device=out.device))
    return _finish(out, mask, bias, x.dtype)


def block_sparse_conv3(
    x: torch.Tensor,                     # [X, Y, Z, C]
    weight: torch.Tensor,                # [27, C, D]
    mask: torch.Tensor,                  # [X, Y, Z] bool
    block_capacity: int,
    bias: Optional[torch.Tensor] = None,  # [D]
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    if not x.is_cuda:
        return block_sparse_conv3_plain(x, weight, mask, block_capacity, bias, compute_dtype)
    X, Y, Z, c = x.shape
    d = weight.shape[-1]
    dev = x.device
    kernels.require(mask, "mask", torch.bool, (X, Y, Z), dev)
    if tuple(weight.shape) != (27, c, d):
        raise ValueError(f"weight shape {tuple(weight.shape)} != (27, {c}, {d})")
    if d % 16:
        raise ValueError(f"block_sparse_conv3 needs D % 16 == 0, got {d}")
    if block_capacity < 1:
        raise ValueError("block_capacity must be positive")
    cd = compute_dtype or x.dtype
    xf = x.to(cd).float().contiguous()
    wf = weight.to(device=dev, dtype=cd).float().contiguous()
    ids, n_active = active_columns(mask, block_capacity)
    out = torch.zeros((X, Y, Z, d), dtype=torch.float32, device=dev)
    err = kernels.lib().pasco_column_conv3(
        xf.data_ptr(), wf.data_ptr(), out.data_ptr(), ids.data_ptr(),
        n_active.data_ptr(), X, Y, Z, c, d, block_capacity, kernels.stream_ptr(x))
    kernels.check(err, "column_conv3")
    kernels.LAUNCHES["column_conv3"] += 1
    return _finish(out, mask, bias, x.dtype)
