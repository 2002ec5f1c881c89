"""Plain PyTorch twins of ``pasco_tpu/ops/dense_ops.py`` on the port's layout.

Every volume is channels-last in ``[X, Z, Y, C]`` order
(``pasco_tpu/models/dense_unet.py:64-70``); occupancy masks are
``[X, Z, Y]`` bool.  A batch of scans (the batched forward) puts one
leading axis in front, ``[B, X, Z, Y, C]`` and ``[B, X, Z, Y]``, with a
``[B, 3]`` box corner; every function here takes either form.  Weights keep the reference's sparse layout
``[K, Cin, Cout]`` with taps enumerated by ``kernel_offsets``: x-major,
z fastest over the logical (x, y, z) offsets.  The z-pair packing of the
TPU path is not ported: it exists only to fill the TPU's 128-lane tiles.

These functions are the CPU oracles of the hand-written kernels; they
compute products in float32 on the operands' values and return the
input dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from pasco_torch.core.sparse import Box
from pasco_torch.ops.extract import stream_extract


def conv3_dense(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """'Same' 3x3x3 conv of an ``[X, Z, Y, Ci]`` volume (or ``[B, X, Z, Y,
    Ci]``: one conv at N = B), weight ``[27, Ci, Co]``."""
    ci, co = weight.shape[1], weight.shape[2]
    # taps (dx, dy, dz) -> conv3d's [Co, Ci, kX, kZ, kY] over (X, Z, Y)
    w = weight.reshape(3, 3, 3, ci, co).permute(4, 3, 0, 2, 1)
    xb = x if x.dim() == 5 else x[None]
    out = F.conv3d(xb.permute(0, 4, 1, 2, 3), w.to(x.dtype), padding=1)
    out = out.permute(0, 2, 3, 4, 1).reshape(*x.shape[:-1], co)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def down2_dense(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel-2 stride-2 conv as one product: each output cell's 2x2x2
    children (taps ``kernel_offsets(2)``: (ix, iy, iz), z fastest)."""
    *lead, X, Z, Y, c = x.shape
    n = len(lead)
    xr = (
        x.reshape(*lead, X // 2, 2, Z // 2, 2, Y // 2, 2, c)
        .permute(*range(n), n, n + 2, n + 4, n + 1, n + 5, n + 3, n + 6)
        .reshape(-1, 8 * c)                   # [..., X2, Z2, Y2, ix, iy, iz, c]
    )
    out = xr.float() @ weight.reshape(8 * c, -1).to(x.dtype).float()
    if bias is not None:
        out = out + bias.float()
    return out.reshape(*lead, X // 2, Z // 2, Y // 2, -1).to(x.dtype)


def deconv2_dense(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Generative stride-2 transposed conv: parent p emits child
    ``2p + offset_k`` with ``x[p] @ weight[k]`` (one product + a
    depth-to-space shuffle)."""
    *lead, X, Z, Y, c = x.shape
    n = len(lead)
    d = weight.shape[-1]
    w = weight.to(x.dtype).float().permute(1, 0, 2).reshape(c, 8 * d)
    out = x.reshape(-1, c).float() @ w
    if bias is not None:
        out = out + bias.float().repeat(8)
    out = out.to(x.dtype).reshape(*lead, X, Z, Y, 2, 2, 2, d)   # (ix, iy, iz)
    out = out.permute(*range(n), n, n + 3, n + 1, n + 5, n + 2, n + 4, n + 6)
    return out.reshape(*lead, 2 * X, 2 * Z, 2 * Y, d)


def maxpool2_mask(mask: torch.Tensor) -> torch.Tensor:
    """[..., X, Z, Y] bool -> [..., X/2, Z/2, Y/2] any-child."""
    *lead, X, Z, Y = mask.shape
    return mask.reshape(*lead, X // 2, 2, Z // 2, 2, Y // 2, 2).any(-1).any(-2).any(-3)


def upsample2_mask(mask: torch.Tensor) -> torch.Tensor:
    """[..., X, Z, Y] bool -> [..., 2X, 2Z, 2Y] broadcast to the children."""
    *lead, X, Z, Y = mask.shape
    out = mask[..., :, None, :, None, :, None].expand(*lead, X, 2, Z, 2, Y, 2)
    return out.reshape(*lead, 2 * X, 2 * Z, 2 * Y)


def _axis_coords(box: Box, stride: int):
    """Absolute x, y, z cell coordinates of the box: ``[ex]``, ``[ey]``,
    ``[ez]`` (``[B, e]`` each for a ``[B, 3]`` corner)."""
    ex, ey, ez = box.extent_at(stride)
    mn = box.minimum
    dev = mn.device
    return tuple(
        mn[..., j, None] + torch.arange(e, device=dev, dtype=torch.int32) * stride
        for j, e in enumerate((ex, ey, ez)))


def bbox_mask(box: Box, stride: int, bbox_min: torch.Tensor,
              bbox_max: torch.Tensor) -> torch.Tensor:
    """[X, Z, Y] bool of cells whose absolute coords lie in [min, max]
    (``[B, X, Z, Y]`` for a ``[B, 3]`` box corner and ``[B, 3]`` bounds)."""
    ax, ay, az = _axis_coords(box, stride)
    mx = (ax >= bbox_min[..., 0, None]) & (ax <= bbox_max[..., 0, None])
    my = (ay >= bbox_min[..., 1, None]) & (ay <= bbox_max[..., 1, None])
    mz = (az >= bbox_min[..., 2, None]) & (az <= bbox_max[..., 2, None])
    return mx[..., :, None, None] & mz[..., None, :, None] & my[..., None, None, :]


def cell_coords(box: Box, stride: int) -> torch.Tensor:
    """[X, Z, Y, 3] int32 absolute stride-1 (x, y, z) cell coordinates
    (``[B, X, Z, Y, 3]`` for a ``[B, 3]`` box corner)."""
    ax, ay, az = _axis_coords(box, stride)
    shape = (*ax.shape[:-1], ax.shape[-1], az.shape[-1], ay.shape[-1])
    gx = ax[..., :, None, None].expand(shape)
    gz = az[..., None, :, None].expand(shape)
    gy = ay[..., None, None, :].expand(shape)
    return torch.stack([gx, gy, gz], dim=-1)


def coords_from_src(src: torch.Tensor, valid: torch.Tensor, shape, box: Box,
                    stride: int) -> torch.Tensor:
    """[cap, 4] int32 ``(0, x, y, z)`` from flat ``[X, Z, Y]`` indices;
    zero at invalid rows (``[B, cap, 4]`` from ``[B, cap]`` rows and a
    ``[B, 3]`` box corner)."""
    Z, Y = shape[-2], shape[-1]
    src = src.long()
    sy = src % Y
    sz = (src // Y) % Z
    sx = src // (Y * Z)
    rel = torch.stack([sx, sy, sz], dim=-1) * stride + box.minimum[..., None, :]
    rel = torch.where(valid[..., None], rel, torch.zeros_like(rel))
    return torch.cat([torch.zeros_like(rel[..., :1]), rel], dim=-1).to(torch.int32)


def extract_sparse(
    keep: torch.Tensor,                       # [X, Z, Y] or [B, X, Z, Y] bool
    box: Box,
    stride: int,
    capacity: int,
    payload: Optional[torch.Tensor] = None,   # [..., X, Z, Y, E] carried along
):
    """Compact kept cells in flat-index order (the reference's
    ``compact_src`` order: the first ``capacity`` kept cells, ascending).
    Returns ``(coords [cap, 4] int32, valid [cap] bool, vals [cap, E])``,
    each with the batch in front for a batch (``capacity`` per scan);
    the payload moves through :func:`pasco_torch.ops.extract.stream_extract`."""
    vals, src, valid, _ = stream_extract(keep, capacity, payload)
    return coords_from_src(src, valid, keep.shape, box, stride), valid, vals


def extract_sparse_train(
    keep: torch.Tensor,          # [X, Z, Y] or [B, X, Z, Y] bool
    box: Box,
    stride: int,
    capacity: int,
    payload: torch.Tensor,       # [..., X, Z, Y, E]
):
    """The training form of :func:`extract_sparse`: the compaction kernel
    gives the rows (``src``, ``valid``) with an empty payload, and the
    payload rows are then gathered with a differentiable ``index_select``
    and zeroed past ``valid``, so gradients reach ``payload``.  Same rows
    in the same order as the reference's XLA extraction
    (``dense_unet.py:1351-1378, 1469-1479``)."""
    _, src, valid, _ = stream_extract(keep, capacity)
    e = payload.shape[-1]
    # rows of the flattened batch: scan b's cells follow those of scans < b
    first = torch.arange(math.prod(src.shape[:-1]), device=src.device) * math.prod(keep.shape[-3:])
    flat = src.long() + first.reshape(*src.shape[:-1], 1)
    rows = payload.reshape(-1, e).index_select(0, flat.reshape(-1))
    rows = rows.reshape(*src.shape, e)
    vals = torch.where(valid[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return coords_from_src(src, valid, keep.shape, box, stride), valid, vals


def cap_keep_gumbel(
    keep: torch.Tensor,                  # [X, Z, Y] bool
    score: torch.Tensor,                 # [X, Z, Y] sampling weight (>= 0)
    cap: int,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,    # [X, Z, Y] Gumbel draws
    iters: int = 24,
) -> torch.Tensor:
    """Train-time occupancy cap (``pasco_tpu/ops/dense_ops.py:684-722``):
    weighted sampling without replacement of ``cap`` kept cells
    proportional to ``score`` as Gumbel-top-k on ``log score``.  The k-th
    value is found as the reference finds it, by bisecting a threshold over
    [-60, 60] with ``iters`` counting passes, so the same noise gives the
    same keep set (a ``topk`` would not, at the bisection's count error).
    The count stays on the device: no host sync.  No-op when the keep
    count is within ``cap``.  The noise comes from ``generator`` unless
    ``noise`` is given."""
    if noise is None:
        u = torch.rand(keep.shape, generator=generator, device=keep.device)
        u = u.clamp(min=torch.finfo(torch.float32).tiny)
        noise = -torch.log(-torch.log(u))
    z = torch.where(
        keep,
        torch.log(score.float().clamp(min=1e-20)) + noise.float(),
        torch.full((), -float("inf"), device=keep.device),
    )
    lo = torch.full((), -60.0, device=keep.device)
    hi = torch.full((), 60.0, device=keep.device)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        over = (z > mid).sum() > cap     # too many kept -> raise threshold
        lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
    return torch.where(keep.sum() > cap, keep & (z > hi), keep)


def point_dropout(pm: torch.Tensor, rate: float,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Drop a random 0..``rate`` fraction of the valid points
    (``pasco_tpu/models/dense_unet.py:322-338``)."""
    frac = torch.rand((), generator=generator, device=pm.device) * rate
    keep = torch.rand(pm.shape, generator=generator, device=pm.device) < 1.0 - frac
    return pm & keep


def scatter_max_rows(f: torch.Tensor, flat_idx: torch.Tensor, n_rows: int,
                     neg: float) -> torch.Tensor:
    """Per-channel scatter-max of point rows ``f [P, C]`` into an
    ``[n_rows + 1, C]`` table initialised to ``neg``; index ``n_rows`` is
    the dump row."""
    table = torch.full((n_rows + 1, f.shape[1]), neg, dtype=f.dtype,
                       device=f.device)
    idx = flat_idx.long()[:, None].expand_as(f)
    return table.scatter_reduce_(0, idx, f, reduce="amax", include_self=True)
