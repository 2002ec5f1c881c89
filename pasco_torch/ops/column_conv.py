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
a CUDA tensor launches ``csrc/column_conv3.cu`` or raises.  The kernel
computes on the TF32 tensor cores at f32 accuracy: each operand is split
into two TF32 values (:func:`tf32_split`) and three products are summed
(:func:`block_sparse_conv3_split` is the same arithmetic in plain PyTorch).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from pasco_torch import kernels
from pasco_torch.utils import timing

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


def listed_columns(ids: torch.Tensor, n_active: torch.Tensor, X: int, Y: int) -> torch.Tensor:
    """``[ceil(X/8) * ceil(Y/8)]`` bool: the listed columns by flat id (no
    host sync)."""
    bx, by = _col_grid(X, Y)
    slot = torch.arange(ids.numel(), device=ids.device) < n_active
    col = torch.zeros((bx * by + 1,), dtype=torch.bool, device=ids.device)
    col[torch.where(slot, ids.long(), torch.full_like(ids.long(), bx * by))] = True
    return col[:-1]


def visited_cells(ids: torch.Tensor, n_active: torch.Tensor, X: int, Y: int) -> torch.Tensor:
    """``[X, Y]`` bool: the cells of the listed columns (no host sync)."""
    bx, by = _col_grid(X, Y)
    cells = listed_columns(ids, n_active, X, Y).reshape(bx, 1, by, 1).expand(bx, BLOCK, by, BLOCK)
    return cells.reshape(bx * BLOCK, by * BLOCK)[:X, :Y]


def conv3_xyz(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """'Same' 3x3x3 conv of ``x [X, Y, Z, C]`` with ``weight [27, C, D]``
    (taps x-major, z fastest), in ``x``'s dtype.  An f32 conv stays f32 on
    the card whatever the caller's global TF32 flag says."""
    ci, co = weight.shape[1], weight.shape[2]
    w = weight.reshape(3, 3, 3, ci, co).permute(4, 3, 0, 1, 2)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        out = F.conv3d(x.permute(3, 0, 1, 2)[None], w.to(x.dtype), padding=1)
    return out[0].permute(1, 2, 3, 0)


def _rna_tf32(v: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (10 mantissa bits) as PTX ``cvt.rna.tf32.f32`` rounds:
    to nearest, ties away from zero, on the bit pattern."""
    b = v.contiguous().view(torch.int32)
    r = ((b + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(v), v, r)


def tf32_split(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``v`` as ``hi + lo``, both TF32 values: ``hi = rna(v)``, ``lo =
    rna(v - hi)`` (0 where ``hi`` is not finite).  ``hi + lo`` is ``v`` to
    within 2^-22 relative; the kernel splits its inputs the same way."""
    v = v.float()
    hi = _rna_tf32(v)
    lo = torch.where(torch.isfinite(hi), _rna_tf32(v - hi), torch.zeros((), device=v.device))
    return hi, lo


# Channel of K position P (0..31) of a 32-channel weight unit: the kernel's
# A fragment holds channels 4t .. 4t + 3 of a k16 step at K positions t and
# t + 4 of its two k8 steps, so k8 step S keeps channel 16 (S / 2) + 4 p +
# 2 (S % 2) at position p < 4 and the next channel at position p + 4.
_K_PERM = [16 * (P // 16) + 4 * (P % 4) + 2 * (P // 8 % 2) + P % 8 // 4 for P in range(32)]
N_TILE = 64   # output channels of one kernel work item


def split_weight_image(weight: torch.Tensor, compute_dtype=None) -> Tuple[torch.Tensor, int, int]:
    """The kernel's weight operand: ``weight [27, C, D]`` rounded to
    ``compute_dtype``, split (:func:`tf32_split`) and laid out as the
    shared-memory image the kernel copies unit by unit.  C is zero-padded to
    32 (C <= 32) or a multiple of 64, D to a multiple of 64.  Returns the
    flat f32 image ``[D/64][C/64 chunks][27 taps][NB][hi, lo][64 n][32 k]``
    (a unit per (chunk, tap, 32 channels); K in :data:`_K_PERM` order; the
    eight 16-byte chunks of row n XOR-swizzled by n % 8, wgmma's 128-byte
    K-major layout), NB (1 or 2 units of 32 channels per chunk) and the
    number of chunks."""
    _, c, d = weight.shape
    cs = -(-c // 4) * 4
    cp = 32 if cs <= 32 else -(-cs // 64) * 64
    nb = min(cp, 64) // 32
    nkc, nd = cp // (32 * nb), -(-d // N_TILE)
    w = weight.to(compute_dtype or weight.dtype).float()
    s = F.pad(torch.stack(tf32_split(w)), (0, nd * N_TILE - d, 0, cp - c))
    s = s.reshape(2, 27, nkc, nb, 32, nd, N_TILE)[:, :, :, :, _K_PERM]
    s = s.permute(5, 2, 1, 3, 0, 6, 4).reshape(nd, nkc, 27, nb, 2, N_TILE, 8, 4)
    n = torch.arange(N_TILE, device=w.device)[:, None]
    s = s[..., n, torch.arange(8, device=w.device)[None] ^ (n & 7), :]
    return s.contiguous().reshape(-1), nb, nkc


def _finish(out, mask, bias, dtype):
    if bias is not None:
        out = torch.where(mask[..., None], out + bias.float(), out)
    return out.to(dtype)


def block_sparse_conv3_plain(x, weight, mask, block_capacity: int, bias=None,
                             compute_dtype=None) -> torch.Tensor:
    """The same function in plain PyTorch: the dense conv in f32 of the
    rounded inputs, zeroed outside the visited columns."""
    return block_sparse_conv3_split(x, weight, mask, block_capacity, bias, compute_dtype,
                                    products=0)


def block_sparse_conv3_split(x, weight, mask, block_capacity: int, bias=None,
                             compute_dtype=None, products: int = 3) -> torch.Tensor:
    """The plain version with the kernel's TF32 arithmetic: both operands
    split (:func:`tf32_split`) and ``products`` of ``lo_x hi_w``, ``hi_x
    lo_w``, ``hi_x hi_w`` summed in f32 (3: all, the kernel's; 2: the last
    two; 1: ``hi_x hi_w`` alone, one TF32 pass).  ``products=0`` is f32:
    :func:`block_sparse_conv3_plain`."""
    cd = compute_dtype or x.dtype
    X, Y, _ = mask.shape
    ids, n_active = active_columns(mask, block_capacity)
    xf, wf = x.to(cd).float(), weight.to(cd).float()
    if products == 0:
        out = conv3_xyz(xf, wf)
    else:
        (xh, xl), (wh, wl) = tf32_split(xf), tf32_split(wf)
        terms = [(xl, wh), (xh, wl), (xh, wh)][3 - products:]
        out = sum(conv3_xyz(a, b) for a, b in terms)
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
    with timing.span("kernel.column_conv3", events=False):
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
        if bias is not None and tuple(bias.shape) != (d,):
            raise ValueError(f"bias shape {tuple(bias.shape)} != ({d},)")
        cd = compute_dtype or x.dtype
        xf = x.to(cd).float()
        if c % 4:   # the kernel copies 16-byte chunks of a cell's channels
            xf = F.pad(xf, (0, 4 - c % 4))
        xf = xf.contiguous()
        if xf.data_ptr() % 16:
            xf = xf.clone()
        img, nb, nkc = split_weight_image(weight.to(dev), cd)
        bf = None if bias is None else bias.to(dev, torch.float32).contiguous()
        ids, n_active = active_columns(mask, block_capacity)
        listed = listed_columns(ids, n_active, X, Y)
        out = torch.empty((X, Y, Z, d), dtype=torch.float32, device=dev)
        err = kernels.lib().pasco_column_conv3(
            xf.data_ptr(), img.data_ptr(), None if bf is None else bf.data_ptr(),
            mask.data_ptr(), listed.data_ptr(), out.data_ptr(), ids.data_ptr(),
            n_active.data_ptr(), X, Y, Z, xf.shape[-1], d, nb, nkc, block_capacity,
            kernels.stream_ptr(x))
        kernels.check(err, "column_conv3")
    kernels.LAUNCHES["column_conv3"] += 1
    return out.to(x.dtype)
