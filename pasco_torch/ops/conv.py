"""Kernel 1: ``masked_conv3``, the fused 3x3x3 conv of every residual block
and refiner (replaces ``pasco_tpu/ops/pallas_conv.py:fused_packed_conv``).

    x'  = mask * [relu](a * x + c)
    out = mask * [relu](conv3_same(x', w) + bias [+ skip])

A CPU tensor takes :func:`masked_conv3_plain`; a CUDA tensor launches the
CUDA kernel ``csrc/masked_conv3.cu`` or raises.  A batch of scans,
``x [B, X, Z, Y, C]`` with ``mask [B, X, Z, Y]``, runs in the same single
launch: the tile list spans every scan (:func:`conv_tiles`).  The kernel note (what
bounds it on the card and how the design answers) is at the top of the
CUDA source.

The same kernel is the port of the training conv
(``pasco_tpu/ops/pallas_conv.py:packed_conv_trainable``, whose Pallas body
``_packed_kernel`` exists apart from ``fused_packed_conv`` only for the
TPU's layout): :class:`MaskedConv3Fn` runs ``conv3(M*x) + b`` with the
prologue off, and its backward runs the data gradient through the kernel
again with flipped taps (launches counted as ``conv3_dx``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from pasco_torch import kernels
from pasco_torch.ops.dense_ops import conv3_dense
from pasco_torch.utils import timing

TX, TZ, TY = 4, 4, 16     # tile extents (kernel constants): 256 output cells
WIDTHS = (64, 128, 256)   # Ci = Co the kernel takes: the model's widths

Affine = Optional[Tuple[torch.Tensor, torch.Tensor]]


class Tiles(NamedTuple):
    """Device-built tile list: active tile ids first, their count on the
    device (no host sync), and the static tile geometry."""

    ids: torch.Tensor        # int32 [n_tiles]
    n_active: torch.Tensor   # int32 [1]
    n_tiles: int             # over every scan of a batch
    tx: int = 1
    tz: int = 1


def _active_list(active: torch.Tensor, **geom) -> Tiles:
    ids = torch.argsort((~active).to(torch.uint8), stable=True).to(torch.int32)
    n_active = active.sum(dtype=torch.int32).reshape(1)
    return Tiles(ids, n_active, active.numel(), **geom)


def conv_tiles(mask: torch.Tensor) -> Tiles:
    """Tiles of ``TX x TZ x TY`` cells of an ``[X, Z, Y]`` mask with any
    valid cell.  Built once per stage and shared by its convs.  For a batch
    ``[B, X, Z, Y]`` tile ``t`` of scan ``b`` has id ``b * n + t`` (``n``
    tiles a scan), and the list holds the active tiles of every scan."""
    *lead, X, Z, Y = mask.shape
    nbx, nbz, nby = -(-X // TX), -(-Z // TZ), -(-Y // TY)
    m = torch.zeros((*lead, nbx * TX, nbz * TZ, nby * TY), dtype=torch.bool,
                    device=mask.device)
    m[..., :X, :Z, :Y] = mask
    active = m.reshape(*lead, nbx, TX, nbz, TZ, nby, TY).any(-1).any(-2).any(-3)
    return _active_list(active.reshape(-1), tx=TX, tz=TZ)


def masked_conv3_plain(x, mask, weight, bias=None, affine: Affine = None,
                       relu_in=False, skip=None, relu_out=False):
    """The same function in plain PyTorch (F.conv3d on a permuted view; a
    batch at N = B)."""
    m = mask[..., None]
    y = x.float()
    if affine is not None:
        y = affine[0].float() * y + affine[1].float()
    if relu_in:
        y = torch.relu(y)
    y = torch.where(m, y, torch.zeros((), dtype=y.dtype, device=y.device))
    out = conv3_dense(y.to(x.dtype), weight).float()
    if bias is not None:
        out = out + bias.float()
    if skip is not None:
        out = out + skip.float()
    if relu_out:
        out = torch.relu(out)
    return torch.where(m, out, torch.zeros((), device=out.device)).to(x.dtype)


def masked_conv3(
    x: torch.Tensor,                  # [X, Z, Y, Ci] or [B, X, Z, Y, Ci]
    mask: torch.Tensor,               # [..., X, Z, Y] bool
    weight: torch.Tensor,             # [27, Ci, Co]
    bias: Optional[torch.Tensor] = None,   # [Co]
    affine: Affine = None,            # (a, c) [Ci] f32 prologue
    relu_in: bool = False,
    skip: Optional[torch.Tensor] = None,   # [..., X, Z, Y, Co]
    relu_out: bool = False,
    tiles: Optional[Tiles] = None,    # from conv_tiles(mask)
) -> torch.Tensor:
    if not x.is_cuda:
        return masked_conv3_plain(x, mask, weight, bias, affine, relu_in,
                                  skip, relu_out)
    with timing.span("kernel.masked_conv3", events=False):
        if tiles is None:
            tiles = conv_tiles(mask)
        out = _launch(x, mask, weight, bias, affine, relu_in, skip, relu_out, tiles)
    kernels.LAUNCHES["masked_conv3"] += 1
    # the cells the launch computes: every cell of its active tiles
    timing.count("masked_conv3.tile_cells", tiles.n_active, TX * TZ * TY)
    return out


def _launch(x, mask, weight, bias, affine, relu_in, skip, relu_out, tiles, flip=False):
    """One launch of ``csrc/masked_conv3.cu`` (the caller counts it).
    ``flip`` runs the data-gradient mode on the original ``[27, C, C]``
    weight: taps reversed, Ci and Co swapped, read in place."""
    if x.dim() not in (4, 5):
        raise ValueError(f"masked_conv3 takes [X, Z, Y, C] or [B, X, Z, Y, C], got {tuple(x.shape)}")
    X, Z, Y, ch = x.shape[-4:]
    B = x.shape[0] if x.dim() == 5 else 1
    dev = x.device
    kernels.require(x, "x", torch.bfloat16)
    kernels.require(mask, "mask", torch.bool, x.shape[:-1], dev)
    if tuple(weight.shape) != (27, ch, ch) or ch not in WIDTHS:
        raise ValueError(f"masked_conv3 takes Ci = Co in {WIDTHS} and a (27, Ci, Co) "
                         f"weight, got x {tuple(x.shape)}, weight {tuple(weight.shape)}")
    w = weight.to(device=dev, dtype=torch.bfloat16).contiguous()
    b = None if bias is None else bias.to(device=dev, dtype=torch.float32).contiguous()
    a = c = None
    if affine is not None:
        a = affine[0].to(device=dev, dtype=torch.float32).contiguous()
        c = affine[1].to(device=dev, dtype=torch.float32).contiguous()
    if skip is not None:
        kernels.require(skip, "skip", torch.bfloat16, x.shape, dev)
    if tiles is None:
        tiles = conv_tiles(mask)
    per_scan = -(-X // TX) * -(-Z // TZ) * -(-Y // TY)
    if (tiles.tx, tiles.tz, tiles.n_tiles) != (TX, TZ, B * per_scan):
        raise ValueError(f"{tiles.n_tiles} tiles of {(tiles.tx, tiles.tz)} are not "
                         f"conv_tiles(mask) of {B} x {per_scan}")
    if (x.data_ptr() | w.data_ptr() | (0 if skip is None else skip.data_ptr())) % 16:
        raise ValueError("masked_conv3 needs 16-byte aligned x, weight and skip")
    # every cell is written: by its active tile, or as zero by an inactive one
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=dev)
    err = kernels.lib().pasco_masked_conv3(
        x.data_ptr(), mask.data_ptr(), w.data_ptr(), kernels.ptr(b),
        kernels.ptr(a), kernels.ptr(c), kernels.ptr(skip), out.data_ptr(),
        tiles.ids.data_ptr(), tiles.n_active.data_ptr(), B, X, Z, Y, ch, int(flip),
        int(relu_in), int(relu_out), tiles.n_tiles, kernels.stream_ptr(x),
    )
    kernels.check(err, "masked_conv3")
    return out


# --------------------------------------------------------------------------
# training: the differentiable conv (port of packed_conv_trainable)
# --------------------------------------------------------------------------


def conv3_dx(dym: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
             tiles: Optional[Tiles] = None) -> torch.Tensor:
    """Data gradient of ``conv3(M*x, weight)`` for the masked cotangent
    ``dym``: ``M * conv3(dym, w_t)`` with ``w_t = weight.flip(0)
    .transpose(1, 2)`` (``pallas_conv.py:1324-1326``).  ``flip(0)`` negates
    every tap offset because ``kernel_offsets(3)`` enumerates {-1, 0, 1}^3
    symmetrically.  On a CUDA tensor this is one launch of the kernel in
    its flipped mode, which reads ``weight`` itself with the taps reversed
    and ``Ci``/``Co`` swapped (no transposed copy), counted as
    ``conv3_dx``."""
    if not dym.is_cuda:
        return masked_conv3_plain(dym, mask, weight.flip(0).transpose(1, 2))
    with timing.span("kernel.conv3_dx", events=False):
        out = _launch(dym, mask, weight, None, None, False, None, False, tiles, flip=True)
    kernels.LAUNCHES["conv3_dx"] += 1
    return out


def conv3_weight_grad(xm: torch.Tensor, dym: torch.Tensor) -> torch.Tensor:
    """``dw[t] = sum_p xm[p + off_t]^T dym[p]``, f32 ``[27, Ci, Co]``, for a
    masked input ``xm`` and masked cotangent ``dym`` (the reference takes it
    from XLA, ``pallas_conv.py:1327-1335``; plain PyTorch here).

    Both volumes are zero-padded by one cell and flattened once; a tap is
    then a constant row offset, so each of the 27 products reads two
    contiguous row ranges of the padded buffers (no shifted copies).  Halo
    rows of the padded cotangent are zero, so rows that wrap across a line
    contribute nothing."""
    X, Z, Y, ci = xm.shape[-4:]
    co = dym.shape[-1]
    pad = (0, 0, 1, 1, 1, 1, 1, 1)
    xp = F.pad(xm, pad).reshape(-1, ci)
    dp = F.pad(dym.to(xm.dtype), pad).reshape(-1, co)
    n = dp.shape[0]
    sy, sz, sx = 1, Y + 2, (Z + 2) * (Y + 2)
    dw = torch.empty((27, ci, co), dtype=torch.float32, device=xm.device)
    for t in range(27):
        ox, oy, oz = t // 9 - 1, (t // 3) % 3 - 1, t % 3 - 1   # kernel_offsets(3)
        o = ox * sx + oz * sz + oy * sy
        lo, hi = max(0, -o), min(n, n - o)
        dw[t] = (xp[lo + o : hi + o].T @ dp[lo:hi]).float()
    return dw


class MaskedConv3Fn(torch.autograd.Function):
    """``y = M * (conv3_same(M * x, w) + b)``, differentiable in x, w, b
    (replaces ``pallas_conv.py:packed_conv_trainable``, ``_pct_fwd``,
    ``_pct_bwd``).  Forward: :func:`masked_conv3` with its prologue off.
    Backward: ``dx`` through the kernel again (:func:`conv3_dx`), ``dw``
    and ``db`` in plain PyTorch.  ``bias=None`` drops ``db``, as the
    reference's ``has_bias=False`` does.  On CPU tensors every part takes
    its plain version."""

    @staticmethod
    def forward(ctx, x, mask, weight, bias, tiles):
        ctx.save_for_backward(x, mask, weight)
        ctx.tiles = tiles
        ctx.has_bias = bias is not None
        return masked_conv3(x, mask, weight, bias, tiles=tiles)

    @staticmethod
    def backward(ctx, dy):
        x, mask, weight = ctx.saved_tensors
        m = mask[..., None]
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        dym = torch.where(m, dy.to(x.dtype), zero).contiguous()
        dx = conv3_dx(dym, mask, weight, ctx.tiles).to(x.dtype)
        dw = conv3_weight_grad(torch.where(m, x, zero), dym).to(weight.dtype)
        db = None
        if ctx.has_bias:
            db = dym.reshape(-1, dym.shape[-1]).sum(0, dtype=torch.float32)
        return dx, None, dw, db, None
