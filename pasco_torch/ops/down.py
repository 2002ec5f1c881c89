"""Kernel 2: ``down2_fused``, the encoder's stride-2 down step (replaces
``pasco_tpu/ops/pallas_down.py:down_padded_to_padded``).

    out = mask_out * relu(a2 * leaky(a1 * (down2(x * mask_in, w) + b) + c1) + c2)

with ``mask_out = maxpool2_mask(mask_in)``.  A CPU tensor takes
:func:`down2_fused_plain`; a CUDA tensor launches ``csrc/down2_fused.cu``
or raises.  The kernel note is at the top of the CUDA source.  A batch of
scans (``[B, X, Z, Y, Ci]``, masks ``[B, ...]``) is one launch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from pasco_torch import kernels
from pasco_torch.ops.conv import Tiles
from pasco_torch.ops.dense_ops import down2_dense

Pair = Tuple[torch.Tensor, torch.Tensor]

WIDTHS = ((64, 128), (128, 256), (256, 256))   # (Ci, Co) the kernel takes


def down_tiles(mask_out: torch.Tensor) -> Tiles:
    """The valid output cells, compacted on the device: their flat
    ``[X/2, Z/2, Y/2]`` indices first, ascending, and their count (no host
    sync).  The kernel runs its products on these cells only.  For a batch
    ``[B, X/2, Z/2, Y/2]`` the indices are flat over all of it: cell ``o``
    of scan ``b`` is ``b * n + o``."""
    flat = mask_out.reshape(-1)
    n = flat.numel()
    pos = torch.cumsum(flat, 0, dtype=torch.int32) - 1
    dump = torch.full((), n, dtype=torch.int32, device=flat.device)
    ids = torch.zeros(n + 1, dtype=torch.int32, device=flat.device)
    ids.scatter_(0, torch.where(flat, pos, dump).long(),
                 torch.arange(n, dtype=torch.int32, device=flat.device))
    return Tiles(ids[:n], flat.sum(dtype=torch.int32).reshape(1), n)


def down2_fused_plain(x, mask_in, mask_out, weight, bias, bn1: Pair, bn2: Pair):
    """The same function in plain PyTorch (reshape + one product)."""
    xm = torch.where(mask_in[..., None], x, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
    y = down2_dense(xm, weight, bias).float()
    y = F.leaky_relu(bn1[0] * y + bn1[1], 0.01)
    y = torch.relu(bn2[0] * y + bn2[1])
    return torch.where(mask_out[..., None], y,
                       torch.zeros((), device=y.device)).to(x.dtype)


def down2_fused(
    x: torch.Tensor,            # [X, Z, Y, Ci] or [B, X, Z, Y, Ci]
    mask_in: torch.Tensor,      # [..., X, Z, Y] bool
    mask_out: torch.Tensor,     # [..., X/2, Z/2, Y/2] bool == maxpool2_mask(mask_in)
    weight: torch.Tensor,       # [8, Ci, Co]
    bias: torch.Tensor,         # [Co]
    bn1: Pair,                  # (a, c) [Co] f32
    bn2: Pair,
    tiles: Optional[Tiles] = None,    # from down_tiles(mask_out)
) -> torch.Tensor:
    if not x.is_cuda:
        return down2_fused_plain(x, mask_in, mask_out, weight, bias, bn1, bn2)
    if x.dim() not in (4, 5):
        raise ValueError(f"down2_fused takes [X, Z, Y, C] or [B, X, Z, Y, C], got {tuple(x.shape)}")
    *lead, X, Z, Y, ci = x.shape
    B = lead[0] if lead else 1
    co = weight.shape[-1]
    dev = x.device
    kernels.require(x, "x", torch.bfloat16)
    kernels.require(mask_in, "mask_in", torch.bool, (*lead, X, Z, Y), dev)
    kernels.require(mask_out, "mask_out", torch.bool, (*lead, X // 2, Z // 2, Y // 2), dev)
    if tuple(weight.shape) != (8, ci, co) or X % 2 or Z % 2 or Y % 2:
        raise ValueError(f"down2_fused: weight {tuple(weight.shape)}, x {tuple(x.shape)}")
    if (ci, co) not in WIDTHS:
        raise ValueError(f"down2_fused takes (Ci, Co) in {WIDTHS}, got {(ci, co)}")
    f32 = dict(device=dev, dtype=torch.float32)
    w = kernels.cast_once(weight, dev, torch.bfloat16)
    # no copy for vectors already f32 on the card (the BN affines are)
    vecs = [v.to(**f32).contiguous() for v in (bias, *bn1, *bn2)]
    if tiles is None:
        tiles = down_tiles(mask_out)
    if tiles.n_tiles != mask_out.numel():
        raise ValueError(f"down2_fused: {tiles.n_tiles} cells listed for {mask_out.numel()}")
    out = torch.empty((*lead, X // 2, Z // 2, Y // 2, co), dtype=torch.bfloat16, device=dev)
    err = kernels.lib().pasco_down2_fused(
        x.data_ptr(), mask_in.data_ptr(), mask_out.data_ptr(), w.data_ptr(),
        *(v.data_ptr() for v in vecs), out.data_ptr(), tiles.ids.data_ptr(),
        tiles.n_active.data_ptr(), B, X, Z, Y, ci, co, kernels.stream_ptr(x),
    )
    kernels.check(err, "down2_fused")
    kernels.LAUNCHES["down2_fused"] += 1
    return out
