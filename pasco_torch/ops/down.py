"""Kernel 2: ``down2_fused``, the encoder's stride-2 down step (replaces
``pasco_tpu/ops/pallas_down.py:down_padded_to_padded``).

    out = mask_out * relu(a2 * leaky(a1 * (down2(x * mask_in, w) + b) + c1) + c2)

with ``mask_out = maxpool2_mask(mask_in)``.  A CPU tensor takes
:func:`down2_fused_plain`; a CUDA tensor launches ``csrc/down2_fused.cu``
or raises.  The kernel note is at the top of the CUDA source.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from pasco_torch import kernels
from pasco_torch.ops.conv import Tiles, _active_list
from pasco_torch.ops.dense_ops import down2_dense

ROWS = 128    # output cells per block (kernel constant)

Pair = Tuple[torch.Tensor, torch.Tensor]


def row_tiles(mask: torch.Tensor, rows: int) -> Tiles:
    """Tiles of ``rows`` consecutive flat cells with any valid cell."""
    flat = mask.reshape(-1)
    pad = (-flat.numel()) % rows
    active = F.pad(flat.to(torch.uint8), (0, pad)).reshape(-1, rows).any(1)
    return _active_list(active)


def down_tiles(mask_out: torch.Tensor) -> Tiles:
    """Tiles of 128 flat output cells with any valid output cell."""
    return row_tiles(mask_out, ROWS)


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
    x: torch.Tensor,            # [X, Z, Y, Ci]
    mask_in: torch.Tensor,      # [X, Z, Y] bool
    mask_out: torch.Tensor,     # [X/2, Z/2, Y/2] bool == maxpool2_mask(mask_in)
    weight: torch.Tensor,       # [8, Ci, Co]
    bias: torch.Tensor,         # [Co]
    bn1: Pair,                  # (a, c) [Co] f32
    bn2: Pair,
    tiles: Optional[Tiles] = None,    # from down_tiles(mask_out)
) -> torch.Tensor:
    if not x.is_cuda:
        return down2_fused_plain(x, mask_in, mask_out, weight, bias, bn1, bn2)
    X, Z, Y, ci = x.shape
    co = weight.shape[-1]
    dev = x.device
    kernels.require(x, "x", torch.bfloat16)
    kernels.require(mask_in, "mask_in", torch.bool, (X, Z, Y), dev)
    kernels.require(mask_out, "mask_out", torch.bool, (X // 2, Z // 2, Y // 2), dev)
    if tuple(weight.shape) != (8, ci, co) or X % 2 or Z % 2 or Y % 2:
        raise ValueError(f"down2_fused: weight {tuple(weight.shape)}, x {tuple(x.shape)}")
    if ci % 32 or co % 64:
        raise ValueError(f"down2_fused needs Ci % 32 == 0 and Co % 64 == 0, got {ci}, {co}")
    f32 = dict(device=dev, dtype=torch.float32)
    w = weight.to(device=dev, dtype=torch.bfloat16).contiguous()
    vecs = [v.to(**f32).contiguous() for v in (bias, *bn1, *bn2)]
    if tiles is None:
        tiles = down_tiles(mask_out)
    out = torch.zeros((X // 2, Z // 2, Y // 2, co), dtype=torch.bfloat16, device=dev)
    err = kernels.lib().pasco_down2_fused(
        x.data_ptr(), mask_in.data_ptr(), mask_out.data_ptr(), w.data_ptr(),
        *(v.data_ptr() for v in vecs), out.data_ptr(), tiles.ids.data_ptr(),
        tiles.n_active.data_ptr(), X, Z, Y, ci, co, tiles.n_tiles,
        kernels.stream_ptr(x),
    )
    kernels.check(err, "down2_fused")
    kernels.LAUNCHES["down2_fused"] += 1
    return out
