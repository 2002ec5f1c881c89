"""Kernel 3: ``up_preamble``, the decoder stage preamble (replaces
``pasco_tpu/ops/pallas_deconv.py:up_preamble_padded``).

Per child cell ``c`` of parent ``p``:

    d   = leaky(a1 * ((parent * parent_keep)[p] @ wd[k(c)] + bd) + c1)
    xc  = [d, cell_coords(box, scale)[c] / scale]
    r   = (a2 * xc + c2) @ wr + br
    out = union[c] * (child[c] * r + skip[c])

A CPU tensor takes :func:`up_preamble_plain`; a CUDA tensor launches
``csrc/up_preamble.cu`` or raises.  The kernel note is at the top of the
CUDA source.  A batch of scans (volumes and masks with a leading ``B``, the
box corner ``[B, 3]``) is one launch; each scan's coordinates come from its
own corner.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from pasco_torch import kernels
from pasco_torch.core.sparse import Box
from pasco_torch.ops.conv import Tiles, _active_list
from pasco_torch.ops.dense_ops import cell_coords, deconv2_dense, maxpool2_mask

ROWS = 64    # parents per tile (kernel constant)
WIDTHS = ((128, 64), (256, 128), (256, 256))   # (Ci, Co) the kernel takes

Pair = Tuple[torch.Tensor, torch.Tensor]


def up_tiles(union_mask: torch.Tensor) -> Tiles:
    """Tiles of 64 flat parents with any child in the union mask (active
    first, their count on the device).  For a batch ``[B, X, Z, Y]`` the
    tiles are per scan: tile ``t`` of scan ``b`` has id ``b * n + t`` (``n``
    tiles a scan)."""
    *lead, X, Z, Y = union_mask.shape
    flat = maxpool2_mask(union_mask).reshape(*lead, -1)
    pad = (-flat.shape[-1]) % ROWS
    tiles = F.pad(flat.to(torch.uint8), (0, pad)).reshape(*lead, -1, ROWS).any(-1)
    return _active_list(tiles.reshape(-1))


def up_preamble_plain(parent, parent_keep, child_mask, union_mask, skip, box,
                      scale, wd, bd, bn_up: Pair, bn_resize: Pair, wr, br):
    """The same function in plain PyTorch (one product + depth-to-space,
    then the resize product), with the kernel's bf16 rounding points."""
    dt = parent.dtype
    zero = torch.zeros((), dtype=dt, device=parent.device)
    pm = torch.where(parent_keep[..., None], parent, zero)
    d = deconv2_dense(pm, wd, bd).float()
    d = F.leaky_relu(bn_up[0] * d + bn_up[1], 0.01).to(dt)
    coords = (cell_coords(box, scale).float() / scale).to(dt)
    if coords.dim() < d.dim():   # one box corner for the whole batch
        coords = coords.expand(*d.shape[:-1], 3)
    xc = torch.cat([d, coords], dim=-1).float()
    xc = (bn_resize[0] * xc + bn_resize[1]).to(dt).float()
    r = (xc @ wr.to(dt).float() + br.float()).to(dt).float()
    out = torch.where(child_mask[..., None], r, torch.zeros((), device=r.device))
    out = out + skip.float()
    return torch.where(union_mask[..., None], out,
                       torch.zeros((), device=out.device)).to(dt)


def up_preamble(
    parent: torch.Tensor,        # [X2, Z2, Y2, Ci] or [B, X2, Z2, Y2, Ci]
    parent_keep: torch.Tensor,   # [..., X2, Z2, Y2] bool
    child_mask: torch.Tensor,    # [..., X, Z, Y] bool generated children
    union_mask: torch.Tensor,    # [..., X, Z, Y] bool  child | skip_mask
    skip: torch.Tensor,          # [..., X, Z, Y, Co] encoder features
    box: Box,                    # minimum [3], or [B, 3] for a batch
    scale: int,
    wd: torch.Tensor,            # [8, Ci, Co]
    bd: torch.Tensor,            # [Co]
    bn_up: Pair,                 # (a, c) [Co] f32
    bn_resize: Pair,             # (a, c) [Co + 3] f32
    wr: torch.Tensor,            # [Co + 3, Co]
    br: torch.Tensor,            # [Co]
    tiles: Optional[Tiles] = None,   # from up_tiles(union_mask)
) -> torch.Tensor:
    if not parent.is_cuda:
        return up_preamble_plain(parent, parent_keep, child_mask, union_mask,
                                 skip, box, scale, wd, bd, bn_up, bn_resize,
                                 wr, br)
    if parent.dim() not in (4, 5):
        raise ValueError(f"up_preamble takes [X2, Z2, Y2, C] or [B, X2, Z2, Y2, C], got "
                         f"{tuple(parent.shape)}")
    *lead, X2, Z2, Y2, ci = parent.shape
    B = lead[0] if lead else 1
    co = wd.shape[-1]
    dev = parent.device
    X, Z, Y = 2 * X2, 2 * Z2, 2 * Y2
    kernels.require(parent, "parent", torch.bfloat16)
    kernels.require(parent_keep, "parent_keep", torch.bool, (*lead, X2, Z2, Y2), dev)
    kernels.require(child_mask, "child_mask", torch.bool, (*lead, X, Z, Y), dev)
    kernels.require(union_mask, "union_mask", torch.bool, (*lead, X, Z, Y), dev)
    kernels.require(skip, "skip", torch.bfloat16, (*lead, X, Z, Y, co), dev)
    if tuple(wd.shape) != (8, ci, co) or tuple(wr.shape) != (co + 3, co):
        raise ValueError(f"up_preamble: wd {tuple(wd.shape)}, wr {tuple(wr.shape)}")
    if (ci, co) not in WIDTHS:
        raise ValueError(f"up_preamble takes (Ci, Co) in {WIDTHS}, got {(ci, co)}")
    f32 = dict(device=dev, dtype=torch.float32)
    wd16, wr16 = (w.to(device=dev, dtype=torch.bfloat16).contiguous() for w in (wd, wr))
    bd32, a1, c1, a2, c2, br32 = (
        v.to(**f32).contiguous()
        for v in (bd, *bn_up, *bn_resize, br)
    )
    # one corner per scan: [B, 3] (a [3] corner is shared by every scan)
    box_min = box.minimum.to(device=dev, dtype=torch.int32).expand(B, 3).contiguous()
    if tiles is None:
        tiles = up_tiles(union_mask)
    if tiles.n_tiles != B * -(-(X2 * Z2 * Y2) // ROWS):
        raise ValueError(f"up_preamble: {tiles.n_tiles} tiles for {B} x {X2 * Z2 * Y2} "
                         f"parents")
    out = torch.empty((*lead, X, Z, Y, co), dtype=torch.bfloat16, device=dev)
    err = kernels.lib().pasco_up_preamble(
        parent.data_ptr(), parent_keep.data_ptr(), child_mask.data_ptr(),
        union_mask.data_ptr(), skip.data_ptr(), wd16.data_ptr(),
        bd32.data_ptr(), a1.data_ptr(), c1.data_ptr(), a2.data_ptr(),
        c2.data_ptr(), wr16.data_ptr(), br32.data_ptr(), box_min.data_ptr(),
        out.data_ptr(), tiles.ids.data_ptr(), tiles.n_active.data_ptr(),
        B, X2, Z2, Y2, ci, co, scale, tiles.n_tiles, kernels.stream_ptr(parent),
    )
    kernels.check(err, "up_preamble")
    kernels.LAUNCHES["up_preamble"] += 1
    return out
