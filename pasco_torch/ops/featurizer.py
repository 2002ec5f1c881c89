"""Kernel 8: ``featurizer_fused``, the point featurizer and the ``enc_in``
1x1 in one pass (replaces ``pasco_tpu/ops/pallas_featurizer.py:
featurizer_fused`` and its Pallas body ``_featurizer_kernel``).

From the point MLP's features ``f [P, F]``, their in-box voxel coordinates
``rel [P, 3]`` (x, y, z), the validity ``in_box [P]``, the logical
``enc_in`` weight ``[F, C]`` and bias ``[C]``, it returns on the port's
layout

    x   [X, Z, Y, C]  enc_in(max over the cell's points) + b at occupied
                      cells, exact zeros elsewhere, in ``compute_dtype``;
    occ [X, Z, Y]     bool, any valid point in the cell.

S == 1 only, as the TPU kernel is.  The TPU kernel's padded, z-pair-packed
``xpad``, its int8 lane-expanded stage mask and its y halo are TPU layout
and are not reproduced.  The entry keeps the reference's structure: the key
sort is index preparation outside the kernel (:func:`sort_points`; XLA's
argsort in the reference); one kernel then writes every cell of ``x`` and
``occ`` once: the max over each occupied cell's points read through the
sort's permutation, the occupancy, the 1x1 with ``W`` held in shared
memory plus the bias, and exact zeros at the empty cells.

A CPU tensor takes :func:`featurizer_fused_plain`, the model's own
featurizer chain (:func:`scatter_points` + the masked 1x1); a CUDA tensor
launches ``csrc/featurizer.cu`` or raises.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from pasco_torch import kernels
from pasco_torch.ops.dense_ops import scatter_max_rows
from pasco_torch.utils import timing

NEG = -1e30   # finite featurizer sentinel (pasco_tpu/models/dense_unet.py:1137-1145)
Extent = Tuple[int, int, int]


def cell_index(rel: torch.Tensor, extent: Extent) -> torch.Tensor:
    """Flat ``[X, Z, Y]`` cell index of in-box voxel coords ``rel`` (x, y, z)."""
    _, ey, ez = extent
    return torch.add(rel[:, 1], torch.add(rel[:, 2], rel[:, 0], alpha=ez), alpha=ey)


def scatter_points(f: torch.Tensor, rel: torch.Tensor, in_box: torch.Tensor,
                   subnet: torch.Tensor, n_subnets: int, extent: Extent,
                   dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel max of the points of each (cell, subnet) into ``[X, Z, Y,
    S * F]`` in ``dtype`` (subnet ``s`` in lane block ``s``, the ``enc_in``
    input order of ``pasco_tpu/models/dense_unet.py:1202-1216``) with every
    empty (cell, subnet) row zero, and the per-row occupancy
    ``[X, Z, Y, S]``.  Points with a leading batch axis (``f [B, P, F]``,
    ``rel [B, P, 3]``, ...) fill one volume per scan: ``[B, X, Z, Y, ...]``."""
    ex, ey, ez = extent
    S = n_subnets
    lead = f.shape[:-2]
    n_scan = ex * ey * ez * S              # rows of one scan
    n_rows = n_scan * math.prod(lead)
    first = torch.arange(math.prod(lead), dtype=rel.dtype, device=f.device) * n_scan
    row = cell_index(rel.reshape(-1, 3), extent).reshape(rel.shape[:-1]) * S + subnet
    row = row + first.reshape(*lead, 1)
    flat_idx = torch.where(in_box, row, torch.full_like(row, n_rows))
    grid_f = scatter_max_rows(f.reshape(-1, f.shape[-1]).to(dtype), flat_idx.reshape(-1),
                              n_rows, NEG)[:-1]
    occ = grid_f.amax(-1) > torch.tensor(NEG, dtype=dtype)
    x = torch.where(occ[:, None], grid_f, torch.zeros((), dtype=dtype, device=f.device))
    return (x.reshape(*lead, ex, ez, ey, S * f.shape[-1]),
            occ.reshape(*lead, ex, ez, ey, S))


def enc_in_1x1(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """The model's ``enc_in``: ``x @ W + b`` in ``x``'s dtype, zero where
    ``mask`` is False."""
    dt = x.dtype
    y = x.reshape(-1, x.shape[-1]) @ weight.to(dt) + bias.to(dt)
    y = torch.where(mask.reshape(-1, 1), y, torch.zeros((), dtype=dt, device=x.device))
    return y.reshape(*x.shape[:-1], -1)


def featurizer_fused_plain(f, rel, in_box, weight, bias, extent: Extent,
                           compute_dtype: torch.dtype):
    """The same function in plain PyTorch: the model's featurizer chain
    at S == 1."""
    x, occ = scatter_points(f, rel, in_box, torch.zeros_like(rel[:, 0]), 1, extent,
                            compute_dtype)
    occ = occ[..., 0]
    return enc_in_1x1(x, occ, weight, bias), occ


def sort_points(rel: torch.Tensor, in_box: torch.Tensor, extent: Extent):
    """Index preparation of the kernel (XLA's argsort in the reference):
    the int32 flat cell keys of the points sorted ascending, invalid points
    last with key ``n_cells``, and the sort's permutation (``ks[i]`` is the
    key of point ``order[i]``)."""
    ex, ey, ez = extent
    key = torch.where(in_box, cell_index(rel.to(torch.int32), extent), ex * ey * ez)
    return torch.sort(key.to(torch.int32))


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def featurizer_fused(
    f: torch.Tensor,            # [P, F] point MLP features, f32 or bf16
    rel: torch.Tensor,          # [P, 3] int in-box voxel coords (x, y, z)
    in_box: torch.Tensor,       # [P] bool valid and inside the box
    weight: torch.Tensor,       # [F, C] enc_in weight
    bias: torch.Tensor,         # [C] enc_in bias
    extent: Extent,             # (ex, ey, ez) working box
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if not f.is_cuda:
        return featurizer_fused_plain(f, rel, in_box, weight, bias, extent, compute_dtype)
    with timing.span("kernel.featurizer", events=False):
        P, Fd = f.shape
        C = weight.shape[-1]
        dev = f.device
        ex, ey, ez = extent
        n_cells = ex * ey * ez
        if compute_dtype not in _DTYPES or f.dtype not in _DTYPES:
            raise ValueError(f"featurizer_fused takes f32 or bf16 features and computes in f32 "
                             f"or bf16, not {f.dtype} and {compute_dtype}")
        kernels.require(in_box, "in_box", torch.bool, (P,), dev)
        if (tuple(rel.shape) != (P, 3) or tuple(weight.shape) != (Fd, C)
                or tuple(bias.shape) != (C,)):
            raise ValueError(f"shapes rel {tuple(rel.shape)}, weight {tuple(weight.shape)}, "
                             f"bias {tuple(bias.shape)} do not fit f {tuple(f.shape)}")
        if Fd not in (8, 16, 32, 64, 128) or C not in (32, 64, 128, 256):
            raise ValueError(f"featurizer_fused takes F in 8, 16, .., 128 and C in 32, 64, 128, "
                             f"256, got F={Fd}, C={C}")
        if not 0 < n_cells < 1 << 31:
            raise ValueError(f"featurizer_fused takes 1 to 2^31 - 1 cells, got {n_cells}")
        ks, order = sort_points(rel, in_box, extent)
        f = f.contiguous()
        if f.data_ptr() % 16:                  # the kernel reads rows with 16-byte loads
            f = f.clone()
        # rounded to compute_dtype by the kernel as it stages them
        w = weight.to(device=dev, dtype=torch.float32).contiguous()
        b = bias.to(device=dev, dtype=torch.float32).contiguous()
        x = torch.empty((ex, ez, ey, C), dtype=compute_dtype, device=dev)
        occ = torch.empty((ex, ez, ey), dtype=torch.bool, device=dev)
        err = kernels.lib().pasco_featurizer(
            f.data_ptr(), order.data_ptr(), ks.data_ptr(), w.data_ptr(), b.data_ptr(),
            x.data_ptr(), occ.data_ptr(), P, Fd, C, n_cells, _DTYPES[f.dtype],
            _DTYPES[compute_dtype], kernels.stream_ptr(f))
        kernels.check(err, "featurizer")
    kernels.LAUNCHES["featurizer"] += 1
    return x, occ
