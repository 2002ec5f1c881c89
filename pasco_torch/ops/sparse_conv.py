"""Sparse 3D convolutions as gather-matmul-scatter on padded voxel sets
(counterpart of ``pasco_tpu/ops/sparse_conv.py``).

A conv's "rulebook" (MinkowskiEngine's kernel map) holds, per kernel
offset ``k`` and output row ``n``, the input row to gather and whether it
exists.  It is built from a dense cell -> row table over the working box
(one scatter, then one gather per offset: no sort, no host sync) and is
shared by every conv on the same coordinates.  The reference runs these
convs as XLA gathers and ``jnp.dot`` with no Pallas kernel, so the port
runs them as PyTorch gathers and matmuls (:class:`RulebookConvFn`); a
hand-written gather-GEMM-scatter for Hopper is later work.

Products follow the reference's ``preferred_element_type=float32``: the
operands are rounded to the compute dtype and multiplied in f32 (exact for
bf16 operands, also under TF32), and the taps are summed nine at a time
into an f32 accumulator, as the reference groups them (``:121-136``).

Weight layouts: ``[K, Cin, Cout]`` with the offsets ordered by
:func:`kernel_offsets` (x-major, z-fastest).

Tracing (:mod:`pasco_torch.utils.timing`): every kernel map
(:func:`build_rulebook`, and :func:`strided_conv3d`'s unique and map) is a
``pasco.sparse.rulebook`` span, and each gather-GEMM-scatter conv
(:func:`conv_with_rulebook`, :func:`strided_conv3d`,
:func:`generative_deconv3d`) a ``pasco.sparse.conv`` span that adds its
found (tap, row) pairs to ``sparse_conv.pairs`` and the rows times taps it
computes to ``sparse_conv.rows``: their ratio is the padding's share.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional

import numpy as np
import torch

from pasco_torch.core.sparse import (
    INVALID_KEY, Box, SparseGrid, build_dense_table, linear_keys, lookup_dense_table,
    unique, where_valid)
from pasco_torch.utils import timing


class Rulebook(NamedTuple):
    """Kernel map of one coordinate set."""

    rows: torch.Tensor    # [K, N] int32 gather row (0 where absent)
    found: torch.Tensor   # [K, N] bool


def kernel_offsets(kernel_size: int) -> np.ndarray:
    """``[K, 3]`` offsets in stride units: centred for odd kernels
    (``{-1, 0, 1}^3`` at 3), forward for even ones (``{0, 1}^3`` at 2)."""
    if kernel_size % 2 == 1:
        r = kernel_size // 2
        rng = range(-r, r + 1)
    else:
        rng = range(kernel_size)
    return np.array(list(itertools.product(rng, rng, rng)), dtype=np.int32)


def _offsets(kernel_size: int, scale: int, device) -> torch.Tensor:
    """:func:`kernel_offsets` times ``scale`` as an int32 ``[K, 3]`` tensor
    made on ``device`` (no copy from the host, which would wait for it)."""
    lo = -(kernel_size // 2) if kernel_size % 2 else 0
    r = torch.arange(lo, lo + kernel_size, dtype=torch.int32, device=device)
    return torch.cartesian_prod(r, r, r).reshape(-1, 3) * scale


def lookup_offsets(table: torch.Tensor, coords: torch.Tensor, mask: torch.Tensor,
                    box: Box, stride: int, kernel_size: int, dilation: int = 1) -> Rulebook:
    """:func:`lookup_dense_table` of ``coords + offset * dilation * stride``
    for every offset of the kernel at once (``[K, N]``)."""
    off = _offsets(kernel_size, dilation * stride, coords.device)
    q = coords[None].repeat(off.shape[0], 1, 1)
    q[..., 0] = 0
    q[..., 1:] += off[:, None, :]
    keys = linear_keys(q, mask[None].expand(off.shape[0], -1), box, stride)
    row = table[keys.long().clamp(0, table.shape[0] - 1)]
    found = (keys != INVALID_KEY) & (row >= 0)
    return Rulebook(torch.where(found, row, torch.zeros_like(row)), found)


def build_rulebook(coords: torch.Tensor, mask: torch.Tensor, box: Box, stride: int,
                   kernel_size: int) -> Rulebook:
    """Rulebook of a submanifold conv (output coords == input coords); the
    centre tap is every row itself.  Span ``pasco.sparse.rulebook``."""
    with timing.span("sparse.rulebook"):
        table = build_dense_table(coords, mask, box, stride)
        rb = lookup_offsets(table, coords, mask, box, stride, kernel_size)
        if kernel_size % 2:
            centre = kernel_size ** 3 // 2
            rb.rows[centre] = torch.arange(coords.shape[0], dtype=rb.rows.dtype,
                                           device=coords.device)
            rb.found[centre] = mask
        return rb


def _gather_index(rb: Rulebook, n_in: int) -> torch.Tensor:
    """``[n_out, K]`` gather rows with the absent ones at ``n_in`` (a zero
    row appended to the input)."""
    return torch.where(rb.found, rb.rows.long(), n_in).T


def _tap_groups(k: int):
    group = 9 if k % 9 == 0 else (k if k <= 9 else 1)
    return [(g, g + group) for g in range(0, k, group)]


class RulebookConvFn(torch.autograd.Function):
    """``out[n] = sum_k x[idx[n, k]] @ w[k]`` in f32 (``[n_out, Cout]``),
    ``idx`` ``[n_out, K]`` with ``n_in`` for an absent neighbour.  Saves
    only ``x``, ``idx`` and ``w``: the backward gathers again
    (``dW_k = gather(x)^T @ dY``) and scatter-adds ``dX`` from
    ``dY @ W_k^T``, so a training conv keeps no ``[K, N, Cin]`` copy."""

    @staticmethod
    def forward(ctx, x, idx, w):
        ctx.save_for_backward(x, idx, w)
        n_out = idx.shape[0]
        _, cin, cout = w.shape
        xp = torch.cat([x, x.new_zeros(1, cin)]).float()
        out = torch.zeros((n_out, cout), dtype=torch.float32, device=x.device)
        for g0, g1 in _tap_groups(w.shape[0]):
            taps = xp[idx[:, g0:g1]].reshape(n_out, -1)
            out += taps @ w[g0:g1].float().reshape(-1, cout)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, idx, w = ctx.saved_tensors
        n_out = idx.shape[0]
        _, cin, cout = w.shape
        dy = dy.float()
        xp = torch.cat([x, x.new_zeros(1, cin)]).float()
        dxp = torch.zeros_like(xp) if ctx.needs_input_grad[0] else None
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for g0, g1 in _tap_groups(w.shape[0]):
            wg = w[g0:g1].float().reshape(-1, cout)
            if dxp is not None:
                dxp.index_add_(0, idx[:, g0:g1].reshape(-1), (dy @ wg.T).reshape(-1, cin))
            if ctx.needs_input_grad[2]:
                taps = xp[idx[:, g0:g1]].reshape(n_out, -1)
                dw[g0:g1] = (taps.T @ dy).reshape(g1 - g0, cin, cout)
        return (None if dxp is None else dxp[:-1].to(x.dtype), None, dw.to(w.dtype))


def _count_work(found: torch.Tensor, rows: int, scale: int = 1) -> None:
    """The counters of one conv where tracing is on: ``sparse_conv.pairs``,
    the found (tap, row) pairs (``found``'s set entries, times ``scale``),
    the useful work; ``sparse_conv.rows``, the rows times taps it computes,
    padding included."""
    if timing.enabled():
        timing.count("sparse_conv.pairs", found.sum(), scale)
        timing.count("sparse_conv.rows", rows)


def _rulebook_conv(feats, rb: Rulebook, weight, bias, compute_dtype) -> torch.Tensor:
    cd = compute_dtype or feats.dtype
    _count_work(rb.found, rb.found.numel())
    out = RulebookConvFn.apply(feats.to(cd), _gather_index(rb, feats.shape[0]),
                               weight.to(cd))
    return out if bias is None else out + bias


def conv_with_rulebook(feats: torch.Tensor, rb: Rulebook, weight: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Sparse conv of ``feats [N_in, Cin]`` (masked) over ``rb``; f32
    ``[N_out, Cout]`` (``N_out`` is the rulebook's row count).  Span
    ``pasco.sparse.conv``."""
    with timing.span("sparse.conv"):
        return _rulebook_conv(feats, rb, weight, bias, compute_dtype)


def _dot_f32(x: torch.Tensor, w: torch.Tensor, cd) -> torch.Tensor:
    """``jnp.dot(x.astype(cd), w.astype(cd), preferred_element_type=f32)``."""
    return x.to(cd).float() @ w.to(cd).float()


def submanifold_conv3d(grid: SparseGrid, box: Box, weight: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       compute_dtype: Optional[torch.dtype] = None,
                       rulebook: Optional[Rulebook] = None) -> SparseGrid:
    """Stride-1 sparse conv (output coords == input coords); ``weight``
    ``[ks^3, Cin, Cout]``.  Pass ``rulebook`` to share the neighbour lookup
    of every conv on the same coordinates."""
    ks = round(weight.shape[0] ** (1.0 / 3.0))
    assert ks ** 3 == weight.shape[0], weight.shape
    cd = compute_dtype or grid.feats.dtype
    if ks == 1:
        out = _dot_f32(grid.masked_feats(), weight[0], cd)
        if bias is not None:
            out = out + bias
    else:
        if rulebook is None:
            rulebook = build_rulebook(grid.coords, grid.mask, box, grid.stride, ks)
        out = conv_with_rulebook(grid.masked_feats(), rulebook, weight, bias, cd)
    return grid.with_feats(where_valid(grid.mask, out).to(grid.feats.dtype))


def strided_conv3d(grid: SparseGrid, box: Box, weight: torch.Tensor, out_capacity: int,
                   bias: Optional[torch.Tensor] = None,
                   compute_dtype: Optional[torch.dtype] = None) -> SparseGrid:
    """Kernel-2 stride-2 down conv: the outputs are the unique parents
    ``floor(c / 2s) * 2s``, each gathering its up to 8 children.  Its
    unique and kernel map are a ``pasco.sparse.rulebook`` span, its
    gather-GEMM-scatter a ``pasco.sparse.conv`` span."""
    assert weight.shape[0] == 8, "strided_conv3d implements ks=2, stride=2"
    in_stride = grid.stride
    out_stride = in_stride * 2
    with timing.span("sparse.rulebook"):
        parent_xyz = torch.div(grid.coords[:, 1:], out_stride,
                               rounding_mode="floor") * out_stride
        parents = torch.cat([grid.coords[:, :1], parent_xyz], -1)
        out_coords, out_mask, _, _ = unique(parents, grid.mask, box, out_stride, out_capacity)
        table = build_dense_table(grid.coords, grid.mask, box, in_stride)
        rb = lookup_offsets(table, out_coords, out_mask, box, in_stride, 2)
    with timing.span("sparse.conv"):
        out = _rulebook_conv(grid.masked_feats(), rb, weight, None, compute_dtype)
        if bias is not None:
            out = out + bias
        out = where_valid(out_mask, out).to(grid.feats.dtype)
    return SparseGrid(out_coords, out, out_mask, out_stride)


def generative_deconv3d(grid: SparseGrid, weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        compute_dtype: Optional[torch.dtype] = None) -> SparseGrid:
    """Kernel-2 stride-2 generative transposed conv: each row emits its 8
    children at ``c + offset * stride / 2`` (one ``[N, Cin] @ [Cin,
    8 Cout]`` product); the output has ``8 N`` rows.  Span
    ``pasco.sparse.conv``; its pairs are the valid rows' 8 children."""
    assert weight.shape[0] == 8
    assert grid.stride % 2 == 0, "cannot upsample below stride 1"
    out_stride = grid.stride // 2
    n, c_in = grid.feats.shape
    c_out = weight.shape[-1]
    cd = compute_dtype or grid.feats.dtype
    with timing.span("sparse.conv"):
        _count_work(grid.mask, 8 * n, 8)
        w = weight.to(cd).permute(1, 0, 2).reshape(c_in, 8 * c_out)
        out = _dot_f32(grid.masked_feats(), w, cd).reshape(n, 8, c_out)
        if bias is not None:
            out = out + bias
        offsets = _offsets(2, out_stride, grid.coords.device)
        child_xyz = grid.coords[:, None, 1:] + offsets[None]
        child_b = grid.coords[:, None, :1].expand(n, 8, 1)
        out_coords = torch.cat([child_b, child_xyz], -1).reshape(n * 8, 4)
        out_mask = grid.mask[:, None].expand(n, 8).reshape(n * 8)
        out = where_valid(out_mask, out.reshape(n * 8, c_out))
        return SparseGrid(out_coords, out.to(grid.feats.dtype), out_mask, out_stride)


def sparse_max_pool(grid: SparseGrid, factor: int, box: Box, out_capacity: int) -> SparseGrid:
    """Non-overlapping max pooling, kernel = stride = ``factor``."""
    out_stride = grid.stride * factor
    parent_xyz = torch.div(grid.coords[:, 1:], out_stride, rounding_mode="floor") * out_stride
    parents = torch.cat([grid.coords[:, :1], parent_xyz], -1)
    out_coords, out_mask, _, out_feats = unique(
        parents, grid.mask, box, out_stride, out_capacity, feats=grid.masked_feats(),
        reduce="max")
    return SparseGrid(out_coords, out_feats.to(grid.feats.dtype), out_mask, out_stride)


def lookup_features(src: SparseGrid, query_coords: torch.Tensor, query_mask: torch.Tensor,
                    box: Box):
    """``(feats [Nq, C], found [Nq])``: ``src``'s features at the query
    coords (same stride), zero where missing."""
    table = build_dense_table(src.coords, src.mask, box, src.stride)
    row, found = lookup_dense_table(table, query_coords, query_mask, box, src.stride)
    return where_valid(found, src.feats[row.long()]), found
