"""Padded sparse voxel containers (counterpart of ``pasco_tpu/core/sparse.py``).

A :class:`SparseGrid` is a static-capacity voxel set: ``coords`` int32
``[N, 4]`` rows of ``(batch, x, y, z)`` in stride-1 units, ``feats``
``[N, C]`` and a validity ``mask`` ``[N]``.  A :class:`Box` is the working
volume: a device ``[3]`` int32 minimum corner and a static extent.

A batch of ``B`` scans (the reference's ``jax.vmap`` of the forward) shares
the static extent and carries one corner per scan: ``minimum`` ``[B, 3]``.
Grids then carry the batch in front (``coords [B, ..., N, 4]``), and the
table helpers below key each row by its scan's own corner.

The rest of the module is the sparse substrate's (``substrate="sparse"``):
compaction, top-k compaction, deduplication, dense <-> sparse and pooling
on one unbatched grid ``[N, 4]``.  Every count stays on the device (prefix
sums and scatters into static capacities), so none of them waits for the
card.  Scatters follow JAX's ``.at[idx]`` with ``mode="drop"``: a negative
index wraps once, and an index still outside the array after that is
dropped (:func:`_drop_index` routes it to a dump row that is sliced off).
Gathers follow JAX's default: a negative index wraps once, then the index
is clamped (:func:`_clip_index`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

INVALID_KEY = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class Box:
    minimum: torch.Tensor            # [3] or [B, 3] int32 (stride-1 voxel units)
    extent: Tuple[int, int, int]     # static stride-1 extent

    @staticmethod
    def create(minimum: torch.Tensor, extent) -> "Box":
        return Box(minimum.to(torch.int32), tuple(int(e) for e in extent))

    def extent_at(self, stride: int) -> Tuple[int, int, int]:
        return tuple(-(-e // stride) for e in self.extent)


@dataclasses.dataclass(frozen=True)
class SparseGrid:
    coords: torch.Tensor   # [..., N, 4] int32
    feats: torch.Tensor    # [..., N, C]
    mask: torch.Tensor     # [..., N] bool
    stride: int = 1

    @property
    def capacity(self) -> int:
        return self.coords.shape[-2]

    @property
    def num_channels(self) -> int:
        return self.feats.shape[-1]

    def subnet(self, s: int) -> "SparseGrid":
        """Row ``s`` of a subnet-stacked grid."""
        return SparseGrid(self.coords[s], self.feats[s], self.mask[s], self.stride)

    def count(self) -> torch.Tensor:
        return self.mask.sum(dtype=torch.int32)

    def replace(self, **changes) -> "SparseGrid":
        return dataclasses.replace(self, **changes)

    def with_feats(self, feats: torch.Tensor) -> "SparseGrid":
        return self.replace(feats=feats)

    def masked_feats(self) -> torch.Tensor:
        return where_valid(self.mask, self.feats)


def make_grid(coords, feats, mask=None, stride: int = 1) -> SparseGrid:
    coords = torch.as_tensor(coords).to(torch.int32)
    feats = torch.as_tensor(feats)
    if mask is None:
        mask = torch.ones(coords.shape[0], dtype=torch.bool, device=coords.device)
    return SparseGrid(coords, feats, mask, stride)


def where_valid(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x [..., N, C]`` with the rows where ``mask [..., N]`` is False zeroed."""
    return torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))


def _drop_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """JAX's scatter index with ``mode="drop"`` into an axis of ``size``:
    negatives wrap once, what is still outside ``[0, size)`` goes to the
    dump index ``size``."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + size, idx)
    return torch.where((idx >= 0) & (idx < size), idx, torch.full_like(idx, size))


def _clip_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """JAX's default gather index into an axis of ``size``: negatives wrap
    once, then clamp."""
    idx = idx.long()
    return torch.where(idx < 0, idx + size, idx).clamp(0, size - 1)


def stack_grids(grids, dim: int = 0) -> SparseGrid:
    return SparseGrid(
        torch.stack([g.coords for g in grids], dim),
        torch.stack([g.feats for g in grids], dim),
        torch.stack([g.mask for g in grids], dim),
        grids[0].stride,
    )


def linear_keys(coords: torch.Tensor, mask: torch.Tensor, box: Box,
                stride: int) -> torch.Tensor:
    """``(b, x, y, z)`` rows ``[..., N, 4]`` -> int32 keys inside ``box``
    (a ``[B, 3]`` corner applies row ``b`` of it to the rows ``[b, ..., N]``);
    outside or masked rows get :data:`INVALID_KEY`."""
    ex, ey, ez = box.extent_at(stride)
    rel = torch.div(coords[..., 1:] - box.minimum[..., None, :], stride,
                    rounding_mode="floor")
    in_box = (
        (rel[..., 0] >= 0) & (rel[..., 0] < ex)
        & (rel[..., 1] >= 0) & (rel[..., 1] < ey)
        & (rel[..., 2] >= 0) & (rel[..., 2] < ez)
        & mask
    )
    key = ((coords[..., 0] * ex + rel[..., 0]) * ey + rel[..., 1]) * ez + rel[..., 2]
    return torch.where(in_box, key, torch.full_like(key, INVALID_KEY))


def _element_keys(coords: torch.Tensor, mask: torch.Tensor, box: Box,
                  stride: int) -> torch.Tensor:
    """:func:`linear_keys` with the batch column replaced by the row's
    element (its index over the leading axes: 0 for one ``[N, 4]`` grid)."""
    c0 = coords.clone()
    lead = coords.shape[:-2]
    elem = torch.arange(math.prod(lead), dtype=coords.dtype, device=coords.device)
    c0[..., 0] = elem.reshape(*lead, 1)
    return linear_keys(c0, mask, box, stride)


def build_dense_table(coords: torch.Tensor, mask: torch.Tensor, box: Box,
                      stride: int) -> torch.Tensor:
    """cell -> row table (``-1`` = empty) of one grid ``[N, 4]``, or of each
    grid of ``[..., N, 4]`` one after another (rows counted within the
    grid); the batch column is ignored."""
    ex, ey, ez = box.extent_at(stride)
    n_cells = ex * ey * ez * math.prod(coords.shape[:-2])
    keys = _element_keys(coords, mask, box, stride).long().reshape(-1)
    safe = torch.where(keys == INVALID_KEY, torch.full_like(keys, n_cells), keys)
    table = torch.full((n_cells + 1,), -1, dtype=torch.int32,
                       device=coords.device)
    n = coords.shape[-2]
    table[safe] = torch.arange(n, dtype=torch.int32, device=coords.device).repeat(
        keys.numel() // n)
    return table[:n_cells]


def lookup_dense_table(table: torch.Tensor, query_coords: torch.Tensor,
                       query_mask: torch.Tensor, box: Box, stride: int):
    """(row, found) for each query coordinate via the dense table (each
    grid of ``[..., N, 4]`` queries its own)."""
    keys = _element_keys(query_coords, query_mask, box, stride)
    safe = keys.long().clamp(0, table.shape[0] - 1)
    row = table[safe]
    found = (keys != INVALID_KEY) & (row >= 0)
    return torch.where(found, row, torch.zeros_like(row)), found


# ---------------------------------------------------------------------------
# Sorted-key tables (``pasco_tpu/core/sparse.py:141-166``)
# ---------------------------------------------------------------------------


def build_table(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sorted_keys, perm)`` with ``sorted_keys = keys[perm]``; a stable
    sort, as ``jnp.argsort``."""
    perm = torch.argsort(keys, stable=True)
    return keys[perm], perm


def lookup(sorted_keys: torch.Tensor, perm: torch.Tensor, query_keys: torch.Tensor):
    """``(row, found)`` of each query key: ``row`` indexes the unsorted
    array, 0 where the key is missing."""
    pos = torch.searchsorted(sorted_keys, query_keys).clamp(0, sorted_keys.shape[0] - 1)
    found = (sorted_keys[pos] == query_keys) & (query_keys != INVALID_KEY)
    return torch.where(found, perm[pos], torch.zeros_like(perm[pos])), found


# ---------------------------------------------------------------------------
# Compaction / pruning (``pasco_tpu/core/sparse.py:221-290``)
# ---------------------------------------------------------------------------


def compact(grid: SparseGrid, keep: torch.Tensor, capacity: int) -> SparseGrid:
    """The ``keep & mask`` rows packed to the front in their order, at most
    ``capacity`` of them (the surplus, highest index first, is dropped):
    a prefix sum and a scatter of row indices, no sort."""
    keep = keep & grid.mask
    n = grid.capacity
    dev = keep.device
    new_pos = torch.cumsum(keep.int(), 0) - 1
    total = new_pos[-1] + 1
    dest = torch.where(keep & (new_pos < capacity), new_pos, capacity)
    src = torch.zeros(capacity + 1, dtype=torch.long, device=dev)
    src[dest] = torch.arange(n, device=dev)
    src = src[:capacity]
    new_mask = torch.arange(capacity, device=dev) < total.clamp(max=capacity)
    return SparseGrid(where_valid(new_mask, grid.coords[src]),
                      where_valid(new_mask, grid.feats[src]), new_mask, grid.stride)


def top_k_compact(grid: SparseGrid, scores: torch.Tensor, keep: torch.Tensor,
                  capacity: int) -> SparseGrid:
    """At most ``capacity`` of the ``keep & mask`` rows, highest score
    first (ties in row order: a stable sort of ``-score``, as the
    reference's ``jnp.argsort``).  The rows that lose keep their coords and
    features with ``mask=False``."""
    keep = keep & grid.mask
    ranked = torch.where(keep, scores, torch.full((), -float("inf"), dtype=scores.dtype,
                                                  device=scores.device))
    order = torch.argsort(-ranked, stable=True)[:capacity]
    return SparseGrid(grid.coords[order], grid.feats[order], keep[order], grid.stride)


def prune_outside_box(grid: SparseGrid, min_c: torch.Tensor, max_c: torch.Tensor) -> SparseGrid:
    """Mask off the rows outside ``[min_c, max_c]`` (inclusive), in place on
    the mask."""
    c = grid.coords[:, 1:]
    inside = ((c >= min_c[None, :]) & (c <= max_c[None, :])).all(-1)
    return grid.replace(mask=grid.mask & inside)


# ---------------------------------------------------------------------------
# Deduplication (``pasco_tpu/core/sparse.py:298-386``)
# ---------------------------------------------------------------------------


def unique(coords: torch.Tensor, mask: torch.Tensor, box: Box, stride: int, capacity: int,
           feats: Optional[torch.Tensor] = None, reduce: str = "max", max_batch: int = 1):
    """Deduplicate ``(b, x, y, z)`` rows without a sort.  Returns
    ``(unique_coords [capacity, 4], unique_mask [capacity], seg_ids [N],
    out_feats or None)``: unique cells in first-occurrence order (a dense
    cell table elects each cell's first row by scatter-min), ``seg_ids[i]``
    the output row of input ``i`` (``capacity`` where dropped or invalid),
    and the features reduced per cell by ``max`` (empty or non-finite -> 0),
    ``sum`` or ``mean``.  ``max_batch`` bounds the batch column (the table
    is ``max_batch * prod(extent_at(stride))`` cells)."""
    n = coords.shape[0]
    dev = coords.device
    keys = linear_keys(coords, mask, box, stride).long()
    ex, ey, ez = box.extent_at(stride)
    n_cells = max_batch * ex * ey * ez
    valid = keys != INVALID_KEY
    safe = torch.where(valid, keys, n_cells)
    ar = torch.arange(n, device=dev)

    rep = torch.full((n_cells + 2,), n, dtype=torch.long, device=dev)
    rep.scatter_reduce_(0, _drop_index(safe, n_cells + 1), ar, reduce="amin")
    is_first = valid & (rep[safe.clamp(0, n_cells)] == ar)
    order_id = torch.cumsum(is_first.int(), 0) - 1
    n_unique = is_first.sum()

    seg_table = torch.zeros(n_cells + 2, dtype=torch.long, device=dev)
    seg_table[_drop_index(torch.where(is_first, safe, n_cells), n_cells + 1)] = torch.where(
        order_id < capacity, order_id, capacity)
    seg_ids = torch.where(valid, seg_table[safe.clamp(0, n_cells)], capacity)

    dest = torch.where(is_first & (order_id < capacity), order_id, capacity)
    unique_coords = torch.zeros((capacity + 1, 4), dtype=torch.int32, device=dev)
    unique_coords[dest] = coords.to(torch.int32)
    unique_coords = unique_coords[:capacity]
    unique_mask = torch.arange(capacity, device=dev) < n_unique.clamp(max=capacity)

    out_feats = None
    if feats is not None:
        c = feats.shape[-1]
        idx = seg_ids[:, None].expand(n, c)
        if reduce == "max":
            src = torch.where(valid[:, None], feats,
                              torch.full((), -float("inf"), dtype=feats.dtype, device=dev))
            out = torch.full((capacity + 1, c), -float("inf"), dtype=feats.dtype, device=dev)
            out = out.scatter_reduce(0, idx, src, reduce="amax")[:capacity]
            out_feats = torch.where(unique_mask[:, None] & torch.isfinite(out), out,
                                    torch.zeros((), dtype=out.dtype, device=dev))
        elif reduce in ("sum", "mean"):
            src = where_valid(valid, feats)
            sums = torch.zeros((capacity + 1, c), dtype=feats.dtype, device=dev)
            out_feats = sums.index_add(0, seg_ids, src)[:capacity]
            if reduce == "mean":
                counts = torch.zeros(capacity + 1, dtype=feats.dtype, device=dev).index_add(
                    0, seg_ids, valid.to(feats.dtype))[:capacity]
                out_feats = out_feats / counts.clamp(min=1)[:, None]
        else:
            raise ValueError(f"unknown reduce: {reduce}")
    return unique_coords, unique_mask, seg_ids, out_feats


# ---------------------------------------------------------------------------
# Dense <-> sparse (``pasco_tpu/core/sparse.py:394-483``)
# ---------------------------------------------------------------------------


def to_dense(grid: SparseGrid, box: Box, batch_size: int, fill: float = 0.0) -> torch.Tensor:
    """The grid scattered into a dense ``[B, X, Y, Z, C]`` volume at its
    stride.  Masked rows are dropped; a valid row outside the box is placed
    as the reference's scatter places it (each index wraps once if
    negative, and the row is dropped if one is still out of range)."""
    ex, ey, ez = box.extent_at(grid.stride)
    rel = torch.div(grid.coords[:, 1:] - box.minimum[None, :], grid.stride,
                    rounding_mode="floor")
    b = torch.where(grid.mask, grid.coords[:, 0], batch_size)
    flat = torch.zeros_like(b, dtype=torch.long)
    dropped = torch.zeros_like(grid.mask)
    for idx, size in ((b, batch_size), (rel[:, 0], ex), (rel[:, 1], ey), (rel[:, 2], ez)):
        i = _drop_index(idx, size)
        dropped |= i == size
        flat = flat * size + i.clamp(max=size - 1)
    n_cells = batch_size * ex * ey * ez
    flat = torch.where(dropped, n_cells, flat)
    c = grid.num_channels
    dense = torch.full((n_cells + 1, c), fill, dtype=grid.feats.dtype, device=flat.device)
    dense = dense.index_put((flat,), grid.feats)
    return dense[:n_cells].reshape(batch_size, ex, ey, ez, c)


def from_dense(dense: torch.Tensor, box: Box, stride: int, capacity: int,
               keep: Optional[torch.Tensor] = None) -> SparseGrid:
    """A dense ``[B, X, Y, Z, C]`` volume as a grid: the cells where
    ``keep [B, X, Y, Z]`` is set (by default, any non-zero channel),
    compacted to ``capacity`` (all cells in flat order where ``capacity``
    is their number)."""
    bsz, ex, ey, ez, ch = dense.shape
    dev = dense.device
    if keep is None:
        keep = (dense != 0).any(-1)
    bb, xx, yy, zz = torch.meshgrid(
        *(torch.arange(n, device=dev, dtype=torch.int32) for n in (bsz, ex, ey, ez)),
        indexing="ij")
    mn = box.minimum
    coords = torch.stack([bb.reshape(-1), xx.reshape(-1) * stride + mn[0],
                          yy.reshape(-1) * stride + mn[1], zz.reshape(-1) * stride + mn[2]],
                         -1).to(torch.int32)
    grid = SparseGrid(coords, dense.reshape(-1, ch), keep.reshape(-1), stride)
    if capacity == grid.capacity:
        return grid
    return compact(grid, grid.mask, capacity)


def gather_dense(dense: torch.Tensor, coords: torch.Tensor, mask: torch.Tensor, box: Box,
                 stride: int) -> torch.Tensor:
    """Values of a dense ``[B, X, Y, Z, ...]`` volume at sparse coordinates;
    0 where masked or outside the box."""
    extent = box.extent_at(stride)
    rel = torch.div(coords[:, 1:] - box.minimum[None, :], stride, rounding_mode="floor")
    in_box = mask.clone()
    for i, e in enumerate(extent):
        in_box &= (rel[:, i] >= 0) & (rel[:, i] < e)
    x, y, z = (rel[:, i].clamp(0, e - 1).long() for i, e in enumerate(extent))
    vals = dense[_clip_index(coords[:, 0], dense.shape[0]), x, y, z]
    in_box = in_box.reshape(-1, *([1] * (vals.dim() - 1)))
    return torch.where(in_box, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))


# ---------------------------------------------------------------------------
# Batched helpers (``pasco_tpu/core/sparse.py:486-511``)
# ---------------------------------------------------------------------------


def batch_offsets(grid: SparseGrid, batch_size: int) -> torch.Tensor:
    """Each row's batch index; ``batch_size`` for masked rows."""
    return torch.where(grid.mask, grid.coords[:, 0], batch_size)


def global_pool(grid: SparseGrid, batch_size: int, reduce: str = "mean") -> torch.Tensor:
    """Masked pooling per batch item -> ``[B, C]`` (``mean`` or ``max``;
    a batch index outside ``[0, B)`` is dropped, as segment ops drop it)."""
    seg = batch_offsets(grid, batch_size).long()
    seg = torch.where((seg >= 0) & (seg < batch_size), seg, batch_size)
    c = grid.num_channels
    dev = seg.device
    if reduce == "mean":
        feats = grid.masked_feats()
        sums = torch.zeros((batch_size + 1, c), dtype=feats.dtype, device=dev).index_add(
            0, seg, feats)[:batch_size]
        counts = torch.zeros(batch_size + 1, dtype=feats.dtype, device=dev).index_add(
            0, seg, grid.mask.to(feats.dtype))[:batch_size]
        return sums / counts.clamp(min=1)[:, None]
    if reduce == "max":
        src = torch.where(grid.mask[:, None], grid.feats,
                          torch.full((), -float("inf"), dtype=grid.feats.dtype, device=dev))
        out = torch.full((batch_size + 1, c), -float("inf"), dtype=src.dtype, device=dev)
        out = out.scatter_reduce(0, seg[:, None].expand_as(src), src, reduce="amax")[:batch_size]
        return torch.where(torch.isfinite(out), out, torch.zeros((), dtype=out.dtype, device=dev))
    raise ValueError(reduce)
