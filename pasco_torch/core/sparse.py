"""Padded sparse voxel containers (counterpart of ``pasco_tpu/core/sparse.py``).

A :class:`SparseGrid` is a static-capacity voxel set: ``coords`` int32
``[N, 4]`` rows of ``(batch, x, y, z)`` in stride-1 units, ``feats``
``[N, C]`` and a validity ``mask`` ``[N]``.  A :class:`Box` is the working
volume: a device ``[3]`` int32 minimum corner and a static extent.

A batch of ``B`` scans (the reference's ``jax.vmap`` of the forward) shares
the static extent and carries one corner per scan: ``minimum`` ``[B, 3]``.
Grids then carry the batch in front (``coords [B, ..., N, 4]``), and the
table helpers below key each row by its scan's own corner.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

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

    def subnet(self, s: int) -> "SparseGrid":
        """Row ``s`` of a subnet-stacked grid."""
        return SparseGrid(self.coords[s], self.feats[s], self.mask[s], self.stride)


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
