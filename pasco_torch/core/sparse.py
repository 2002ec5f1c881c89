"""Padded sparse voxel containers (counterpart of ``pasco_tpu/core/sparse.py``).

A :class:`SparseGrid` is a static-capacity voxel set: ``coords`` int32
``[N, 4]`` rows of ``(batch, x, y, z)`` in stride-1 units, ``feats``
``[N, C]`` and a validity ``mask`` ``[N]``.  A :class:`Box` is the working
volume: a device ``[3]`` int32 minimum corner and a static extent.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

INVALID_KEY = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class Box:
    minimum: torch.Tensor            # [3] int32 (stride-1 voxel units)
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


def stack_grids(grids) -> SparseGrid:
    return SparseGrid(
        torch.stack([g.coords for g in grids]),
        torch.stack([g.feats for g in grids]),
        torch.stack([g.mask for g in grids]),
        grids[0].stride,
    )


def linear_keys(coords: torch.Tensor, mask: torch.Tensor, box: Box,
                stride: int) -> torch.Tensor:
    """``(b, x, y, z)`` -> int32 keys inside ``box``; outside or masked
    rows get :data:`INVALID_KEY`."""
    ex, ey, ez = box.extent_at(stride)
    rel = torch.div(coords[:, 1:] - box.minimum[None, :], stride,
                    rounding_mode="floor")
    in_box = (
        (rel[:, 0] >= 0) & (rel[:, 0] < ex)
        & (rel[:, 1] >= 0) & (rel[:, 1] < ey)
        & (rel[:, 2] >= 0) & (rel[:, 2] < ez)
        & mask
    )
    key = ((coords[:, 0] * ex + rel[:, 0]) * ey + rel[:, 1]) * ez + rel[:, 2]
    return torch.where(in_box, key, torch.full_like(key, INVALID_KEY))


def build_dense_table(coords: torch.Tensor, mask: torch.Tensor, box: Box,
                      stride: int) -> torch.Tensor:
    """cell -> row table (``-1`` = empty); the batch column is ignored."""
    ex, ey, ez = box.extent_at(stride)
    n_cells = ex * ey * ez
    c0 = coords.clone()
    c0[:, 0] = 0
    keys = linear_keys(c0, mask, box, stride).long()
    safe = torch.where(keys == INVALID_KEY, torch.full_like(keys, n_cells), keys)
    table = torch.full((n_cells + 1,), -1, dtype=torch.int32,
                       device=coords.device)
    table[safe] = torch.arange(coords.shape[0], dtype=torch.int32,
                               device=coords.device)
    return table[:n_cells]


def lookup_dense_table(table: torch.Tensor, query_coords: torch.Tensor,
                       query_mask: torch.Tensor, box: Box, stride: int):
    """(row, found) for each query coordinate via the dense table."""
    c0 = query_coords.clone()
    c0[:, 0] = 0
    keys = linear_keys(c0, query_mask, box, stride)
    safe = keys.long().clamp(0, table.shape[0] - 1)
    row = table[safe]
    found = (keys != INVALID_KEY) & (row >= 0)
    return torch.where(found, row, torch.zeros_like(row)), found
