"""Point featurizer and MIMO input fusion (counterpart of
``pasco_tpu/models/cylinder_feat.py``).

* :class:`PointMLP`: the CylinderFeat point MLP
  (``unet3d_sparse_v2.py:22-34``), shared with the dense substrate.
* :class:`CylinderFeat`: the point MLP, then one voxel per (subnet, cell)
  by :func:`~pasco_torch.core.sparse.unique` with a max reduction.
* :func:`mimo_merge`: the subnets' voxels as one batch-1 grid on the union
  of their cells, subnet ``i`` in channel block ``[i*C, (i+1)*C)``.
"""

from __future__ import annotations

import torch
from torch import nn

from pasco_torch.core.sparse import Box, SparseGrid, unique
from pasco_torch.models.blocks import masked_bn


class PointMLP(nn.Module):
    """CylinderFeat point MLP (``unet3d_sparse_v2.py:22-34``)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.bn_in = masked_bn(in_dim)
        self.fc1, self.bn1 = nn.Linear(in_dim, 64), masked_bn(64)
        self.fc2, self.bn2 = nn.Linear(64, 128), masked_bn(128)
        self.fc3, self.bn3 = nn.Linear(128, 256), masked_bn(256)
        self.fc4 = nn.Linear(256, out_dim)

    def forward(self, pf, pm):
        f = self.bn_in(pf, pm)
        f = torch.relu(self.bn1(self.fc1(f), pm))
        f = torch.relu(self.bn2(self.fc2(f), pm))
        f = torch.relu(self.bn3(self.fc3(f), pm))
        f = self.fc4(f)
        return torch.where(pm[..., None], f, torch.zeros((), device=f.device))


class CylinderFeat(PointMLP):
    """Per-point MLP + max-pool into per-subnet voxels: the subnet id rides
    in the batch column of ``point_coords`` ``[P, 4]``, as in the
    reference's unique key (``unet3d_sparse_v2.py:58-74``)."""

    def __init__(self, in_dim: int, out_dim: int = 64, voxel_capacity: int = 131072):
        super().__init__(in_dim, out_dim)
        self.voxel_capacity = voxel_capacity

    def forward(self, point_feats: torch.Tensor, point_coords: torch.Tensor,
                point_mask: torch.Tensor, box: Box, n_infers: int) -> SparseGrid:
        f = super().forward(point_feats, point_mask)
        coords, mask, _, feats = unique(point_coords, point_mask, box, 1, self.voxel_capacity,
                                        feats=f, reduce="max", max_batch=n_infers)
        return SparseGrid(coords, feats, mask, 1)


def mimo_merge(per_subnet: SparseGrid, box: Box, n_infers: int,
               out_capacity: int) -> SparseGrid:
    """The per-subnet grid (subnet in the batch column) as one batch-1 grid
    on the union of the subnets' cells with ``n_infers * C`` channels, zero
    where a subnet has no voxel (the reference's dense channel concat,
    ``augmenter.py:17-27``, without densifying)."""
    c = per_subnet.num_channels
    union_in = per_subnet.coords.clone()
    union_in[:, 0] = 0
    union_coords, union_mask, seg_ids, _ = unique(union_in, per_subnet.mask, box,
                                                  per_subnet.stride, out_capacity)
    subnet = per_subnet.coords[:, 0].clamp(0, n_infers - 1)
    lanes = torch.arange(n_infers, dtype=subnet.dtype, device=subnet.device)
    one_hot = (subnet[:, None] == lanes).to(per_subnet.feats.dtype)
    contrib = (one_hot[:, :, None] * per_subnet.masked_feats()[:, None, :]).reshape(
        -1, n_infers * c)
    out = torch.zeros((out_capacity + 1, n_infers * c), dtype=per_subnet.feats.dtype,
                      device=contrib.device)
    # at most one row per (cell, subnet) after the per-subnet unique: exact
    out = out.index_add(0, seg_ids, contrib)
    return SparseGrid(union_coords, out[:out_capacity], union_mask, per_subnet.stride)
