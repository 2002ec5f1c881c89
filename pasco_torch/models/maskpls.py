"""MaskPLS building blocks and U-Net, the reference's auxiliary path
(counterpart of ``pasco_tpu/models/maskpls.py``): post-activation
``ResidualBlockOriginal`` (``mink.py:577-616``), ``ASPP``
(``mink.py:11-49``) and the ``MinkEncoderDecoder`` U-Net
(``mink.py:79-502``), whose voxel features are interpolated back onto the
input points by kNN (:func:`~pasco_torch.ops.knn.knn_up`).  The PaSCo
forward does not use them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from pasco_torch.core.sparse import (
    Box, SparseGrid, build_dense_table, compact, global_pool, where_valid)
from pasco_torch.models.blocks import (
    BasicConvBlock, SparseConv, SparseGenerativeDeconv, masked_bn)
from pasco_torch.ops.knn import knn_up
from pasco_torch.ops.sparse_conv import build_rulebook, lookup_features, lookup_offsets


class ResidualBlockOriginal(nn.Module):
    """Conv-BN-ReLU-Conv-BN + (identity, or 1x1 conv + BN) skip -> ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if in_channels != out_channels:
            self.down_conv = SparseConv(in_channels, out_channels, 1,
                                        compute_dtype=compute_dtype)
            self.down_bn = masked_bn(out_channels)
        self.conv1 = SparseConv(in_channels, out_channels, 3, compute_dtype=compute_dtype)
        self.bn1 = masked_bn(out_channels)
        self.conv2 = SparseConv(out_channels, out_channels, 3, compute_dtype=compute_dtype)
        self.bn2 = masked_bn(out_channels)

    def forward(self, grid: SparseGrid, box: Box) -> SparseGrid:
        rb = build_rulebook(grid.coords, grid.mask, box, grid.stride, 3)
        skip = grid.feats
        if hasattr(self, "down_conv"):
            s = self.down_conv(grid, box)
            skip = self.down_bn(s.feats, s.mask)
        g = self.conv1(grid, box, rb)
        g = g.with_feats(where_valid(g.mask, torch.relu(self.bn1(g.feats, g.mask))))
        g = self.conv2(g, box, rb)
        out = torch.relu(self.bn2(g.feats, g.mask) + skip)
        return g.with_feats(where_valid(g.mask, out))


class ASPP(nn.Module):
    """Parallel dilated 3x3 branches and a global-pooled branch,
    concatenated and projected."""

    def __init__(self, in_channels: int, out_channels: int,
                 dilations: Sequence[int] = (1, 2, 3), batch_size: int = 1,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dilations, self.batch_size = tuple(dilations), batch_size
        for d in self.dilations:
            self.add_module(f"branch_d{d}", SparseConv(in_channels, out_channels, 3,
                                                       compute_dtype=compute_dtype))
        self.pool_proj = nn.Linear(in_channels, out_channels)
        self.proj = nn.Linear(out_channels * (len(self.dilations) + 1), out_channels)

    def forward(self, grid: SparseGrid, box: Box) -> SparseGrid:
        table = build_dense_table(grid.coords, grid.mask, box, grid.stride)
        branches = []
        for d in self.dilations:
            rb = lookup_offsets(table, grid.coords, grid.mask, box, grid.stride, 3, d)
            branches.append(getattr(self, f"branch_d{d}")(grid, box, rb).feats)
        pooled = self.pool_proj(global_pool(grid, self.batch_size, reduce="mean").float())
        gate = pooled[grid.coords[:, 0].long().clamp(0, self.batch_size - 1)]
        branches.append(gate.to(grid.feats.dtype))
        out = self.proj(torch.cat(branches, -1).float())
        return grid.with_feats(where_valid(grid.mask, out))


class MaskPLSEncoderDecoder(nn.Module):
    """Compact MaskPLS-style sparse U-Net: encoder stages of a down block
    and a post-activation residual block, generative decoder stages that
    keep the cells of the finer scale, then the finest grid's features
    projected and interpolated onto the points."""

    def __init__(self, in_channels: int, channels: Sequence[int] = (32, 64, 128, 256),
                 out_dim: int = 256, capacities: Sequence[int] = (65536, 32768, 16384, 8192)):
        super().__init__()
        ch = tuple(channels)
        self.channels = ch
        self.stem = SparseConv(in_channels, ch[0], 1)
        for i in range(1, len(ch)):
            self.add_module(f"down{i}", BasicConvBlock(ch[i - 1], ch[i], capacities[i],
                                                       extra_norm=False))
            self.add_module(f"res{i}", ResidualBlockOriginal(ch[i], ch[i]))
        for i in range(len(ch) - 1, 0, -1):
            self.add_module(f"up{i}", SparseGenerativeDeconv(ch[i], ch[i - 1]))
        self.out_proj = nn.Linear(ch[0], out_dim)

    def forward(self, grid: SparseGrid, box: Box,
                point_xyz: torch.Tensor) -> Tuple[torch.Tensor, List[SparseGrid]]:
        """``point_xyz [M, 3]`` in voxel units -> ``(point features [M,
        out_dim], the decoder grids from coarse to fine)``."""
        ch = self.channels
        x = self.stem(grid, box)
        feats = [x]
        for i in range(1, len(ch)):
            x = getattr(self, f"res{i}")(getattr(self, f"down{i}")(x, box), box)
            feats.append(x)
        outs = []
        for i in range(len(ch) - 1, 0, -1):
            up = getattr(self, f"up{i}")(x)
            skip_f, found = lookup_features(feats[i - 1], up.coords, up.mask, box)
            up = up.replace(feats=up.feats + skip_f.to(up.feats.dtype), mask=up.mask & found)
            x = compact(up, up.mask, feats[i - 1].capacity).replace(stride=feats[i - 1].stride)
            outs.append(x)
        final = outs[-1]
        pt = knn_up(final.coords[:, 1:].float(), self.out_proj(final.feats.float()),
                    final.mask, point_xyz.float())
        return pt, outs
