"""Brute-force kNN and inverse-distance interpolation (counterpart of
``pasco_tpu/ops/knn.py``, the reference's pykeops ``knn_up``,
``pasco/maskpls/interpolate.py:9-59``).

Distances use the reference's expansion ``|q|^2 - 2 q.r + |r|^2`` over
query tiles, so memory stays bounded; the neighbours are the ``k`` least
distances with ties to the lower index (a stable sort, as ``lax.top_k``
orders ties).
"""

from __future__ import annotations

from typing import Tuple

import torch


def knn(queries: torch.Tensor, refs: torch.Tensor, ref_mask: torch.Tensor, k: int,
        tile: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(distances [M, k], indices [M, k])`` of the ``k`` nearest valid refs
    of each query (squared distances; masked refs at ``1e30``)."""
    ref_sq = (refs * refs).sum(-1)
    big = torch.full((), 1e30, dtype=refs.dtype, device=refs.device)
    ds, idxs = [], []
    for q in queries.split(tile):
        d = (q * q).sum(-1)[:, None] - 2 * q @ refs.T + ref_sq[None, :]
        d = torch.where(ref_mask[None, :], d, big)
        d, idx = torch.sort(d, dim=-1, stable=True)
        ds.append(d[:, :k])
        idxs.append(idx[:, :k])
    return torch.cat(ds), torch.cat(idxs)


def knn_up(voxel_coords: torch.Tensor, voxel_feats: torch.Tensor, voxel_mask: torch.Tensor,
           point_xyz: torch.Tensor, k: int = 3, eps: float = 1e-8) -> torch.Tensor:
    """Voxel features ``[N, C]`` interpolated onto points ``[M, 3]`` with
    inverse-distance weights over the ``k`` nearest valid voxel centres."""
    d, idx = knn(point_xyz, voxel_coords, voxel_mask, k)
    w = 1.0 / (d + eps)
    w = w / w.sum(-1, keepdim=True)
    return (voxel_feats[idx] * w[:, :, None]).sum(1)
