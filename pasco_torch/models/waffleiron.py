"""WaffleIron point-cloud segmentation backbone (counterpart of
``pasco_tpu/models/waffleiron.py``): PaSCo's point-feature frontend,
whose 256-wide token embedding and 19-class vote make the flagship's
``in_channels = 27 + 256``.

48 layers x 256 channels alternating

* :class:`SpatialMix`: flatten the points onto one of a cycling set of 2D
  grids (the mean per cell), a depthwise 3x3 FFN on the grid, inflate back
  to the points;
* :class:`ChannelMix`: a pointwise MLP with LayerScale.

Every module takes ONE scan and keeps the flax names (``embed``,
``waffleiron.smix{d}``/``cmix{d}``, ``classif``), which
:func:`pasco_torch.convert.waffleiron_flax_to_torch` keys on.  Its
BatchNorms are :class:`~pasco_torch.models.norm.BatchNorm` (masked f32
statistics, parked in training mode until ``commit_batch_stats``), so
their statistics are those of the one scan: the trainer runs a batch
scan by scan and averages the parked statistics, as ``jax.vmap`` of the
reference's forward does.

The flatten is ``index_add_`` into ``H*W + 1`` cells (masked points go to
the last, which is dropped), and the gathers (the neighbours, the
inflate) are ``index_select``, whose backward is ``index_add_`` too
(advanced indexing's backward sorts the indices and took ~5 ms a layer on
the card, most of a train step).  On a CUDA device ``index_add_`` sums f32
rows with atomics, so the order of the sums, and with it the last bits of
a cell's mean or a gradient, varies from run to run: results on the card
equal the CPU's, and each other, to a tolerance, not bit for bit.

Host-side preprocessing (:func:`knn_indices`, :func:`grid_cell_indices`)
is the reference's, copied (numpy and scipy's cKDTree, so that neighbour
ties break identically).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pasco_torch.models.blocks import flax_init_, lecun_normal_
from pasco_torch.models.norm import BatchNorm

GRIDS = ((250, 250), (250, 12), (250, 12))


def _masked(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[:, None], x, torch.zeros((), dtype=x.dtype, device=x.device))


class Embedding(nn.Module):
    """Point + neighbourhood embedding (``pasco_tpu/models/waffleiron.py:
    31-68``): the normalised point through ``conv1``, the max over its
    K-1 neighbours of an MLP of the relative normalised features, and a
    1x1 ``final`` over both; zero on masked rows."""

    def __init__(self, channels_in: int, channels_out: int):
        super().__init__()
        self.norm = BatchNorm(channels_in)
        self.conv1 = nn.Linear(channels_in, channels_out)
        self.nbn1 = BatchNorm(channels_in)
        self.nconv1 = nn.Linear(channels_in, channels_out, bias=False)
        self.nbn2 = BatchNorm(channels_out)
        self.nconv2 = nn.Linear(channels_out, channels_out, bias=False)
        self.final = nn.Linear(2 * channels_out, channels_out)

    def forward(self, x: torch.Tensor, neighbors: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """``x [N, C_in]``, ``neighbors [K, N]`` (row 0 the point itself,
        padded rows 0), ``mask [N]`` -> ``[N, channels_out]``."""
        x = self.norm(x, mask)
        point_emb = self.conv1(x)
        k1, n = neighbors.shape[0] - 1, x.shape[0]
        neigh = x.index_select(0, neighbors[1:].reshape(-1)).view(k1, n, -1) - x[None]
        nmask = mask[None].expand(neigh.shape[:2])          # statistics over (K-1)*N rows
        h = self.nconv1(self.nbn1(neigh, nmask))
        h = self.nconv2(F.relu(self.nbn2(h, nmask)))
        out = self.final(torch.cat([point_emb, h.amax(0)], -1))
        return _masked(mask, out)


class ChannelMix(nn.Module):
    """``tokens + LayerScale(MLP(BN(tokens)))`` (``waffleiron.py:71-86``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = BatchNorm(channels)
        self.fc1 = nn.Linear(channels, channels)
        self.fc2 = nn.Linear(channels, channels)
        self.layerscale = nn.Parameter(torch.ones(channels))

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = self.fc2(F.relu(self.fc1(self.norm(tokens, mask))))
        return tokens + _masked(mask, h * self.layerscale)


class SpatialMix(nn.Module):
    """``tokens + LayerScale(Inflate(FFN(Flatten(BN(tokens)))))``
    (``waffleiron.py:89-141``) on the row-major ``(H, W)`` grid, cell
    ``ia * W + ib``.  The depthwise kernels ``dw1``/``dw2`` are
    ``(C, 1, 3, 3)`` (flax's HWIO ``(3, 3, 1, C)``), 'same' padded, no
    bias, a ReLU between them."""

    def __init__(self, channels: int, grid_shape: Tuple[int, int]):
        super().__init__()
        self.grid_shape = tuple(grid_shape)
        self.norm = BatchNorm(channels)
        self.dw1 = nn.Parameter(torch.zeros(channels, 1, 3, 3))
        self.dw2 = nn.Parameter(torch.zeros(channels, 1, 3, 3))
        self.layerscale = nn.Parameter(torch.ones(channels))

    def forward(self, tokens: torch.Tensor, cell_ind: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """``tokens [N, C]``, ``cell_ind [N]`` (flat cell per point),
        ``mask [N]``."""
        H, W = self.grid_shape
        n_cells, C = H * W, tokens.shape[-1]
        h = self.norm(tokens, mask)                         # zero on masked rows
        # masked rows, and indices past the grid (JAX's segment_sum drops
        # them), go to the dump cell
        seg = torch.where(mask & (cell_ind >= 0) & (cell_ind < n_cells), cell_ind, n_cells)
        sums = h.new_zeros(n_cells + 1, C).index_add_(0, seg, h)[:n_cells]
        counts = h.new_zeros(n_cells + 1).index_add_(0, seg, mask.to(h.dtype))[:n_cells]
        grid = sums / counts.clamp(min=1e-6)[:, None]       # an empty cell reads 0
        # [1, C, H, W] with channels-last strides: no copy in or out
        g = grid.view(1, H, W, C).permute(0, 3, 1, 2)
        g = F.conv2d(F.relu(F.conv2d(g, self.dw1, padding=1, groups=C)), self.dw2,
                     padding=1, groups=C)
        flat = g.permute(0, 2, 3, 1).reshape(n_cells, C)
        inflated = flat.index_select(0, cell_ind.clamp(0, n_cells - 1))
        return tokens + _masked(mask, inflated * self.layerscale)


class WaffleIron(nn.Module):
    """``depth`` pairs (``smix{d}``, ``cmix{d}``); layer ``d`` flattens
    onto grid ``d % len(grids_shape)``."""

    def __init__(self, channels: int = 256, depth: int = 48,
                 grids_shape: Sequence[Tuple[int, int]] = GRIDS):
        super().__init__()
        self.depth = depth
        self.grids_shape = tuple(tuple(g) for g in grids_shape)
        for d in range(depth):
            self.add_module(f"smix{d}", SpatialMix(channels, self.grids_shape[d % len(grids_shape)]))
            self.add_module(f"cmix{d}", ChannelMix(channels))

    def forward(self, tokens: torch.Tensor, cell_inds: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """``tokens [N, C]``, ``cell_inds [n_grids, N]``, ``mask [N]``."""
        g = len(self.grids_shape)
        for d in range(self.depth):
            tokens = getattr(self, f"smix{d}")(tokens, cell_inds[d % g], mask)
            tokens = getattr(self, f"cmix{d}")(tokens, mask)
        return tokens


class Segmenter(nn.Module):
    """Embedding -> WaffleIron -> 1x1 classifier; returns ``(logits [N,
    n_classes], tokens [N, channels])`` (``waffleiron.py:163-187``).  In
    training mode (``self.training``) the BatchNorms normalise by this
    scan's statistics and park them."""

    def __init__(self, n_classes: int = 19, channels: int = 256, depth: int = 48,
                 in_channels: int = 5, grids_shape: Sequence[Tuple[int, int]] = GRIDS):
        super().__init__()
        self.n_classes = n_classes
        self.embed = Embedding(in_channels, channels)
        self.waffleiron = WaffleIron(channels, depth, grids_shape)
        self.classif = nn.Linear(channels, n_classes)

    def forward(self, feats: torch.Tensor, neighbors: torch.Tensor, cell_inds: torch.Tensor,
                mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        tokens = self.waffleiron(self.embed(feats, neighbors, mask), cell_inds, mask)
        return self.classif(tokens), tokens

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random init with flax's initializers: lecun-normal dense
        and depthwise kernels (fan-in 9 for the 3x3 depthwise), zero
        biases, identity BatchNorm, LayerScale 1."""
        flax_init_(self, generator)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("dw1", "dw2"):
                lecun_normal_(p, 9, generator)
            elif leaf == "layerscale":
                p.fill_(1.0)


def segmenter_device(device) -> torch.device:
    """``device`` for the Segmenter's entry points: the card unless the
    caller asks for the CPU; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("WaffleIron: no CUDA device; pass device='cpu' for the CPU")
    return device


# ---------------------------------------------------------------------------
# Host-side preprocessing (copied from pasco_tpu/models/waffleiron.py:195-223)
# ---------------------------------------------------------------------------


def knn_indices(xyz: np.ndarray, k: int = 16) -> np.ndarray:
    """[K, N] nearest-neighbor indices (row 0 = self) via cKDTree."""
    from scipy.spatial import cKDTree

    tree = cKDTree(xyz)
    _, idx = tree.query(xyz, k=k)
    return idx.T.astype(np.int32)


def grid_cell_indices(
    xyz: np.ndarray,
    grids_shape: Sequence[Tuple[int, int]] = GRIDS,
    fov: float = 50.0,
    z_range: Tuple[float, float] = (-3.0, 2.0),
) -> np.ndarray:
    """Per-point flat 2D cell index for every projection grid: the cycling
    planes are (x, y), (x, z), (y, z)."""
    planes = [(0, 1), (0, 2), (1, 2)]
    lo = np.array([-fov, -fov, z_range[0]])
    hi = np.array([fov, fov, z_range[1]])
    out = []
    for (a, b), (H, W) in zip(planes, grids_shape):
        ia = np.clip(
            ((xyz[:, a] - lo[a]) / (hi[a] - lo[a]) * H).astype(np.int64), 0, H - 1
        )
        ib = np.clip(
            ((xyz[:, b] - lo[b]) / (hi[b] - lo[b]) * W).astype(np.int64), 0, W - 1
        )
        out.append(ia * W + ib)
    return np.stack(out).astype(np.int32)
