"""Building blocks shared by the port's models (counterpart of
``pasco_tpu/models/blocks.py``).

The sparse blocks run on a :class:`~pasco_torch.core.sparse.SparseGrid`
plus its :class:`~pasco_torch.core.sparse.Box`, as the reference's do.
Submodule and parameter names equal flax's (auto-names such as
``SparseDownConv_0`` included), and conv kernels keep the reference layout
``[K, Cin, Cout]``, so :mod:`pasco_torch.convert` carries a flax tree over
unchanged.  BatchNorm layers normalise with batch statistics in training
mode (``module.training``), as the reference's ``train=True``; the random
layers take the caller's ``generator`` and whether they are live.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pasco_torch.core.sparse import Box, SparseGrid, global_pool, where_valid
from pasco_torch.models.norm import BatchNorm
from pasco_torch.ops.sparse_conv import (
    Rulebook, build_rulebook, generative_deconv3d, strided_conv3d, submanifold_conv3d)


class MLP(nn.Module):
    """Plain MLP with ReLU between layers.  Layers are named ``Dense_i``
    like flax's auto-names, so the weight bridge maps them one to one."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            self.add_module(f"Dense_{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.num_layers - 1:
                x = torch.relu(x)
        return x


class ConvParams(nn.Module):
    """A conv layer's parameters in the reference layout: ``kernel``
    ``[taps, Ci, Co]`` (or any given shape) and an optional ``bias``.  The
    stage code drives the kernels with them."""

    def __init__(self, kernel_shape, bias_shape=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(tuple(kernel_shape)))
        bias = None if bias_shape is None else torch.zeros(tuple(bias_shape))
        self.register_parameter(
            "bias", None if bias is None else nn.Parameter(bias))


def compute_dtype_of(cfg) -> torch.dtype:
    """The torch dtype of a ``ModelConfig``'s ``compute_dtype``."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def masked_bn(shape) -> BatchNorm:
    """``MaskedBatchNorm`` (``shape`` channels, or ``[S, C]`` rows of the
    vmapped refiners): the row count floored after the cross-rank sum."""
    return BatchNorm(shape, floor_each_rank=False)


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------


class SpatialDropout(nn.Module):
    """Whole-channel dropout on ``[..., C]`` features or volumes
    (``SpatialDropout``/``DenseSpatialDropout`` and the bottleneck's
    channel ``nn.Dropout``): one Bernoulli keep per channel, shared by every
    row or cell, ``x / (1 - rate)`` where kept and 0 elsewhere.  ``name`` is
    the reference's module path."""

    def __init__(self, rate: float, name: str):
        super().__init__()
        self.rate, self.name = rate, name

    def draw(self, c: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
        """The ``[c]`` keep vector."""
        return torch.rand(c, generator=generator, device=device) < 1.0 - self.rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        keep = self.draw(x.shape[-1], generator, x.device)
        return torch.where(keep, x / (1.0 - self.rate),
                           torch.zeros((), dtype=x.dtype, device=x.device))


def add_dropout(owner: nn.Module, attr: str, rate: float, name: str) -> None:
    """Register a :class:`SpatialDropout` only for a non-zero rate, so a
    zero rate adds no module and no draw."""
    if rate > 0.0:
        owner.add_module(attr, SpatialDropout(rate, name))


def apply_dropout(owner: nn.Module, attr: str, x, generator, live: bool):
    mod = getattr(owner, attr, None)
    return mod(x, generator) if live and mod is not None else x


class DropPath(nn.Module):
    """Stochastic depth: the residual branch dropped per row, in training
    mode only (``blocks.py:121-134``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, feats: torch.Tensor, generator: Optional[torch.Generator]):
        if self.rate == 0.0 or not self.training:
            return feats
        keep = torch.rand((feats.shape[0], 1), generator=generator,
                          device=feats.device) < 1.0 - self.rate
        return torch.where(keep, feats / (1.0 - self.rate),
                           torch.zeros((), dtype=feats.dtype, device=feats.device))


# ---------------------------------------------------------------------------
# Sparse convolutions
# ---------------------------------------------------------------------------


class SparseConv(nn.Module):
    """Submanifold sparse conv (``ME.MinkowskiConvolution(ks, stride=1)``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 use_bias: bool = True, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.zeros((kernel_size ** 3, in_channels, out_channels)))
        self.register_parameter(
            "bias", nn.Parameter(torch.zeros(out_channels)) if use_bias else None)

    def forward(self, grid: SparseGrid, box: Box,
                rulebook: Optional[Rulebook] = None) -> SparseGrid:
        return submanifold_conv3d(grid, box, self.kernel, self.bias, self.compute_dtype,
                                  rulebook)


class SparseDownConv(nn.Module):
    """Kernel-2 stride-2 down conv into ``out_capacity`` rows."""

    def __init__(self, in_channels: int, out_channels: int, out_capacity: int,
                 use_bias: bool = True, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.out_capacity, self.compute_dtype = out_capacity, compute_dtype
        self.kernel = nn.Parameter(torch.zeros((8, in_channels, out_channels)))
        self.register_parameter(
            "bias", nn.Parameter(torch.zeros(out_channels)) if use_bias else None)

    def forward(self, grid: SparseGrid, box: Box) -> SparseGrid:
        return strided_conv3d(grid, box, self.kernel, self.out_capacity, self.bias,
                              self.compute_dtype)


class SparseGenerativeDeconv(nn.Module):
    """Kernel-2 stride-2 generative transposed conv (8x the rows)."""

    def __init__(self, in_channels: int, out_channels: int, use_bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.zeros((8, in_channels, out_channels)))
        self.register_parameter(
            "bias", nn.Parameter(torch.zeros(out_channels)) if use_bias else None)

    def forward(self, grid: SparseGrid) -> SparseGrid:
        return generative_deconv3d(grid, self.kernel, self.bias, self.compute_dtype)


class SELayer(nn.Module):
    """Squeeze-and-excitation over the global-pooled features."""

    def __init__(self, channels: int, reduction: int = 2, batch_size: int = 1):
        super().__init__()
        self.batch_size = batch_size
        self.Dense_0 = nn.Linear(channels, channels // reduction)
        self.Dense_1 = nn.Linear(channels // reduction, channels)

    def forward(self, grid: SparseGrid) -> SparseGrid:
        y = global_pool(grid, self.batch_size, reduce="mean").float()
        y = torch.sigmoid(self.Dense_1(torch.relu(self.Dense_0(y))))
        gate = y[grid.coords[:, 0].long().clamp(0, self.batch_size - 1)]
        return grid.with_feats(where_valid(grid.mask, grid.feats * gate))


class BasicConvBlock(nn.Module):
    """Down conv + BN + LeakyReLU, and with ``extra_norm`` the encoder's
    second BN + ReLU (``encoder_v2.py:124-127``)."""

    def __init__(self, in_channels: int, out_channels: int, out_capacity: int,
                 extra_norm: bool = True, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.extra_norm = extra_norm
        self.SparseDownConv_0 = SparseDownConv(in_channels, out_channels, out_capacity,
                                               compute_dtype=compute_dtype)
        self.MaskedBatchNorm_0 = masked_bn(out_channels)
        if extra_norm:
            self.MaskedBatchNorm_1 = masked_bn(out_channels)

    def forward(self, grid: SparseGrid, box: Box) -> SparseGrid:
        g = self.SparseDownConv_0(grid, box)
        f = F.leaky_relu(self.MaskedBatchNorm_0(g.feats, g.mask), 0.01)
        if self.extra_norm:
            f = torch.relu(self.MaskedBatchNorm_1(f, g.mask))
        return g.with_feats(where_valid(g.mask, f))


class ResidualBlock(nn.Module):
    """Pre-activation residual block (``mink.py:618-658``):
    ``relu(skip + conv2(relu(bn2(conv1(relu(bn1(x)))))))`` with ``skip`` a
    1x1 conv where the width changes."""

    def __init__(self, in_channels: int, out_channels: int, drop_path: float = 0.0,
                 use_se: bool = False, batch_size: int = 1,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if in_channels != out_channels:
            self.downsample = SparseConv(in_channels, out_channels, 1,
                                         compute_dtype=compute_dtype)
        self.bn1 = masked_bn(in_channels)
        self.conv1 = SparseConv(in_channels, out_channels, 3, compute_dtype=compute_dtype)
        self.bn2 = masked_bn(out_channels)
        self.conv2 = SparseConv(out_channels, out_channels, 3, compute_dtype=compute_dtype)
        self.DropPath_0 = DropPath(drop_path)
        if use_se:
            self.SELayer_0 = SELayer(out_channels, batch_size=batch_size)

    def forward(self, grid: SparseGrid, box: Box, rulebook: Optional[Rulebook] = None,
                generator: Optional[torch.Generator] = None) -> SparseGrid:
        skip = self.downsample(grid, box).feats if hasattr(self, "downsample") else grid.feats
        f = torch.relu(self.bn1(grid.feats, grid.mask))
        g = self.conv1(grid.with_feats(f), box, rulebook)
        f = torch.relu(self.bn2(g.feats, g.mask))
        g = self.conv2(g.with_feats(f), box, rulebook)
        y = self.DropPath_0(g.feats, generator)
        if hasattr(self, "SELayer_0"):
            y = self.SELayer_0(g.with_feats(y)).feats
        return g.with_feats(where_valid(g.mask, torch.relu(skip + y)))


# ---------------------------------------------------------------------------
# Pooling and attention-style blocks
# ---------------------------------------------------------------------------


def submanifold_maxpool(grid: SparseGrid, box: Box, kernel_size: int) -> SparseGrid:
    """Stride-1 max-pool over each row's ``kernel_size^3`` neighbourhood
    (``ME.MinkowskiMaxPooling(ks, stride=1)``)."""
    rb = build_rulebook(grid.coords, grid.mask, box, grid.stride, kernel_size)
    feats = grid.masked_feats()
    neg = torch.full((), -float("inf"), dtype=feats.dtype, device=feats.device)
    acc = torch.full_like(feats, -float("inf"))
    for rows, found in zip(rb.rows, rb.found):
        acc = torch.maximum(acc, torch.where(found[:, None], feats[rows.long()], neg))
    return grid.with_feats(where_valid(grid.mask, acc))


class CAM(nn.Module):
    """Context attention (``layers.py:60-78``): each row gated by
    ``sigmoid(fc2(relu(fc1(maxpool7(x)))))``."""

    def __init__(self, planes: int, reduction: int = 2):
        super().__init__()
        self.fc1 = nn.Linear(planes, planes // reduction)
        self.fc2 = nn.Linear(planes // reduction, planes)

    def forward(self, grid: SparseGrid, box: Box) -> SparseGrid:
        y = submanifold_maxpool(grid, box, kernel_size=7)
        gate = torch.sigmoid(self.fc2(torch.relu(self.fc1(y.feats.float()))))
        return grid.with_feats(where_valid(grid.mask, grid.feats * gate))


class PointwiseConvMultiheads(nn.Module):
    """Block-diagonal (per-head) 1x1 conv (``layers.py:111-135``).  The
    flax ``kernel [in, out]`` is kept as ``weight [out, in]``, the layout of
    every 2-D kernel in the port."""

    def __init__(self, in_planes: int, planes: int, n_heads: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros((planes, in_planes)))
        hin = torch.arange(in_planes) // (in_planes // n_heads)
        hout = torch.arange(planes) // (planes // n_heads)
        self.register_buffer("blockmask", (hout[:, None] == hin[None, :]).float(),
                             persistent=False)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return feats.float() @ (self.weight * self.blockmask).T


class DepthwiseSeparableConvMultiheads(nn.Module):
    """Channelwise sparse conv + per-head pointwise mix (``layers.py:178-192``)."""

    def __init__(self, planes: int, kernel_size: int = 3, n_heads: int = 1):
        super().__init__()
        self.kernel_size = kernel_size
        self.depthwise = nn.Parameter(torch.zeros((kernel_size ** 3, planes, 1)))
        self.pointwise = PointwiseConvMultiheads(planes, planes, n_heads)

    def forward(self, grid: SparseGrid, box: Box) -> SparseGrid:
        rb = build_rulebook(grid.coords, grid.mask, box, grid.stride, self.kernel_size)
        feats = grid.masked_feats()
        acc = torch.zeros_like(feats)
        for rows, found, wk in zip(rb.rows, rb.found, self.depthwise[..., 0]):
            acc = acc + where_valid(found, feats[rows.long()]) * wk
        out = where_valid(grid.mask, self.pointwise(acc))
        return grid.with_feats(out.to(grid.feats.dtype))


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------


@torch.no_grad()
def flax_init_(net: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init of ``net`` with the flax initializer families:
    kaiming-uniform over ``(taps * Ci)`` for the reference-layout conv
    kernels (``blocks.py:29-34``, a leading subnet axis aside),
    variance-scaling(2, fan_in, uniform) for the dense bottleneck's 5-D
    kernels, lecun-normal for dense layers and heads, normal(1) for the
    queries, zero biases, identity BatchNorm/LayerNorm."""

    def uniform_(p, bound):
        p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound - bound)

    def lecun_(p, fan_in):
        # truncated normal at +-2 std, rescaled to unit variance (flax)
        t = torch.randn(p.shape, generator=generator)
        while (bad := t.abs() > 2).any():
            t[bad] = torch.randn(int(bad.sum()), generator=generator)
        p.copy_(t * math.sqrt(1.0 / fan_in) / 0.87962566103423978)

    for mod in net.modules():
        if isinstance(mod, (nn.Linear, PointwiseConvMultiheads)):
            w = torch.empty(mod.weight.shape[::-1])
            lecun_(w, w.shape[0])
            mod.weight.copy_(w.T)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
        elif isinstance(mod, BatchNorm):
            mod.scale.fill_(1.0)
            mod.mean.zero_()
            mod.var.fill_(1.0)
    for name, p in net.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("bias", "up_bias", "head_bias"):
            p.zero_()
        elif leaf == "kernel" and p.dim() == 5:
            kx, ky, kz, ci, _ = p.shape
            uniform_(p, math.sqrt(6.0 / (kx * ky * kz * ci)))
        elif leaf in ("kernel", "up_kernel", "depthwise"):
            k, ci = p.shape[-3], p.shape[-2]
            uniform_(p, math.sqrt(1.0 / (k * ci)))
        elif leaf == "head_kernel":
            S, ch, _ = p.shape
            lecun_(p, S * ch)
        elif leaf in ("query_feat", "query_embed"):
            p.copy_(torch.randn(p.shape, generator=generator))
