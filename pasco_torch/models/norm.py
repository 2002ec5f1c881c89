"""Batch normalisation (counterpart of ``pasco_tpu/models/norm.py`` and
``dense_unet.DenseBN``).

Parameters keep the flax names and shapes: ``scale``/``bias`` parameters
and ``mean``/``var`` running statistics, optionally with a leading subnet
axis (the vmapped refiners, indexed by ``index``).

At inference the running statistics normalise, so a layer is one
per-channel affine ``a*x + c``.  In training mode (``module.training``)
the batch statistics normalise:

* with a mask (``MaskedBatchNorm``/``DenseBN``): masked sums accumulated
  in f32 over the valid rows or cells only, ``cnt`` floored at 1, biased
  variance ``max(s2/cnt - mean^2, 0)``;
* without one (``DenseBatchNorm``, the bottleneck): mean and biased
  variance over every cell.

The running statistics follow flax's convention, ``ra = 0.9*ra + 0.1*batch``
with the biased variance (``torch.nn.BatchNorm*`` differs on both counts).
They are not written during the forward: rematerialised blocks run their
forward twice, so each training-mode call parks its batch statistics in
:attr:`BatchNorm.pending` and :func:`commit_batch_stats` applies them once
per step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

MOMENTUM = 0.9


def masked_moments(x: torch.Tensor, mask: Optional[torch.Tensor]):
    """Per-channel f32 batch (mean, biased var) of ``x [..., C]`` over the
    rows where ``mask [...]`` is set (every row without a mask)."""
    c = x.shape[-1]
    xf = x.reshape(-1, c)
    if mask is None:
        xf = xf.float()
        return xf.mean(0), xf.var(0, unbiased=False)
    m = mask.reshape(-1, 1)
    xm = torch.where(m, xf, torch.zeros((), dtype=xf.dtype, device=xf.device)).float()
    cnt = m.sum(dtype=torch.float32).clamp(min=1.0)
    mean = xm.sum(0) / cnt
    var = (xm.square().sum(0) / cnt - mean.square()).clamp(min=0.0)
    return mean, var


class BatchNorm(nn.Module):
    """Masked/dense BatchNorm with running statistics."""

    def __init__(self, shape, epsilon: float = 1e-5):
        super().__init__()
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))
        self.register_buffer("mean", torch.zeros(shape))
        self.register_buffer("var", torch.ones(shape))
        # index -> (mean, var) of the last training-mode call, detached
        self.pending: Dict[Optional[int], Tuple[torch.Tensor, torch.Tensor]] = {}

    def _rows(self, index: Optional[int]):
        if index is None:
            return self.scale, self.bias, self.mean, self.var
        return self.scale[index], self.bias[index], self.mean[index], self.var[index]

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-channel f32 ``(a, c)`` with ``bn(x) == a * x + c`` under the
        running statistics."""
        inv = torch.rsqrt(self.var + self.epsilon) * self.scale
        return inv, self.bias - self.mean * inv

    def stats(self, moments, index: Optional[int] = None):
        """(mean, var) that normalise: the batch ``moments()`` in training
        mode (parked for :meth:`commit`), else the running statistics."""
        _, _, ra_mean, ra_var = self._rows(index)
        if not self.training:
            return ra_mean, ra_var
        mean, var = moments()
        self.pending[index] = (mean.detach(), var.detach())
        return mean, var

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                index: Optional[int] = None):
        """``(x - mean) * inv + bias`` in f32, zeroed where ``mask`` is
        False, cast back to ``x``'s dtype."""
        scale, bias, _, _ = self._rows(index)
        mean, var = self.stats(lambda: masked_moments(x, mask), index)
        inv = torch.rsqrt(var + self.epsilon) * scale
        out = (x.float() - mean) * inv + bias
        if mask is not None:
            out = torch.where(mask[..., None], out,
                              torch.zeros((), device=out.device))
        return out.to(x.dtype)

    @torch.no_grad()
    def commit(self) -> None:
        """Fold the parked batch statistics into the running ones."""
        for index, (mean, var) in self.pending.items():
            _, _, ra_mean, ra_var = self._rows(index)
            ra_mean.copy_(MOMENTUM * ra_mean + (1 - MOMENTUM) * mean)
            ra_var.copy_(MOMENTUM * ra_var + (1 - MOMENTUM) * var)
        self.pending.clear()


def commit_batch_stats(net: nn.Module) -> None:
    """Apply every BatchNorm's parked batch statistics of the last
    training-mode forward to its running statistics (once per step)."""
    for mod in net.modules():
        if isinstance(mod, BatchNorm):
            mod.commit()
