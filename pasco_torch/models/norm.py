"""Batch normalisation (counterpart of ``pasco_tpu/models/norm.py`` and
``dense_unet.DenseBN``).

Parameters keep the flax names and shapes: ``scale``/``bias`` parameters
and ``mean``/``var`` running statistics, optionally with a leading subnet
axis (the vmapped refiners, indexed by ``index``).

At inference the running statistics normalise, so a layer is one
per-channel affine ``a*x + c``.  In training mode (``module.training``)
the batch statistics normalise:

* with a mask (``MaskedBatchNorm``/``DenseBN``): the masked sums ``cnt``,
  ``s1`` and ``s2`` accumulated in f32 over the valid rows or cells only,
  ``cnt`` floored at 1, biased variance ``max(s2/cnt - mean^2, 0)``;
* without one (``DenseBatchNorm``, the bottleneck): mean and biased
  variance over every cell.

Cross-replica BatchNorm (SyncBN, the reference's ``axis_name``): a layer
whose :attr:`BatchNorm.group` is a ``torch.distributed`` process group
(``build_net(cfg, process_group=...)``) sums ``cnt``, ``s1`` and ``s2``
over the group's ranks before it takes the mean and variance; the
unmasked layer averages each rank's mean and variance instead
(``pmean``, ``pasco_tpu/models/norm.py:94-101``: the mean of the variances
is not the pooled variance).  Where ``cnt`` is floored follows each
reference site: on each rank before the sum for ``DenseBN`` and
``DenseBNResizeCoords`` (``pasco_tpu/models/dense_unet.py:132-134,
226``), after it for ``MaskedBatchNorm`` (the point MLP,
``norm.py:53-58``).  The sum is :func:`all_reduce_sum`, whose backward
sums the cotangents over the ranks as ``psum``'s transpose does, so every
rank's loss reaches the statistics' gradient.  Every rank must run the
same training-mode layers in the same order (remat reruns them in
backward): the training forward has no data-dependent skip of a layer.

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


def masked_sums(x: torch.Tensor, mask: torch.Tensor):
    """Per-channel f32 ``(cnt, s1, s2)`` of ``x [..., C]`` over the rows
    where ``mask [...]`` is set: the row count (a 0-d tensor), the sum and
    the sum of squares."""
    c = x.shape[-1]
    m = mask.reshape(-1, 1)
    xm = torch.where(m, x.reshape(-1, c),
                     torch.zeros((), dtype=x.dtype, device=x.device)).float()
    return m.sum(dtype=torch.float32), xm.sum(0), xm.square().sum(0)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``; the backward sums the
    cotangents over the ranks (``psum``'s transpose)."""
    return _AllReduceSum.apply(t, group)


class BatchNorm(nn.Module):
    """Masked/dense BatchNorm with running statistics."""

    def __init__(self, shape, epsilon: float = 1e-5, floor_each_rank: bool = True):
        super().__init__()
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        self.epsilon = epsilon
        # cnt floored at 1 on each rank before the cross-rank sum (DenseBN)
        # or after it (MaskedBatchNorm); the same without a group
        self.floor_each_rank = floor_each_rank
        self.group = None          # a torch.distributed group: SyncBN
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

    def moments(self, cnt: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor):
        """Batch (mean, biased var) from the masked sums of this rank,
        summed over :attr:`group`'s ranks where one is set."""
        if self.group is not None:
            if self.floor_each_rank:
                cnt = cnt.clamp(min=1.0)
            c = s1.shape[-1]
            red = all_reduce_sum(torch.cat([cnt.reshape(1), s1, s2]), self.group)
            cnt, s1, s2 = red[0], red[1:1 + c], red[1 + c:]
        cnt = cnt.clamp(min=1.0)
        mean = s1 / cnt
        return mean, (s2 / cnt - mean.square()).clamp(min=0.0)

    def batch_moments(self, x: torch.Tensor, mask: Optional[torch.Tensor]):
        """Batch (mean, biased var) of ``x [..., C]``: over the rows where
        ``mask`` is set, or without a mask over every row, then averaged
        over :attr:`group`'s ranks."""
        if mask is not None:
            return self.moments(*masked_sums(x, mask))
        xf = x.reshape(-1, x.shape[-1]).float()
        mean, var = xf.mean(0), xf.var(0, unbiased=False)
        if self.group is not None:
            n = torch.distributed.get_world_size(self.group)
            mean, var = all_reduce_sum(torch.stack([mean, var]), self.group) / n
        return mean, var

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
        mean, var = self.stats(lambda: self.batch_moments(x, mask), index)
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


def set_process_group(net: nn.Module, group) -> None:
    """Every BatchNorm of ``net`` reduces its training-mode statistics over
    ``group`` (SyncBN), or over nothing where ``group`` is None."""
    for mod in net.modules():
        if isinstance(mod, BatchNorm):
            mod.group = group


def commit_batch_stats(net: nn.Module) -> None:
    """Apply every BatchNorm's parked batch statistics of the last
    training-mode forward to its running statistics (once per step)."""
    for mod in net.modules():
        if isinstance(mod, BatchNorm):
            mod.commit()
