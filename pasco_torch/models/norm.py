"""Batch normalisation at inference (counterpart of ``pasco_tpu/models/norm.py``
and ``dense_unet.DenseBN``).

Parameters keep the flax names and shapes: ``scale``/``bias`` parameters
and ``mean``/``var`` running statistics, optionally with a leading subnet
axis (the vmapped refiners).  Only inference is ported: the running
statistics normalise, so a layer is one per-channel affine ``a*x + c``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

TRAINING_NOT_PORTED = (
    "training and MC dropout are not ported yet (ROADMAP.md, queue 1 item 2)"
)


class BatchNorm(nn.Module):
    """Masked/dense BatchNorm with running statistics (inference only)."""

    def __init__(self, shape, epsilon: float = 1e-5):
        super().__init__()
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))
        self.register_buffer("mean", torch.zeros(shape))
        self.register_buffer("var", torch.ones(shape))

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-channel f32 ``(a, c)`` with ``bn(x) == a * x + c``."""
        inv = torch.rsqrt(self.var + self.epsilon) * self.scale
        return inv, self.bias - self.mean * inv

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """``(x - mean) * inv + bias`` in f32, zeroed where ``mask`` is
        False, cast back to ``x``'s dtype."""
        if self.training:
            raise NotImplementedError(TRAINING_NOT_PORTED)
        inv = torch.rsqrt(self.var + self.epsilon) * self.scale
        out = (x.float() - self.mean) * inv + self.bias
        if mask is not None:
            out = torch.where(mask[..., None], out,
                              torch.zeros((), device=out.device))
        return out.to(x.dtype)
