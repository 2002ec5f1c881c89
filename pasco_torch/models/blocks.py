"""Building blocks shared by the port's models (counterpart of parts of
``pasco_tpu/models/blocks.py``)."""

from __future__ import annotations

import torch
from torch import nn


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
