"""Dense completion bottleneck at stride 8 (counterpart of
``pasco_tpu/models/bottleneck.py:148-218``: ``_Conv3d``, ``SPCDense3D``).

The reference runs these anisotropic convs as XLA, not Pallas, so the port
runs them as ``F.conv3d``.  Volumes are ``[B, X, Y, Z, C]`` here (the
reference module's ``[X, Y, Z, C]`` with the scans of a batch in front), and
each conv runs once over the batch at N = B.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pasco_torch.models.norm import BatchNorm


class Conv3d(nn.Module):
    """Bias-free channels-last 3D conv with 'same' anisotropic padding;
    ``kernel`` is ``[kx, ky, kz, Ci, Co]`` as in flax."""

    def __init__(self, ch: int, kernel):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros((*kernel, ch, ch)))

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype):
        """``x [B, X, Y, Z, C]`` f32 -> f32; operands in ``compute_dtype``."""
        w = self.kernel.to(compute_dtype).permute(4, 3, 0, 1, 2)
        pad = tuple(k // 2 for k in self.kernel.shape[:3])
        out = F.conv3d(x.to(compute_dtype).permute(0, 4, 1, 2, 3), w, padding=pad)
        return out.permute(0, 2, 3, 4, 1).float()


class SPCDense3D(nn.Module):
    """Multi-branch dense completion block (reference ``layers.py:646-726``):
      x1 = f331(x); x2..x4 = f331/f553/f775(x1); t = x2+x3+x4;
      x5..x7 = f331/f553/f775(t); s = x1+..+x7;
      y0 = 1x1(s); y1..y3 = f331/f553/f775(x);
      out = x1 + y0 + y1 + y2 + y3
    each conv followed by BN + ReLU."""

    KERNELS = {
        "a1": (3, 3, 1), "a2": (3, 3, 1), "a3": (5, 5, 3), "a4": (7, 7, 5),
        "a5": (3, 3, 1), "a6": (5, 5, 3), "a7": (7, 7, 5), "ch1": (1, 1, 1),
        "r1": (3, 3, 1), "r2": (5, 5, 3), "r3": (7, 7, 5),
    }

    def __init__(self, ch: int):
        super().__init__()
        for name, k in self.KERNELS.items():
            self.add_module(f"{name}_conv", Conv3d(ch, k))
            self.add_module(f"{name}_bn", BatchNorm(ch))

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype):
        def cbr(y, name):
            y = getattr(self, f"{name}_conv")(y, compute_dtype)
            return torch.relu(getattr(self, f"{name}_bn")(y))

        x1 = cbr(x, "a1")
        x2, x3, x4 = cbr(x1, "a2"), cbr(x1, "a3"), cbr(x1, "a4")
        t = x2 + x3 + x4
        x5, x6, x7 = cbr(t, "a5"), cbr(t, "a6"), cbr(t, "a7")
        s = x1 + x2 + x3 + x4 + x5 + x6 + x7
        y0 = cbr(s, "ch1")
        y1, y2, y3 = cbr(x, "r1"), cbr(x, "r2"), cbr(x, "r3")
        return x1 + y0 + y1 + y2 + y3
