"""Dense completion bottleneck at stride 8 (counterpart of
``pasco_tpu/models/bottleneck.py:148-251``: ``_Conv3d``, ``SPCDense3D`` and
the sparse substrate's ``DenseBottleneck``).

The reference runs these anisotropic convs as XLA, not Pallas.  At
inference on the card (a CUDA input, the module in eval mode, no gradient
required, bf16 operands) ``SPCDense3D`` runs its whole body as the
hand-written kernel ``ops/spc_dense3d.py`` (four launches, each BN folded
to an affine on the f32 conv sum); in training, on the CPU and at a float32
compute dtype it composes ``F.conv3d``, BatchNorm and ReLU as the reference
does.  Volumes are ``[B, X, Y, Z, C]`` here (the reference module's ``[X,
Y, Z, C]`` with the scans of a batch in front), and each conv runs once
over the batch at N = B.  A conv's output and each BatchNorm's keep the
input's dtype, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pasco_torch.core.sparse import Box, SparseGrid, from_dense, to_dense
from pasco_torch.models.blocks import add_dropout, apply_dropout
from pasco_torch.models.norm import BatchNorm
from pasco_torch.ops.spc_dense3d import pack_affines, spc_dense3d


class Conv3d(nn.Module):
    """Bias-free channels-last 3D conv with 'same' anisotropic padding;
    ``kernel`` is ``[kx, ky, kz, Ci, Co]`` as in flax."""

    def __init__(self, ch: int, kernel):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros((*kernel, ch, ch)))

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype):
        """``x [B, X, Y, Z, C]`` -> ``x``'s dtype; operands in
        ``compute_dtype``, f32 accumulation."""
        w = self.kernel.to(compute_dtype).permute(4, 3, 0, 1, 2)
        pad = tuple(k // 2 for k in self.kernel.shape[:3])
        out = F.conv3d(x.to(compute_dtype).permute(0, 4, 1, 2, 3), w, padding=pad)
        return out.permute(0, 2, 3, 4, 1).to(x.dtype)


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
        self._affines = None   # (stamp of the BN tensors, pack_affines(...))

    def takes_kernel(self, x: torch.Tensor, compute_dtype: torch.dtype) -> bool:
        """Whether this call runs as the kernel: a CUDA input, eval mode,
        bf16 operands and no gradient required."""
        return (x.is_cuda and not self.training and compute_dtype == torch.bfloat16
                and not (torch.is_grad_enabled()
                         and (x.requires_grad or any(p.requires_grad for p in self.parameters()))))

    def affines(self):
        """Every BN's running-statistics affine, packed for the kernel; made
        again whenever a BN tensor was replaced or updated in place (its
        version counter moves, as under ``load_state_dict``)."""
        bns = [getattr(self, f"{n}_bn") for n in self.KERNELS]
        stamp = tuple((id(t), t._version, t.data_ptr())
                      for bn in bns for t in (bn.scale, bn.bias, bn.mean, bn.var))
        if self._affines is None or self._affines[0] != stamp:
            with torch.no_grad():
                packed = pack_affines({n: bn.affine() for n, bn in zip(self.KERNELS, bns)})
            self._affines = (stamp, packed)
        return self._affines[1]

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype):
        if self.takes_kernel(x, compute_dtype):
            xk = x.permute(0, 1, 3, 2, 4).to(torch.bfloat16).contiguous()   # [B, X, Z, Y, C]
            weights = {n: getattr(self, f"{n}_conv").kernel for n in self.KERNELS}
            out = spc_dense3d(xk, weights, self.affines())
            return out.permute(0, 1, 3, 2, 4).to(x.dtype)

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


class DenseBottleneck(nn.Module):
    """The sparse substrate's bottleneck (``bottleneck.py:220-251``): the
    stride-8 grid densified over the whole working box, ``SPCDense3D``,
    the whole-channel dropout (``dense3d_dropout``), then every cell with a
    non-zero channel back as a grid of ``out_capacity`` rows."""

    def __init__(self, ch: int, out_capacity: int, dropout: float = 0.0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.out_capacity, self.compute_dtype = out_capacity, compute_dtype
        self.spc = SPCDense3D(ch)
        add_dropout(self, "Dropout_0", dropout, "dense_bottleneck/Dropout_0")

    def forward(self, grid: SparseGrid, box: Box, generator=None,
                drop_on: bool = False) -> SparseGrid:
        dense = to_dense(grid, box, batch_size=1)
        dense = self.spc(dense, self.compute_dtype or dense.dtype)
        dense = apply_dropout(self, "Dropout_0", dense, generator, drop_on)
        return from_dense(dense, box, grid.stride, self.out_capacity)
