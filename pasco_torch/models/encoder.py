"""Sparse 4-stage encoder, strides 1 -> 2 -> 4 -> 8 (counterpart of
``pasco_tpu/models/encoder.py``, ``Encoder3DSepV2`` of the reference):

* ``heavy_decoder=False`` (the released config): each stage is a ks=2,
  stride-2 down block followed by ``res_blocks`` (3) residual blocks on one
  shared rulebook;
* ``heavy_decoder=True``: each stage is the down block and a whole-channel
  spatial dropout (live under ``drop_on``).
"""

from __future__ import annotations

from typing import List, Optional

from torch import nn

from pasco_torch.core.config import CapacityConfig, ModelConfig
from pasco_torch.core.sparse import Box, SparseGrid
from pasco_torch.models.blocks import (
    BasicConvBlock, ResidualBlock, SparseConv, add_dropout, apply_dropout, compute_dtype_of)
from pasco_torch.ops.sparse_conv import build_rulebook

STAGES = (("s1s2", 2), ("s2s4", 4), ("s4s8", 8))


class Encoder(nn.Module):
    """Returns the per-scale grids ``[s1, s2, s4, s8]``."""

    def __init__(self, cfg: ModelConfig, cap: CapacityConfig):
        super().__init__()
        f = cfg.f_maps
        cd = compute_dtype_of(cfg)
        self.heavy = cfg.heavy_decoder
        self.n_res = 0 if self.heavy else (cfg.res_blocks if cfg.res_blocks is not None else 3)
        self.in_conv = SparseConv(cfg.n_infers * cfg.f, f[0], 1, compute_dtype=cd)
        for i in range(self.n_res):
            self.add_module(f"s1_res{i}", ResidualBlock(f[0], f[0], compute_dtype=cd))
        for si, (name, stride) in enumerate(STAGES):
            self.add_module(f"{name}_down", BasicConvBlock(
                f[si], f[si + 1], cap.enc_capacity(stride), compute_dtype=cd))
            if self.heavy:
                add_dropout(self, f"{name}_drop", cfg.encoder_dropouts[si - 3],
                            f"encoder/{name}_drop")
            for i in range(self.n_res):
                self.add_module(f"{name}_res{i}",
                                ResidualBlock(f[si + 1], f[si + 1], compute_dtype=cd))

    def _res_stack(self, x: SparseGrid, box: Box, prefix: str, generator) -> SparseGrid:
        if self.n_res:
            rb = build_rulebook(x.coords, x.mask, box, x.stride, 3)
            for i in range(self.n_res):
                x = getattr(self, f"{prefix}_res{i}")(x, box, rb, generator)
        return x

    def forward(self, grid: SparseGrid, box: Box, generator=None,
                drop_on: Optional[bool] = None) -> List[SparseGrid]:
        if drop_on is None:
            drop_on = self.training
        x = self._res_stack(self.in_conv(grid, box), box, "s1", generator)
        out = [x]
        for name, _ in STAGES:
            x = getattr(self, f"{name}_down")(x, box)
            x = x.with_feats(apply_dropout(self, f"{name}_drop", x.feats, generator, drop_on))
            x = self._res_stack(x, box, name, generator)
            out.append(x)
        return out
