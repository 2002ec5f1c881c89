"""Generative sparse decoder with per-scale occupancy caps (counterpart of
``pasco_tpu/models/decoder.py``, ``DecoderGenerativeSepConvV2`` of the
reference).

Three blocks take the stride-8 bottleneck grid back to stride 1.  At each
scale the per-subnet heads decide which voxels stay (any subnet's argmax
not empty), capped at the scale's static capacity by top-k compaction of
the best subnet's weighted probability; in training mode Gumbel noise on
the log-score turns the top-k into weighted sampling without replacement
(the reference's ``torch.multinomial``).  The noise comes from the
caller's generator, so it never equals the reference's: at caps that do
not bind it only reorders the kept rows.

The per-subnet refiners (``predict_panop``) run on each subnet's own
top-k compaction; their weights and BatchNorm rows carry a leading subnet
axis, as flax's ``nn.vmap`` lays them out.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from pasco_torch.core.config import CapacityConfig, ModelConfig
from pasco_torch.core.sparse import (
    Box, SparseGrid, build_dense_table, compact, lookup_dense_table, prune_outside_box,
    stack_grids, top_k_compact, where_valid)
from pasco_torch.models.blocks import (
    ConvParams, ResidualBlock, SparseConv, SparseGenerativeDeconv, add_dropout,
    apply_dropout, compute_dtype_of, masked_bn)
from pasco_torch.ops.sparse_conv import build_rulebook, lookup_features, submanifold_conv3d
from pasco_torch.utils import timing


def union_skip(g: SparseGrid, skip: SparseGrid, box: Box) -> SparseGrid:
    """``skip``'s cells absent from ``g`` written into ``g``'s free rows
    (rank ``r`` free row <- rank ``r`` absent cell; the surplus beyond the
    free rows is dropped).  With the preceding per-cell add of the skip
    features this is MinkowskiEngine's union-add ``dec + shortcut``."""
    table = build_dense_table(g.coords, g.mask, box, g.stride)
    _, found = lookup_dense_table(table, skip.coords, skip.mask, box, g.stride)
    extra = skip.mask & ~found
    cap = g.capacity
    dev = extra.device
    free = ~g.mask
    n_free = free.sum()
    free_rank = torch.cumsum(free.int(), 0) - 1
    slot_of_rank = torch.zeros(cap + 1, dtype=torch.long, device=dev)
    slot_of_rank[torch.where(free, free_rank, cap)] = torch.arange(cap, device=dev)
    extra_rank = torch.cumsum(extra.int(), 0) - 1
    dest = torch.where(extra & (extra_rank < n_free),
                       slot_of_rank[extra_rank.clamp(0, cap - 1)], cap)
    coords = torch.cat([g.coords, g.coords.new_zeros(1, 4)]).index_put((dest,), skip.coords)
    feats = torch.cat([g.feats, g.feats.new_zeros(1, g.num_channels)]).index_put(
        (dest,), skip.feats.to(g.feats.dtype))
    mask = torch.cat([g.mask, g.mask.new_zeros(1)]).index_put(
        (dest,), torch.ones_like(dest, dtype=torch.bool))
    return SparseGrid(coords[:cap], feats[:cap], mask[:cap], g.stride)


class DecoderOutput(NamedTuple):
    xs: Dict[int, SparseGrid]                 # scale -> kept voxels
    sem_logits: Dict[int, torch.Tensor]       # scale -> [cap, S, n_classes] f32
    panop_grids: Dict[int, SparseGrid]        # scale -> refined per-subnet [S, cap, ...]
    sem_logits_pruned: torch.Tensor           # [S, panop_s1, n_classes] f32


class DecoderBlock(nn.Module):
    """One generative upsampling block (``decoder_v3.py:77-172``): deconv
    + BN + LeakyReLU, prune to the global bbox, normalised coords as three
    more channels, BN + 1x1 resize, the encoder skip (added where the
    cell exists, appended where it does not), the residual stack, the
    spatial dropout and the per-subnet 1x1 heads."""

    def __init__(self, in_channels: int, out_channels: int, n_infers: int, n_classes: int,
                 num_res_blocks: int, dropout: float = 0.0,
                 ups_capacity: Optional[int] = None, compute_dtype=None, name: str = ""):
        super().__init__()
        self.ups_capacity, self.n_res = ups_capacity, num_res_blocks
        ch = out_channels
        self.up = SparseGenerativeDeconv(in_channels, ch, compute_dtype=compute_dtype)
        self.up_bn = masked_bn(ch)
        self.resize_bn = masked_bn(ch + 3)
        self.resize = SparseConv(ch + 3, ch, 1, compute_dtype=compute_dtype)
        for i in range(num_res_blocks):
            self.add_module(f"res{i}", ResidualBlock(ch, ch, compute_dtype=compute_dtype))
        add_dropout(self, "drop", dropout, f"{name}/drop")
        self.head_kernel = nn.Parameter(torch.zeros((n_infers, ch, n_classes)))
        self.head_bias = nn.Parameter(torch.zeros((n_infers, n_classes)))

    def forward(self, x: SparseGrid, skip: SparseGrid, box: Box, bbox_min, bbox_max,
                generator=None, drop_on: bool = False):
        g = self.up(x)
        g = g.with_feats(where_valid(g.mask, F.leaky_relu(self.up_bn(g.feats, g.mask),
                                                              0.01)))
        g = prune_outside_box(g, bbox_min, bbox_max)
        if self.ups_capacity is not None and self.ups_capacity < g.capacity:
            g = compact(g, g.mask, self.ups_capacity)
        norm_c = (g.coords[:, 1:].float() / g.stride).to(g.feats.dtype)
        fc = torch.cat([g.feats, where_valid(g.mask, norm_c)], -1)
        g = self.resize(g.with_feats(self.resize_bn(fc, g.mask)), box)
        skip_f, _ = lookup_features(skip, g.coords, g.mask, box)
        g = union_skip(g.with_feats(g.feats + skip_f.to(g.feats.dtype)), skip, box)
        rb = build_rulebook(g.coords, g.mask, box, g.stride, 3)
        for i in range(self.n_res):
            g = getattr(self, f"res{i}")(g, box, rb, generator)
        g = g.with_feats(apply_dropout(self, "drop", g.feats, generator, drop_on))
        sem = torch.einsum("nc,sck->nsk", g.feats.float(), self.head_kernel.float())
        sem = sem + self.head_bias
        return g, torch.where(g.mask[:, None, None], sem, torch.zeros((), device=sem.device))


class VoxelFeatsRefiner(nn.Module):
    """Two-conv refiner of each subnet's voxels (``decoder_v3.py:266-283``):
    conv1 (no bias), BN, ReLU, conv2; parameters with a leading subnet axis."""

    def __init__(self, ch: int, n_infers: int, compute_dtype=None):
        super().__init__()
        S = n_infers
        self.compute_dtype = compute_dtype
        self.conv1 = ConvParams((S, 27, ch, ch))
        self.bn = masked_bn((S, ch))
        self.conv2 = ConvParams((S, 27, ch, ch), (S, ch))

    def forward(self, grid: SparseGrid, box: Box, s: int) -> SparseGrid:
        rb = build_rulebook(grid.coords, grid.mask, box, grid.stride, 3)
        cd = self.compute_dtype
        g = submanifold_conv3d(grid, box, self.conv1.kernel[s], None, cd, rb)
        f = torch.relu(self.bn(g.feats, g.mask, index=s))
        return submanifold_conv3d(g.with_feats(where_valid(g.mask, f)), box,
                                  self.conv2.kernel[s], self.conv2.bias[s], cd, rb)


def occupancy_keep_scores(sem_logits: torch.Tensor, mask: torch.Tensor,
                          compl_labelweights: Optional[torch.Tensor]):
    """``(keep, score)``: keep where any subnet's argmax class is not empty;
    score = the best subnet's max probability times its class weight
    (``decoder_v3.py:319-394``)."""
    probs = torch.softmax(sem_logits, -1)
    top_prob, top_class = probs.amax(-1), probs.argmax(-1)
    nonempty = top_class != 0
    keep = nonempty.any(-1) & mask
    w = top_prob * nonempty
    if compl_labelweights is not None:
        w = w * compl_labelweights.to(w.device)[top_class]
    return keep, w.amax(-1)


def gumbel(shape, generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


class GenerativeDecoder(nn.Module):
    """Blocks s8 -> s4 -> s2 -> s1 with the per-scale caps, then the
    per-subnet panoptic grids."""

    def __init__(self, cfg: ModelConfig, cap: CapacityConfig):
        super().__init__()
        self.cfg, self.cap = cfg, cap
        cd = compute_dtype_of(cfg)
        dec_ch = cfg.f_maps[::-1]
        n_res = cfg.res_blocks if cfg.res_blocks is not None else (
            7 if cfg.heavy_decoder else 3)
        for i, scale in enumerate((4, 2, 1)):
            self.add_module(f"block_s{scale}", DecoderBlock(
                dec_ch[i], dec_ch[i + 1], cfg.n_infers, cfg.n_classes, n_res,
                cfg.decoder_dropouts[i], cap.ups_s4 if scale == 4 else None, cd,
                f"decoder/block_s{scale}"))
        for i, scale in enumerate((4, 2, 1)):
            self.add_module(f"voxel_feats_s{scale}",
                            VoxelFeatsRefiner(dec_ch[i + 1], cfg.n_infers, cd))

    def forward(self, x: SparseGrid, enc_feats: List[SparseGrid], box: Box, bbox_min, bbox_max,
                subnet_bbox_min, subnet_bbox_max,
                compl_labelweights: Optional[Dict[int, torch.Tensor]] = None,
                generator=None, is_predict_panop: bool = True,
                drop_on: bool = False) -> DecoderOutput:
        cfg = self.cfg
        S, C = cfg.n_infers, cfg.n_classes
        skips = enc_feats[::-1]
        xs: Dict[int, SparseGrid] = {}
        sem_at: Dict[int, torch.Tensor] = {}
        for i, scale in enumerate((4, 2, 1)):
            with timing.span(f"decoder.s{scale}"):
                x, sem = getattr(self, f"block_s{scale}")(
                    x, skips[i], box, bbox_min, bbox_max, generator, drop_on)
                w = None if compl_labelweights is None else compl_labelweights.get(scale)
                keep, score = occupancy_keep_scores(sem, x.mask, w)
                score = torch.log(score.clamp(min=1e-20))
                if self.training:
                    score = score + gumbel(score.shape, generator, score.device)
                capacity = self.cap.dec_capacity(scale)
                ch = x.num_channels
                # the logits ride with the features, in the features' dtype
                carry = torch.cat([x.feats, sem.reshape(x.capacity, -1).to(x.feats.dtype)], -1)
                packed = top_k_compact(x.with_feats(carry), score, keep, capacity)
                x = packed.with_feats(packed.feats[:, :ch])
                xs[scale] = x
                sem_at[scale] = packed.feats[:, ch:].float().reshape(capacity, S, C)

        panop_grids: Dict[int, SparseGrid] = {}
        sem_pruned = torch.zeros((S, self.cap.panop_s1, C), device=x.feats.device)
        for scale in (4, 2, 1) if is_predict_panop else ():
            with timing.span(f"refiner.s{scale}"):
                g, sem = xs[scale], sem_at[scale]
                top_prob = torch.softmax(sem, -1).amax(-1)                  # [N, S]
                top_class = sem.argmax(-1)
                c = g.coords[None, :, 1:]
                in_bbox = ((c >= subnet_bbox_min[:, None, :])
                           & (c <= subnet_bbox_max[:, None, :])).all(-1)     # [S, N]
                keeps = (top_class.T != 0) & in_bbox & g.mask[None, :]
                pcap = self.cap.panop_capacity(scale)
                ch = g.num_channels
                refiner = getattr(self, f"voxel_feats_s{scale}")
                refined, carried = [], []
                for s in range(S):
                    carry = torch.cat([g.feats, sem[:, s].to(g.feats.dtype)], -1)
                    p = top_k_compact(g.with_feats(carry), top_prob[:, s], keeps[s], pcap)
                    coords = p.coords.clone()
                    coords[:, 0] = s
                    refined.append(refiner(SparseGrid(coords, p.feats[:, :ch], p.mask,
                                                      p.stride), box, s))
                    carried.append(p.feats[:, ch:].float())
                panop_grids[scale] = stack_grids(refined)
                if scale == 1:
                    sem_pruned = torch.stack(carried)
        return DecoderOutput(xs, sem_at, panop_grids, sem_pruned)
