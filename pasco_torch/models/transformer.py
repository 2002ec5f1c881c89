"""Mask2Former-style transformer predictor over padded sparse voxel sets
(counterpart of ``pasco_tpu/models/transformer.py:43-286``).

The attention layers' parameters are shared by every subnet
(``transformer.py:255-272``); subnets run one after another.  The grids
carry a batch of scans in front (``[B, S, cap, ...]``, the batched forward;
``B = 1`` for one scan): each subnet's attention runs on all ``B`` scans at
once, as batched products in which every scan's queries attend only its
own voxels, and the outputs keep ``[B, S, ...]``.  Where the
caller says the dropout is live (training, or MC dropout at inference,
``transformer.py:194-200``) the residual branches take ``cfg.dropout``
(0.0 in the flagship), with draws from the caller's generator.  The
sparse sine positional embedding keeps the reference's degenerate
"normalize" (``x / (x + eps) * 2*pi``) for parity.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from pasco_torch.core.sparse import Box, SparseGrid, build_dense_table, lookup_dense_table
from pasco_torch.models.blocks import MLP
from pasco_torch.ops.attention import masked_cross_attention, self_attention

LN_EPS = 1e-6    # flax LayerNorm default


def dropout(x: torch.Tensor, rate: float, live: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate``, rescaled."""
    if rate == 0.0 or not live:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def sine_position_encoding(coords: torch.Tensor, num_pos_feats: int,
                           temperature: float = 10000.0) -> torch.Tensor:
    """Sparse sine PE on ``[..., N, 3]`` integer coordinates -> ``[..., N, 3*npf]``."""
    c = coords.float()
    c = c / (c + 1e-6) * (2 * math.pi)
    half = torch.arange(num_pos_feats // 2, dtype=torch.float32,
                        device=coords.device)
    dim_h = temperature ** (2 * half / num_pos_feats)
    pos = c[..., None] / dim_h
    pe = torch.cat([torch.sin(pos), torch.cos(pos)], dim=-1)
    return pe.reshape(*coords.shape[:-1], 3 * num_pos_feats)


class PredictorOutput(NamedTuple):
    query_logits: torch.Tensor        # [S, Q, n_classes + 1] ([B, S, ...] for a batch)
    voxel_logits: torch.Tensor        # [S, cap1, Q]
    aux: List[Tuple[torch.Tensor, torch.Tensor]]


class CrossAttentionLayer(nn.Module):
    """Pre-norm masked cross-attention; the residual adds onto the normed
    queries (reference ``blocks.py:48-91``)."""

    def __init__(self, hidden_dim: int, num_heads: int, kv_chunk: int,
                 rate: float = 0.0):
        super().__init__()
        self.num_heads, self.kv_chunk, self.rate = num_heads, kv_chunk, rate
        self.norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, nn.Linear(hidden_dim, hidden_dim))

    def forward(self, q_embed, src, allowed, pos, query_pos, generator=None, live=False):
        x = self.norm(q_embed)
        q = self.q_proj(x + query_pos)
        k = self.k_proj(src + pos)
        v = self.v_proj(src + pos)
        out = masked_cross_attention(q, k, v, allowed, self.num_heads,
                                     chunk=self.kv_chunk)
        return x + dropout(self.out_proj(out), self.rate, live, generator)


class SelfAttentionLayer(nn.Module):
    """Post-norm query self-attention (reference ``blocks.py:9-45``)."""

    def __init__(self, hidden_dim: int, num_heads: int, rate: float = 0.0):
        super().__init__()
        self.num_heads, self.rate = num_heads, rate
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, nn.Linear(hidden_dim, hidden_dim))
        self.norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)

    def forward(self, q_embed, query_pos, generator=None, live=False):
        q = self.q_proj(q_embed + query_pos)
        k = self.k_proj(q_embed + query_pos)
        v = self.v_proj(q_embed)
        out = self.out_proj(self_attention(q, k, v, self.num_heads))
        out = dropout(out, self.rate, live, generator)
        return self.norm(q_embed + out)


class FFNLayer(nn.Module):
    """Pre-norm FFN with the residual on the normed stream."""

    def __init__(self, hidden_dim: int, dim_feedforward: int, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.fc1 = nn.Linear(hidden_dim, dim_feedforward)
        self.fc2 = nn.Linear(dim_feedforward, hidden_dim)

    def forward(self, x, generator=None, live=False):
        y = self.norm(x)
        h = dropout(torch.relu(self.fc1(y)), self.rate, live, generator)
        return y + dropout(self.fc2(h), self.rate, live, generator)


def downscale_attn_allowed(mask_pred: torch.Tensor, grid1: SparseGrid,
                           grid_s: SparseGrid, box: Box,
                           scale: int) -> torch.Tensor:
    """Allowed[n_s, q] = any scale-1 child of voxel n_s has sigmoid > 0.5.
    Grids with leading axes (``[B, N, 4]``, ``mask_pred [B, N1, Q]``, a
    ``[B, 3]`` box corner) give one ``[N_s, Q]`` set per scan."""
    keep = (torch.sigmoid(mask_pred) > 0.5) & grid1.mask[..., None]
    if scale == 1:
        return keep
    step = grid1.stride * scale
    parent_xyz = torch.div(grid1.coords[..., 1:], step, rounding_mode="floor") * step
    parents = torch.cat([grid1.coords[..., :1], parent_xyz], dim=-1)
    table = build_dense_table(grid_s.coords, grid_s.mask, box, grid_s.stride)
    row, found = lookup_dense_table(table, parents, grid1.mask, box, grid_s.stride)
    cap, nq = grid_s.capacity, keep.shape[-1]
    lead = keep.shape[:-2]
    row = torch.where(found, row, torch.full_like(row, cap)).long()
    # scan e's rows of `hits` follow those of the scans before it
    first = torch.arange(math.prod(lead), device=row.device) * (cap + 1)
    row = row + first.reshape(*lead, 1)
    hits = torch.zeros((math.prod(lead) * (cap + 1), nq), dtype=torch.int32,
                       device=keep.device)
    hits.index_add_(0, row.reshape(-1), keep.reshape(-1, nq).to(torch.int32))
    hits = hits.reshape(*lead, cap + 1, nq)
    return (hits[..., :cap, :] > 0) & grid_s.mask[..., None]


class TransformerPredictor(nn.Module):
    def __init__(self, cfg, n_classes: int, n_infers: int,
                 in_channels: Tuple[int, ...]):
        super().__init__()
        H, Q = cfg.hidden_dim, cfg.num_queries
        self.cfg, self.n_infers = cfg, n_infers
        self.query_feat = nn.Parameter(torch.zeros((n_infers, Q, H)))
        self.query_embed = nn.Parameter(torch.zeros((n_infers, Q, H)))
        self.mask_feat_proj = nn.Linear(in_channels[-1], H)
        self.decoder_norm = nn.LayerNorm(H, eps=LN_EPS)
        self.class_embed = nn.Linear(H, n_classes + 1)
        self.mask_embed = MLP(H, H, H, 3)
        for i, _ in enumerate(cfg.src_scales):
            self.add_module(f"input_proj_{i}", nn.Linear(in_channels[i], H))
            self.add_module(f"cross_{i}", CrossAttentionLayer(
                H, cfg.num_heads, cfg.kv_chunk, cfg.dropout))
            self.add_module(f"self_{i}", SelfAttentionLayer(H, cfg.num_heads, cfg.dropout))
            self.add_module(f"ffn_{i}", FFNLayer(H, cfg.dim_feedforward, cfg.dropout))

    def forward(self, panop_grids: Dict[int, SparseGrid], box: Box,
                generator: Optional[torch.Generator] = None,
                live: bool = False) -> PredictorOutput:
        """``panop_grids``: scale -> grid of ``[B, S, cap, ...]`` (``box``
        minimum ``[B, 3]``); the outputs are ``[B, S, ...]``.  The
        ``B * S`` (scan, subnet) rows run as one group ``G`` wherever
        nothing reads across rows (the projections, the heads, the FFN)."""
        cfg = self.cfg
        S = self.n_infers
        npf = cfg.hidden_dim // 3
        grid1 = panop_grids[1]
        B = grid1.coords.shape[0]
        G = B * S

        def rows(t):   # [B, S, ...] -> [G, ...]
            return t.reshape(G, *t.shape[2:])

        def subnet(g: SparseGrid, s: int) -> SparseGrid:   # subnet s of every scan
            return SparseGrid(g.coords[:, s], g.feats[:, s], g.mask[:, s], g.stride)

        mask1 = rows(grid1.mask)
        pe1 = sine_position_encoding(rows(grid1.coords)[..., 1:], npf)
        voxel_feat = self.mask_feat_proj(rows(grid1.feats).float()) + pe1
        voxel_feat = torch.where(mask1[..., None], voxel_feat,
                                 torch.zeros((), device=voxel_feat.device))

        def pred_heads(output):
            dec = self.decoder_norm(output)
            cls = self.class_embed(dec)
            emb = self.mask_embed(dec)
            msk = torch.einsum("sqc,spc->spq", emb, voxel_feat)
            msk = torch.where(mask1[..., None], msk,
                              torch.zeros((), device=msk.device))
            return cls, msk

        output = self.query_feat if B == 1 else self.query_feat.repeat(B, 1, 1)   # [G, Q, H]
        cls, msk = pred_heads(output)
        preds_class, preds_mask = [cls], [msk]
        for i, scale in enumerate(cfg.src_scales):
            grid_s = panop_grids[scale]
            src = getattr(self, f"input_proj_{i}")(grid_s.feats.float())   # [B, S, cap, H]
            out4 = output.reshape(B, S, *output.shape[1:])
            mask_pred = preds_mask[-1].reshape(B, S, *preds_mask[-1].shape[1:])
            outs = []
            for s in range(S):
                gs = subnet(grid_s, s)
                pos_s = sine_position_encoding(gs.coords[..., 1:], npf)
                pos_s = torch.where(gs.mask[..., None], pos_s,
                                    torch.zeros((), device=pos_s.device))
                allowed = downscale_attn_allowed(
                    mask_pred[:, s], subnet(grid1, s), gs, box, scale)
                o = getattr(self, f"cross_{i}")(
                    out4[:, s], src[:, s], allowed, pos_s, self.query_embed[s], generator,
                    live)
                outs.append(getattr(self, f"self_{i}")(o, self.query_embed[s], generator,
                                                         live))
            output = getattr(self, f"ffn_{i}")(rows(torch.stack(outs, 1)), generator, live)
            cls, msk = pred_heads(output)
            preds_class.append(cls)
            preds_mask.append(msk)

        def scans(t):   # [G, ...] -> [B, S, ...]
            return t.reshape(B, S, *t.shape[1:])

        return PredictorOutput(
            query_logits=scans(preds_class[-1]),
            voxel_logits=scans(preds_mask[-1]),
            aux=[(scans(c), scans(m)) for c, m in zip(preds_class[:-1], preds_mask[:-1])],
        )
