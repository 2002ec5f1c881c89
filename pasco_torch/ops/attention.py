"""Masked attention for the mask transformer (counterpart of
``pasco_tpu/ops/attention.py``; XLA in the reference, plain PyTorch here).

Cross-attention keeps the reference's numerics: queries, keys and values
in bf16, scores and the softmax in f32, the probabilities rounded to bf16
for the value product, KV streamed in chunks with an online softmax, and
queries whose allowed set is empty attending every key
(``attention.py:52-54``).  Products of bf16 operands are formed in f32, so
they are exact and sum in f32 as the reference's
``preferred_element_type=float32`` does.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _bf16_f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def masked_cross_attention(
    q: torch.Tensor,        # [Q, D]
    k: torch.Tensor,        # [N, D]
    v: torch.Tensor,        # [N, D]
    allowed: torch.Tensor,  # [N, Q] bool: key n may attend query q
    num_heads: int,
    chunk: int = 8192,
) -> torch.Tensor:
    nq, d = q.shape
    n = k.shape[0]
    dh = d // num_heads
    qh = _bf16_f32(q).reshape(nq, num_heads, dh).transpose(0, 1)   # [H, Q, dh]
    kh = _bf16_f32(k).reshape(n, num_heads, dh).permute(1, 2, 0)   # [H, dh, N]
    vh = _bf16_f32(v).reshape(n, num_heads, dh).transpose(0, 1)    # [H, N, dh]
    scale = dh ** -0.5
    any_allowed = allowed.any(dim=0)
    allowed = allowed | ~any_allowed[None, :]

    chunk = min(chunk, max(128, -(-n // 128) * 128))
    m = torch.full((num_heads, nq), NEG_INF, device=q.device)
    l = torch.zeros((num_heads, nq), device=q.device)
    acc = torch.zeros((num_heads, nq, dh), device=q.device)
    for s0 in range(0, n, chunk):
        s = (qh @ kh[:, :, s0 : s0 + chunk]) * scale                # [H, Q, c]
        s = torch.where(allowed[s0 : s0 + chunk].T[None], s,
                        torch.full((), NEG_INF, device=s.device))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _bf16_f32(p) @ vh[:, s0 : s0 + chunk]
        m = m_new
    out = acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    return out.transpose(0, 1).reshape(nq, d).to(q.dtype)


def self_attention(q, k, v, num_heads: int) -> torch.Tensor:
    """Dense f32 self-attention over the (small) query set."""
    nq, d = q.shape
    dh = d // num_heads
    qh, kh, vh = (t.reshape(nq, num_heads, dh).transpose(0, 1) for t in (q, k, v))
    p = torch.softmax((qh @ kh.transpose(1, 2)) * dh ** -0.5, dim=-1)
    return (p @ vh).transpose(0, 1).reshape(nq, d)
