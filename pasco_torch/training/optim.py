"""Optimizer and LR schedule (counterpart of
``pasco_tpu/training/optim.py:25-67``): ``optax.chain(clip_by_global_norm
(0.5), adamw(mu_dtype=bfloat16))`` written out, so that it updates as
optax does.

* The clip is optax's: ``g`` where ``|g| < max_norm`` else
  ``g / |g| * max_norm`` (``clip_grad_norm_`` adds ``1e-6``; this does not).
* The first moment is kept in bf16 (``torch.optim.AdamW`` keeps it in
  f32) and updated as optax's ``update_moment`` updates it:
  ``mu' = (1 - b1) * g + b1 * mu`` where ``b1 * mu`` is a bf16 product, so
  ``b1`` itself rounds to bf16 (0.9 -> 0.8984375), and the sum is f32; the
  bias-corrected step reads that f32 sum, the state keeps its bf16
  rounding.
* Weight decay is added to the Adam direction before the learning rate
  (``add_decayed_weights``), and the schedule reads the number of
  updates already taken, from 0.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable

import torch

from pasco_tpu.core.config import OptimConfig


def lr_schedule(cfg: OptimConfig, mode: str = "reference"):
    """Learning rate at update ``step`` (0-based): "reference" is the
    released constant LR with a x0.1 drop after 60k steps (optional linear
    warmup), "cosine" the intended warmup-cosine."""
    if mode == "reference":
        def fn(step: int) -> float:
            factor = 0.1 if step > 60000 else 1.0
            if cfg.warmup_steps > 0:
                factor *= min((step + 1) / cfg.warmup_steps, 1.0)
            return cfg.lr * factor
        return fn
    if mode == "cosine":
        def fn(step: int) -> float:
            warm = min((step + 1) / max(cfg.warmup_steps, 1), 1.0)
            t = min(max((step - cfg.warmup_steps)
                        / max(cfg.max_steps - cfg.warmup_steps, 1), 0.0), 1.0)
            cos = 0.01 + 0.5 * (1 - 0.01) * (math.cos(t * math.pi) + 1)
            return cfg.lr * warm * cos
        return fn
    raise ValueError(mode)


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """f32 L2 norm over every gradient (``optax.global_norm``)."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


class AdamW:
    """Clip-by-global-norm + AdamW with a bf16 first moment, over a dict of
    named parameters.  ``step`` updates the parameters in place (the port
    may, JAX may not) and returns the pre-clip gradient norm."""

    def __init__(self, params: Dict[str, torch.nn.Parameter], cfg: OptimConfig,
                 mode: str = "reference"):
        self.params = params
        self.cfg = cfg
        self.lr = lr_schedule(cfg, mode)
        self.count = 0
        self.mu = {k: torch.zeros_like(p, dtype=torch.bfloat16) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        b1, b2 = cfg.betas
        norm = global_norm(grads.values())
        scale = torch.where(norm < cfg.grad_clip, torch.ones_like(norm),
                            cfg.grad_clip / norm)
        lr = self.lr(self.count)
        self.count += 1
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        b1_bf16 = torch.tensor(b1, dtype=torch.bfloat16)
        for k, p in self.params.items():
            g = grads[k].float() * scale
            mu = (1 - b1) * g + (self.mu[k] * b1_bf16).float()
            nu = (1 - b2) * g.square() + b2 * self.nu[k]
            upd = (mu / c1) / (torch.sqrt(nu / c2) + 1e-8) + cfg.weight_decay * p
            p.add_(upd, alpha=-lr)
            self.mu[k] = mu.to(torch.bfloat16)
            self.nu[k] = nu
        return norm
