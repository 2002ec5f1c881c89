"""Lovasz-softmax over padded rows (counterpart of
``pasco_tpu/loss/lovasz.py:27-91``).

Invalid or ignored rows are zero-error, zero-foreground entries: they sort
to the tail and contribute nothing.  The errors of every class are sorted
descending by one stable ``torch.sort``; the Lovasz gradient of the sorted
foreground is a constant under autograd, so the loss ``dot(err_sorted, w)``
has the value and gradient of the reference's sort-free form.
"""

from __future__ import annotations

from typing import Sequence

import torch


def lovasz_grad(fg_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovasz extension w.r.t. sorted errors (Alg. 1 of
    arXiv:1705.08790), batched over a leading class axis."""
    gts = fg_sorted.sum(-1, keepdim=True)
    intersection = gts - fg_sorted.cumsum(-1)
    union = gts + (1.0 - fg_sorted).cumsum(-1)
    jaccard = 1.0 - intersection / union.clamp(min=1e-12)
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], -1)


def lovasz_softmax(
    logits: torch.Tensor,       # [N, C]
    labels: torch.Tensor,       # [N] int
    valid: torch.Tensor,        # [N] bool
    ignore_classes: Sequence[int] = (),
    classes: str = "present",
) -> torch.Tensor:
    """Multi-class Lovasz-softmax over the valid rows; ``'present'``
    averages the classes with foreground rows only."""
    c = logits.shape[-1]
    cls = torch.tensor([k for k in range(c) if k not in ignore_classes],
                       device=logits.device)
    probs = torch.softmax(logits.float(), dim=-1)
    fg = ((labels[None, :] == cls[:, None]) & valid[None, :]).float()   # [K, N]
    err = (fg - probs.T[cls]).abs() * valid.float()[None, :]
    err_sorted, order = torch.sort(err, dim=1, descending=True, stable=True)
    w = lovasz_grad(fg.gather(1, order))        # constant: fg carries no grad
    losses = (err_sorted * w).sum(1)
    if classes == "present":
        present = fg.sum(1) > 0
        denom = present.float().sum().clamp(min=1.0)
        return torch.where(present, losses, torch.zeros_like(losses)).sum() / denom
    return losses.mean()
