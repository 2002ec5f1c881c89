"""Loss primitives and the multiscale semantic-completion loss (counterpart
of ``pasco_tpu/loss/losses.py:21-136``), on padded static-shape tensors."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pasco_torch.loss.lovasz import lovasz_softmax


def weighted_cross_entropy(
    logits: torch.Tensor,      # [N, C]
    labels: torch.Tensor,      # [N] int
    valid: torch.Tensor,       # [N] bool (already excludes ignore_index)
    class_weight: Optional[torch.Tensor] = None,  # [C]
) -> torch.Tensor:
    """``torch.nn.CrossEntropyLoss(weight=w, reduction='mean')`` semantics:
    ``sum(w[y] * ce) / sum(w[y])`` over valid rows."""
    logp = F.log_softmax(logits.float(), dim=-1)
    lab = labels.long().clamp(0, logits.shape[-1] - 1)
    ce = -logp.gather(1, lab[:, None])[:, 0]
    w = valid.float() if class_weight is None else class_weight[lab] * valid
    return (ce * w).sum() / w.sum().clamp(min=1e-8)


def sigmoid_focal_loss(inputs: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Element-wise focal loss (reference ``losses.py:44-68``), unreduced."""
    prob = torch.sigmoid(inputs)
    ce = inputs.clamp(min=0) - inputs * targets + torch.log1p(torch.exp(-inputs.abs()))
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def dice_loss(inputs: torch.Tensor, targets: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Per-mask dice over voxels (reference ``losses.py:26-41``): ``[M]``."""
    v = valid[:, None].float()
    probs = torch.sigmoid(inputs) * v
    targets = targets * v
    numerator = 2 * (probs * targets).sum(0)
    denominator = probs.sum(0) + targets.sum(0)
    return 1 - (numerator + 1) / (denominator + 1)


def compl_labelweights(class_frequencies: np.ndarray,
                       power: float = 1.0 / 3.0) -> np.ndarray:
    """Completion class weights ``(max_freq / freq) ** power``."""
    f = class_frequencies / np.sum(class_frequencies)
    return np.power(np.amax(f) / f, power).astype(np.float32)


def sem_compl_loss_one(
    coords: torch.Tensor,        # [N, 4] int32 (b, x, y, z) stride-1 units
    valid: torch.Tensor,         # [N] bool
    sem_logits: torch.Tensor,    # [N, C] one subnet's completion logits
    target_dense: torch.Tensor,  # [X/s, Y/s, Z/s] int labels, 255 = unknown
    subnet_min: torch.Tensor,    # [3]
    subnet_max: torch.Tensor,    # [3]
    scale: int,
    weights: torch.Tensor,       # [C]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE (ignore 255) + Lovasz (ignore 255) of one subnet at one scale; the
    dense target is read at ``(coords - subnet_min) // scale``, voxels
    outside the subnet bbox are ignored."""
    c = coords[:, 1:]
    in_bbox = ((c >= subnet_min[None]) & (c <= subnet_max[None])).all(-1)
    hi = torch.tensor(target_dense.shape, device=c.device)[None, :] - 1
    rel = torch.minimum(torch.div(c - subnet_min[None], scale, rounding_mode="floor")
                        .clamp(min=0), hi).long()
    tgt = target_dense[rel[:, 0], rel[:, 1], rel[:, 2]].long()
    ok = valid & in_bbox & (tgt != 255)
    ce = weighted_cross_entropy(sem_logits, tgt, ok, weights)
    lov = lovasz_softmax(sem_logits, tgt, ok)
    return ce, lov


def compute_sem_compl_loss(
    sem_grids: Dict[int, object],               # scale -> SparseGrid
    sem_logits: Dict[int, torch.Tensor],        # scale -> [N, S, C]
    sem_labels: Dict[int, torch.Tensor],        # scale -> [S, X/s, Y/s, Z/s]
    subnet_min: torch.Tensor,                   # [S, 3]
    subnet_max: torch.Tensor,
    weights_at_scales: Dict[int, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE / Lovasz over every (scale, subnet) pair."""
    ces, lovs = [], []
    for scale, grid in sem_grids.items():
        logits = sem_logits[scale]
        for s in range(logits.shape[1]):
            ce, lov = sem_compl_loss_one(
                grid.coords, grid.mask, logits[:, s], sem_labels[scale][s],
                subnet_min[s], subnet_max[s], scale, weights_at_scales[scale])
            ces.append(ce)
            lovs.append(lov)
    return torch.stack(ces).mean(), torch.stack(lovs).mean()
