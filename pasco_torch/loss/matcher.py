"""Hungarian query<->target matching (counterpart of
``pasco_tpu/loss/matcher.py:24-161``).

The cost matrices (focal + dice + class costs over the queries and the
padded target slots) are computed on the device without autograd; the
assignment itself runs on the host through the native solver
(``pasco_tpu.native.linear_sum_assignment``, NumPy only), as the
reference's ``_host_assign`` does.  :func:`match_all` takes every cost
matrix of a step to the host in one transfer.  The reference's in-graph
JAX solver is not ported: the host solver is exact too.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from pasco_tpu import native


def batch_dice_cost(inputs, targets, valid):
    """Pairwise dice cost ``[Q, T]`` (reference ``matcher_sparse.py:12-27``)."""
    v = valid[:, None].float()
    probs = torch.sigmoid(inputs) * v
    targets = targets * v
    numerator = 2 * probs.T @ targets
    denominator = probs.sum(0)[:, None] + targets.sum(0)[None, :]
    return 1 - (numerator + 1) / (denominator + 1)


def batch_focal_cost(inputs, targets, valid, alpha: float = 0.25, gamma: float = 2.0):
    """Pairwise focal cost ``[Q, T]`` normalised by the valid voxel count
    (reference ``matcher_sparse.py:30-66``)."""
    v = valid[:, None].float()
    prob = torch.sigmoid(inputs)
    softplus_neg = torch.log1p(torch.exp(-inputs.abs()))
    pos_ce = inputs.clamp(min=0) - inputs + softplus_neg
    neg_ce = inputs.clamp(min=0) + softplus_neg
    focal_pos = ((1 - prob) ** gamma) * pos_ce * alpha * v
    focal_neg = (prob ** gamma) * neg_ce * (1 - alpha) * v
    cost = focal_pos.T @ (targets * v) + focal_neg.T @ ((1 - targets) * v)
    return cost / valid.float().sum().clamp(min=1.0)


@torch.no_grad()
def match_cost(query_logits, voxel_logits, tgt_onehot, tgt_labels, tgt_valid,
               voxel_valid, class_weight, cost_class: float, cost_mask: float,
               cost_dice: float) -> torch.Tensor:
    """The full matching cost ``[Q, T_cap]`` (reference
    ``memory_efficient_forward``, ``matcher_sparse.py:100-165``); zero at
    invalid target columns, NaN/inf replaced as the reference does."""
    out_prob = torch.softmax(query_logits.float(), dim=-1)
    lab = tgt_labels.long().clamp(0, query_logits.shape[-1] - 1)
    cc = -out_prob[:, lab]
    cd = batch_dice_cost(voxel_logits.float(), tgt_onehot, voxel_valid)
    cm = batch_focal_cost(voxel_logits.float(), tgt_onehot, voxel_valid)
    tgt_w = class_weight[tgt_labels.long().clamp(0, class_weight.shape[0] - 1)]
    c = (cost_mask * cm + cost_class * cc + cost_dice * cd) * tgt_w[None, :]
    c = torch.where(tgt_valid[None, :], c, torch.zeros((), device=c.device))
    return torch.nan_to_num(c, nan=1e6, posinf=1e6, neginf=-1e6)


def host_assign(cost: np.ndarray, tgt_valid: np.ndarray) -> np.ndarray:
    """LSA over the valid target columns: ``src_of_tgt [T_cap]``, the
    matched query per target, -1 for invalid targets (reference
    ``matcher.py:66-81``)."""
    out = np.full((cost.shape[1],), -1, np.int32)
    cols = np.nonzero(tgt_valid)[0]
    if cols.size == 0:
        return out
    rows, sub_cols = native.linear_sum_assignment(np.asarray(cost[:, cols], np.float64))
    out[cols[sub_cols]] = rows.astype(np.int32)
    return out


def match_all(costs: List[torch.Tensor], tgt_valid: List[torch.Tensor]) -> List[torch.Tensor]:
    """Assignments of a list of ``[Q, T_cap]`` costs, with one host copy of
    all of them (and one of the target masks) and one copy back."""
    c = torch.stack(costs).cpu().numpy()
    v = torch.stack(tgt_valid).cpu().numpy()
    out = np.stack([host_assign(ci, vi) for ci, vi in zip(c, v)])
    dev = costs[0].device
    return list(torch.from_numpy(out).to(dev).unbind(0))
