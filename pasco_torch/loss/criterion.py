"""Set criterion: matched panoptic losses per subnet and prediction level
(counterpart of ``pasco_tpu/loss/criterion.py:40-230``).

Targets are the compact host encoding of the reference: per subnet a dense
``mask_id`` grid (voxel -> target slot, ``T_cap`` = none), per-slot labels
and validity, the dense semantic labels and the unknown mask.  The levels
(final prediction, then the transformer's aux rounds) and the subnets are
a plain loop; the matcher's cost matrices of all of them go to the host in
one transfer (:func:`pasco_torch.loss.matcher.match_all`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from pasco_torch.loss.losses import sigmoid_focal_loss, weighted_cross_entropy
from pasco_torch.loss.lovasz import lovasz_softmax
from pasco_torch.loss.matcher import match_all, match_cost


class SubnetTargets(NamedTuple):
    """Panoptic targets of one subnet (static shapes, host-built)."""

    labels: torch.Tensor          # [T_cap] int class of each target mask
    valid: torch.Tensor           # [T_cap] bool
    mask_id_dense: torch.Tensor   # [X, Y, Z] int: target slot, T_cap = none
    semantic_dense: torch.Tensor  # [X, Y, Z] int labels (255 = unknown)
    unknown_dense: torch.Tensor   # [X, Y, Z] bool (geo label == 255)


def _gather_dense(dense, rel, fill):
    """``dense[rel]`` at clipped coords; out-of-range rows take ``fill``."""
    shape = torch.tensor(dense.shape, device=rel.device)[None, :]
    in_range = ((rel >= 0) & (rel < shape)).all(-1)
    relc = torch.minimum(rel.clamp(min=0), shape - 1).long()
    vals = dense[relc[:, 0], relc[:, 1], relc[:, 2]]
    return torch.where(in_range, vals, torch.full_like(vals, fill))


def _subnet_view(grid, tgt: SubnetTargets, subnet_min, t_cap: int):
    """Per-voxel target slot, unknown flag and semantic label of a subnet's
    scale-1 panoptic grid."""
    rel = grid.coords[:, 1:] - subnet_min[None, :]
    mask_id = _gather_dense(tgt.mask_id_dense, rel, t_cap).long()
    unknown = _gather_dense(tgt.unknown_dense, rel, True)
    mask_id = torch.where(grid.mask, mask_id, torch.full_like(mask_id, t_cap))
    unknown = unknown | ~grid.mask
    sem_lbl = _gather_dense(tgt.semantic_dense, rel, 255).long()
    return mask_id, unknown, sem_lbl


def criterion_losses(query_logits, voxel_logits, grid, tgt: SubnetTargets,
                     assign, mask_id, unknown, sem_lbl, class_weight,
                     compl_weights, n_classes: int) -> Dict[str, torch.Tensor]:
    """One subnet, one prediction level, given the assignment ``assign``
    ``[T_cap]`` (query per target, -1 = none): reference
    ``criterion_losses`` (``criterion.py:49-169``)."""
    t_cap = tgt.labels.shape[0]
    q = query_logits.shape[0]
    labels = tgt.labels.long()

    # ---- classification (criterion_sparse.py:56-81) ----------------------
    # The reference scatters with duplicate indices: unassigned slots write
    # "no object" at query 0, and XLA applies duplicate writes in order, so
    # the last write per query wins.  The port keeps that rule.  A label
    # past "no object" (the 255 ignore label can reach a mask slot) reads as
    # "no object" in the forward and passes no gradient, as the reference's
    # out-of-range gather does (clamped read, dropped scatter in its VJP).
    assigned = assign >= 0
    assign_c = assign.long().clamp(0, q - 1)
    vals = torch.where(assigned, labels, torch.full_like(labels, n_classes))
    slot = torch.arange(1, t_cap + 1, device=assign.device)
    last = ((assign_c[None, :] == torch.arange(q, device=assign.device)[:, None])
            * slot[None, :]).amax(1) - 1
    raw = torch.where(last >= 0, vals[last.clamp(min=0)], torch.full_like(last, n_classes))
    target_classes = raw.clamp(0, n_classes)
    logp = F.log_softmax(query_logits.float(), dim=-1)
    ce_per_q = -logp.gather(1, target_classes[:, None])[:, 0]
    ce_per_q = torch.where(raw == target_classes, ce_per_q, ce_per_q.detach())
    loss_ce = (ce_per_q * class_weight[target_classes]).mean()

    # ---- mask losses (criterion_sparse.py:83-116), [T_cap, N] layout -----
    pred_rows = voxel_logits.T[assign_c]
    onehot_t = ((mask_id[None, :] == torch.arange(t_cap, device=mask_id.device)[:, None])
                & tgt.valid[:, None]).float()
    tgt_w = class_weight[labels.clamp(0, n_classes)]
    t_valid = assigned & tgt.valid
    row_valid = ~unknown & grid.mask
    rv = row_valid[None, :].float()
    focal = sigmoid_focal_loss(pred_rows, onehot_t) * tgt_w[:, None] * rv
    n_rows = row_valid.float().sum().clamp(min=1.0)
    n_t = t_valid.float().sum().clamp(min=1.0)
    zero = torch.zeros((), device=pred_rows.device)
    loss_mask = torch.where(t_valid, focal.sum(1) / n_rows, zero).sum() / n_t
    probs_t = torch.sigmoid(pred_rows) * rv
    tgts_t = onehot_t * rv
    numer = 2 * (probs_t * tgts_t).sum(1)
    denom = probs_t.sum(1) + tgts_t.sum(1)
    dice = (1 - (numer + 1) / (denom + 1)) * tgt_w
    loss_dice = torch.where(t_valid, dice, zero).sum() / n_t

    # ---- voxel-query SSC losses (criterion_sparse.py:180-209) ------------
    q_prob = torch.softmax(query_logits.float(), dim=-1)
    keep_q = (q_prob.argmax(-1) != n_classes).float()
    any_kept = keep_q.sum() > 0
    vox_prob = (torch.sigmoid(voxel_logits.float()) + 1e-8) * keep_q[None, :]
    vox_sum = vox_prob.sum(1, keepdim=True)
    vox_prob = vox_prob / torch.where(vox_sum > 0, vox_sum, torch.ones_like(vox_sum))
    ssc_logit = vox_prob @ (query_logits[:, :-1].float() * keep_q[:, None])
    ssc_valid = grid.mask & (sem_lbl != 255)
    # CE_ssc_loss runs with ignore_index=0 (reference losses.py:10-23)
    ssc_ce = weighted_cross_entropy(ssc_logit, sem_lbl, ssc_valid & (sem_lbl != 0),
                                    compl_weights)
    ssc_lovasz = lovasz_softmax(ssc_logit, sem_lbl, ssc_valid, ignore_classes=(0,))
    return {
        "loss_ce": loss_ce,
        "loss_mask": loss_mask,
        "loss_dice": loss_dice,
        "ssc_ce": torch.where(any_kept, ssc_ce, zero),
        "ssc_lovasz": torch.where(any_kept, ssc_lovasz, zero),
    }


def criterion_all_subnets(predictor_out, panop_grid1, targets: SubnetTargets,
                          subnet_min, class_weight, compl_weights, cfg,
                          n_classes: int, include_aux: bool = True
                          ) -> Dict[str, torch.Tensor]:
    """Every key averaged over subnets, per level: ``loss_ce`` etc. for the
    final prediction and ``loss_ce_aux{i}`` for aux round ``i``
    (reference ``criterion.py:172-230``).  ``targets`` carry a leading
    subnet axis."""
    S = subnet_min.shape[0]
    levels = [(predictor_out.query_logits, predictor_out.voxel_logits)]
    if include_aux:
        levels += list(predictor_out.aux)
    t_cap = targets.labels.shape[1]
    subs = []
    for s in range(S):
        grid = panop_grid1.subnet(s)
        tgt = SubnetTargets(*(t[s] for t in targets))
        mask_id, unknown, sem_lbl = _subnet_view(grid, tgt, subnet_min[s], t_cap)
        onehot = ((mask_id[:, None] == torch.arange(t_cap, device=mask_id.device)[None, :])
                  & tgt.valid[None, :]).float()
        covered = (mask_id < t_cap) & tgt.valid[mask_id.clamp(max=t_cap - 1)]
        subs.append((grid, tgt, mask_id, unknown, sem_lbl, onehot, covered & ~unknown))

    costs, valids = [], []
    for q_l, v_l in levels:
        for s, (grid, tgt, _, _, _, onehot, match_valid) in enumerate(subs):
            costs.append(match_cost(q_l[s], v_l[s], onehot, tgt.labels, tgt.valid,
                                    match_valid, class_weight, cfg.cost_class,
                                    cfg.mask_weight, cfg.dice_weight))
            valids.append(tgt.valid)
    assigns = match_all(costs, valids)

    total: Dict[str, torch.Tensor] = {}
    for li, (q_l, v_l) in enumerate(levels):
        suffix = "" if li == 0 else f"_aux{li - 1}"
        per = [criterion_losses(q_l[s], v_l[s], grid, tgt, assigns[li * S + s],
                                mask_id, unknown, sem_lbl, class_weight,
                                compl_weights, n_classes)
               for s, (grid, tgt, mask_id, unknown, sem_lbl, _, _) in enumerate(subs)]
        for k in per[0]:
            total[k + suffix] = torch.stack([p[k] for p in per]).sum() / S
    return total
