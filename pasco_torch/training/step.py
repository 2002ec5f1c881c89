"""Training and evaluation steps (counterpart of
``pasco_tpu/training/step.py:38-341``).

The loss is assembled as the reference weights it
(``net_panoptic_sparse.py:141-166, 355-483``):

    total = occ_weight * (compl_ce + compl_lovasz)
          + 2 * CE + 40 * mask + 1 * dice               [per-subnet mean]
          + 0.3 * ssc_ce + 1.0 * ssc_lovasz             [voxel-query SSC]
          + the same terms for each aux prediction level

Gradient accumulation (``step.py:249-309``) runs one :func:`grad_step`
per microbatch, whose ``backward`` adds into ``.grad``, then one
:func:`apply_grads` that updates on the window's mean gradient.
``TrainState``, ``class_weight_vector`` and ``labelweights_for`` are NumPy
and torch here: the reference module imports JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pasco_torch.core.config import PaSCoConfig
from pasco_torch.data.semantic_kitti.collate import TargetBundle
from pasco_torch.loss.criterion import SubnetTargets, criterion_all_subnets
from pasco_torch.loss.losses import compl_labelweights, compute_sem_compl_loss
from pasco_torch.models.norm import commit_batch_stats
from pasco_torch.models.unet import ModelInput
from pasco_torch.training.optim import AdamW

# per-step generator seeds: a stand-in for jax.random.fold_in(key, step)
_SEED_STRIDE = 1_000_003


@dataclass
class TrainState:
    """The net (parameters and running statistics), the optimizer state,
    the number of steps taken and the trainer's per-step records."""

    net: torch.nn.Module
    opt: AdamW
    step: int = 0
    history: List[Dict[str, float]] = field(default_factory=list)


def class_weight_vector(n_classes: int, no_object_weight: float) -> np.ndarray:
    """ones(C+1) with empty (0) and dustbin (C) down-weighted
    (``scripts/train.py:117-123``)."""
    w = np.ones(n_classes + 1, np.float32)
    w[0] = 0.1
    w[-1] = no_object_weight
    return w


def labelweights_for(cfg: PaSCoConfig, class_frequencies) -> Dict[int, np.ndarray]:
    power = 1.0 / 3.0 if cfg.model.n_classes == 20 else 1.0 / 1.5
    return {s: compl_labelweights(class_frequencies[s], power) for s in (1, 2, 4)}


def targets_to_device(t: TargetBundle, device) -> TargetBundle:
    """The host target bundle as tensors on ``device`` (uint8 labels widen
    to int64)."""
    def conv(a):
        a = np.asarray(a)
        dt = torch.int64 if a.dtype == np.uint8 else None
        return torch.as_tensor(a, dtype=dt).to(device)

    return TargetBundle(*(conv(x) for x in t))


def create_train_state(net, cfg: PaSCoConfig, lr_mode: str = "reference") -> TrainState:
    params = dict(net.named_parameters())
    return TrainState(net=net, opt=AdamW(params, cfg.optim, lr_mode))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's random draws (point dropout, cap noise,
    dropout), seeded from ``(seed, step)``."""
    return torch.Generator(device=device).manual_seed(seed * _SEED_STRIDE + step)


def compute_losses(net, inp: ModelInput, targets: TargetBundle,
                   labelweights: Dict[int, torch.Tensor], class_weight: torch.Tensor,
                   cfg: PaSCoConfig, generator=None, is_predict_panop: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward in the net's current mode and the weighted loss; returns
    ``(total, logs)``.  With ``is_predict_panop=False`` the forward skips
    the refiners and the transformer and only the sem-completion losses
    count (``pasco_tpu/training/step.py:99-137``)."""
    out = net(inp, labelweights, generator, is_predict_panop=is_predict_panop)
    lc = cfg.loss
    logs: Dict[str, torch.Tensor] = {}
    sem_labels = {1: targets.sem_label_1, 2: targets.sem_label_2, 4: targets.sem_label_4}
    compl_ce, compl_lov = compute_sem_compl_loss(
        out.sem_grids, out.sem_logits, sem_labels, inp.subnet_min, inp.subnet_max,
        labelweights)
    total = (compl_ce + compl_lov) * lc.occ_weight
    logs["compl_ce"] = compl_ce
    logs["compl_lovasz"] = compl_lov
    if is_predict_panop:
        sub_t = SubnetTargets(
            labels=targets.labels, valid=targets.labels_valid,
            mask_id_dense=targets.mask_id_dense, semantic_dense=targets.semantic_dense,
            unknown_dense=targets.unknown_dense)
        crit = criterion_all_subnets(
            out.predictor, out.panop_grids[1], sub_t, inp.subnet_min, class_weight,
            labelweights[1], lc, cfg.model.n_classes, include_aux=lc.include_aux)
        weights = (("loss_ce", lc.ce_weight), ("loss_mask", lc.mask_weight),
                   ("loss_dice", lc.dice_weight))
        if lc.use_voxel_query_loss:
            weights += (("ssc_ce", lc.ssc_ce_weight), ("ssc_lovasz", lc.ssc_lovasz_weight))
        for k, v in crit.items():
            logs[k] = v
            for prefix, w in weights:
                if k.startswith(prefix):
                    total = total + w * v
    logs["total_loss"] = total
    return total, logs


def grad_step(state: TrainState, inp: ModelInput, targets: TargetBundle,
              labelweights: Dict[int, torch.Tensor], class_weight: torch.Tensor,
              cfg: PaSCoConfig, generator: torch.Generator,
              is_predict_panop: bool = True) -> Dict[str, torch.Tensor]:
    """One microbatch: forward in training mode, ``backward`` (adding its
    gradients into ``.grad``) and the running statistics folded in, with no
    update (``pasco_tpu/training/step.py:249-283``).  Returns the logs
    (detached tensors on the device)."""
    net = state.net
    net.train()
    total, logs = compute_losses(net, inp, targets, labelweights, class_weight, cfg,
                                 generator, is_predict_panop)
    total.backward()
    commit_batch_stats(net)
    return {k: v.detach() for k, v in logs.items()}


def zero_grads(state: TrainState) -> None:
    """Open a gradient window: every ``.grad`` cleared."""
    for p in state.opt.params.values():
        p.grad = None


def apply_grads(state: TrainState, n_accum: int = 1) -> torch.Tensor:
    """The optimizer update on the mean of the ``.grad`` that ``n_accum``
    microbatches added up (clip and AdamW on the mean, as
    ``pasco_tpu/training/step.py:292-309`` applies it) and ``state.step +
    1``; ``.grad`` keeps the sum until :func:`zero_grads` opens the next
    window.  A parameter no microbatch reached counts a zero gradient.
    Returns the pre-clip norm of the mean."""
    grads = {}
    for k, p in state.opt.params.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        grads[k] = g / n_accum if n_accum > 1 else g
    norm = state.opt.step(grads)
    state.step += 1
    return norm


def train_step(state: TrainState, inp: ModelInput, targets: TargetBundle,
               labelweights: Dict[int, torch.Tensor], class_weight: torch.Tensor,
               cfg: PaSCoConfig, seed: int = 0,
               is_predict_panop: bool = True) -> Dict[str, torch.Tensor]:
    """One optimisation step in place: :func:`grad_step` on this scene with
    the generator of ``(seed, state.step)``, then :func:`apply_grads`.
    Returns the logs, ``grad_norm`` (pre-clip) included.
    ``is_predict_panop=False`` trains the sem-completion losses only; the
    refiners and the transformer then get zero gradients, as in the
    reference (``pasco_tpu/training/step.py:200-230``)."""
    zero_grads(state)
    gen = step_generator(seed, state.step, inp.point_feats.device)
    logs = grad_step(state, inp, targets, labelweights, class_weight, cfg, gen,
                     is_predict_panop)
    logs["grad_norm"] = apply_grads(state)
    return logs


@torch.no_grad()
def eval_step(net, inp: ModelInput):
    """The inference forward (``pasco_tpu/training/step.py:312-321``)."""
    net.eval()
    return net(inp)


@torch.no_grad()
def mc_eval_step(net, inp: ModelInput, generator: Optional[torch.Generator]):
    """One MC-dropout sample (``pasco_tpu/training/step.py:324-341``): the
    inference forward with every dropout live, BatchNorm on its running
    statistics and the caps off; another ``generator`` gives another
    sample."""
    net.eval()
    return net(inp, generator=generator, mc_dropout=True)
