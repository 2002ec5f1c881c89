"""The port's trainer entry (single-card path of
``pasco_tpu/training/loop.py:159-313``).

:func:`train` builds the net at the train box, seeds its init, and runs
one :func:`~pasco_torch.training.step.train_step` per ``CollatedScene`` of
an iterable, logging ``total_loss``, ``grad_norm`` and the time per step.
At ``n_infers`` 3 and 4 the first steps pretrain the sem-completion losses
only, as the reference's first epochs do.  Epochs over a dataset,
checkpointing, validation, worker processes and gradient accumulation are
not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, Optional

import torch

from pasco_torch.core.config import PaSCoConfig
from pasco_torch.models.unet import build_net, scene_to_model_input
from pasco_torch.training import step as tstep

# Sem-only pretraining epochs by n_infers (pasco_tpu/training/loop.py:199-202)
PRETRAIN_SEM_EPOCHS = {4: 2, 3: 1}


def train_config(cfg: PaSCoConfig) -> PaSCoConfig:
    """``cfg`` with the working box set to the train box, where one is
    configured (``SceneConfig.train_box_extent``)."""
    if cfg.scene.train_box_extent is None:
        return cfg
    return cfg.replace(scene=dataclasses.replace(
        cfg.scene, box_extent=cfg.scene.train_box_extent))


def train(
    cfg: PaSCoConfig,
    scenes: Iterable,
    device="cuda",
    class_frequencies=None,
    seed: int = 0,
    lr_mode: str = "reference",
    log: Optional[Callable[[Dict[str, float]], None]] = print,
    state: Optional[tstep.TrainState] = None,
    pretrain_sem_steps: Optional[int] = None,
) -> tstep.TrainState:
    """Train on ``scenes`` (``CollatedScene``s collated at the train box).
    A new state is a net built at the train box with the seeded init
    (``reset_parameters``) on ``device``: the card unless the caller asks
    for the CPU (``device="cpu"``); without a card the default raises.  Each step's record holds the
    step, ``total_loss``, ``grad_norm``, ``is_predict_panop`` and
    ``step_s`` (host clock around the step, synchronised on a CUDA device)
    and there ``device_ms`` (CUDA events around the step); ``log`` gets
    each record and the state collects them in ``state.history``.

    Sem-only pretraining: every step whose ``state.step`` is below
    ``pretrain_sem_steps`` runs with ``is_predict_panop=False``.  By
    default that is the reference's ``pretrain_sem_epochs``
    (``{4: 2, 3: 1}.get(n_infers, 0)``, ``pasco_tpu/training/loop.py:
    199-202``) with one epoch taken as one pass over ``scenes``, i.e.
    ``epochs * len(scenes)`` steps; an iterable without a length needs
    ``pretrain_sem_steps`` when that epoch count is not 0."""
    from pasco_torch.data.semantic_kitti.params import CLASS_FREQUENCIES

    tcfg = train_config(cfg)
    if state is None:
        net = build_net(tcfg, device)
        net.reset_parameters(torch.Generator().manual_seed(seed))
        state = tstep.create_train_state(net, tcfg, lr_mode)
    dev = next(state.net.parameters()).device
    lw = {s: torch.as_tensor(v, device=dev) for s, v in tstep.labelweights_for(
        cfg, class_frequencies or CLASS_FREQUENCIES).items()}
    cw = torch.as_tensor(tstep.class_weight_vector(
        cfg.model.n_classes, cfg.loss.no_object_weight), device=dev)
    if pretrain_sem_steps is None:
        epochs = PRETRAIN_SEM_EPOCHS.get(cfg.model.n_infers, 0)
        if epochs and not hasattr(scenes, "__len__"):
            raise ValueError("scenes has no length: pass pretrain_sem_steps")
        pretrain_sem_steps = epochs * len(scenes) if epochs else 0
    for scene in scenes:
        panop = state.step >= pretrain_sem_steps
        inp = scene_to_model_input(scene, dev)
        tgt = tstep.targets_to_device(scene.targets, dev)
        events = None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        t0 = time.perf_counter()
        logs = tstep.train_step(state, inp, tgt, lw, cw, tcfg, seed, panop)
        if events is not None:
            events[1].record()
            torch.cuda.synchronize(dev)
        rec = {"step": state.step, "total_loss": float(logs["total_loss"]),
               "grad_norm": float(logs["grad_norm"]), "is_predict_panop": panop,
               "step_s": time.perf_counter() - t0}
        if events is not None:
            rec["device_ms"] = events[0].elapsed_time(events[1])
        state.history.append(rec)
        if log is not None:
            log(rec)
    return state
