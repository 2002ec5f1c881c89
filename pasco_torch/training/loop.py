"""The port's trainer (single-card path of ``pasco_tpu/training/loop.py``).

:func:`train` is the reference's entry: epochs over a dataset in a seeded
order, scenes collated by worker processes, gradient accumulation,
validation on the PQ-dagger monitor, top-k checkpoints on it and
auto-resume from the latest one, metrics in ``<log_dir>/metrics.jsonl``.

At ``n_infers`` 3 and 4 the first epochs pretrain the sem-completion
losses only (``{4: 2, 3: 1}``, ``pasco_tpu/training/loop.py:199-202``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from pasco_torch.core.config import PaSCoConfig
from pasco_torch.data.loader import ReadAhead, load_scenes, scene_iterator
from pasco_torch.data.semantic_kitti.collate import collate
from pasco_torch.models.unet import build_net, scene_to_model_input
from pasco_torch.training import step as tstep

# Sem-only pretraining epochs by n_infers (pasco_tpu/training/loop.py:199-202)
PRETRAIN_SEM_EPOCHS = {4: 2, 3: 1}
LOG_EVERY = 20        # optimizer steps between two metric lines (loop.py:262)


def train_config(cfg: PaSCoConfig) -> PaSCoConfig:
    """``cfg`` with the working box set to the train box, where one is
    configured (``SceneConfig.train_box_extent``)."""
    if cfg.scene.train_box_extent is None:
        return cfg
    return cfg.replace(scene=dataclasses.replace(
        cfg.scene, box_extent=cfg.scene.train_box_extent))


def synthetic_train_scenes(cfg: PaSCoConfig, n: int, seed: int = 0):
    """``n`` synthetic training scenes with targets (``data/synthetic.py``,
    120000 points), collated at the train box: a distinct scan per subnet,
    as the reference's training split draws them (``pasco_tpu/data/
    semantic_kitti/dataset.py:464-489``)."""
    from pasco_torch.data.semantic_kitti.dataset import process_scene
    from pasco_torch.data.synthetic import make_scene

    tcfg = train_config(cfg)
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        views = []
        for _ in range(cfg.model.n_infers):
            scene = make_scene(rng, scene_size=cfg.scene.scene_size,
                               n_points=min(cfg.capacity.num_points, 120000),
                               point_feat_dim=cfg.model.in_channels - 6)
            views.append(process_scene(scene, None, rng))
        out.append(collate(views, tcfg, rng=rng))
    return out


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


class MetricLogger:
    """``<log_dir>/metrics.jsonl`` (one JSON object per line) and, where
    ``torch.utils.tensorboard`` imports, TensorBoard scalars
    (``pasco_tpu/training/loop.py:32-58``)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(log_dir)

    def log(self, step: int, scalars: Dict[str, object], prefix: str = "") -> None:
        rec = {"step": int(step)}
        for k, v in scalars.items():
            try:
                rec[f"{prefix}{k}"] = float(v)
            except (TypeError, ValueError):
                continue
            if self._tb is not None:
                self._tb.add_scalar(f"{prefix}{k}", rec[f"{prefix}{k}"], step)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


def read_metrics(log_dir: str):
    """The records of ``<log_dir>/metrics.jsonl``."""
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


class StepTimer:
    """Host clock and, on a CUDA device, CUDA events around a unit of work,
    synchronised at its end.  ``event_ms`` is the time between the two
    events: it counts host work inside the unit that the card waits on (a
    step's matching), so it is not the card's busy time."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.events = None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            self.events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self.events[0].record()
        self.t0 = time.perf_counter()

    def stop(self) -> Dict[str, float]:
        rec = {}
        if self.events is not None:
            self.events[1].record()
            self.events[1].synchronize()
            rec["event_ms"] = self.events[0].elapsed_time(self.events[1])
        rec["step_s"] = time.perf_counter() - self.t0
        return rec


def loss_weights(cfg: PaSCoConfig, class_frequencies, dev):
    """The per-scale label weights (``class_frequencies``, by default
    SemanticKITTI's) and the class weights, on ``dev``."""
    from pasco_torch.data.semantic_kitti.params import CLASS_FREQUENCIES

    lw = {s: torch.as_tensor(v, device=dev) for s, v in tstep.labelweights_for(
        cfg, class_frequencies or CLASS_FREQUENCIES).items()}
    cw = torch.as_tensor(tstep.class_weight_vector(
        cfg.model.n_classes, cfg.loss.no_object_weight), device=dev)
    return lw, cw


def new_train_state(cfg: PaSCoConfig, device, seed: int,
                    lr_mode: str = "reference") -> tstep.TrainState:
    """A net at the train box with the seeded init, and its optimizer."""
    tcfg = train_config(cfg)
    net = build_net(tcfg, device)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return tstep.create_train_state(net, tcfg, lr_mode)


def _epoch_scenes(dataset, tcfg, orders, seed, num_workers, stack: contextlib.ExitStack):
    """One iterator of scenes per epoch of ``orders``, read ahead by a
    thread that ``stack`` closes; epoch ``e`` draws with seed ``seed * 1009
    + e`` (``pasco_tpu/training/loop.py:241-244``).  With workers, one pool
    serves every epoch and starts at once: its workers spawn and make the
    first scenes while the caller builds its state, and the next epoch's
    first scenes are made while this one validates and saves.  Without,
    each epoch's thread starts with the epoch."""
    if num_workers <= 0:
        return (stack.enter_context(ReadAhead(scene_iterator(
            dataset, tcfg, order, rng=np.random.RandomState(seed * 1009 + e))))
            for e, order in enumerate(orders))
    tasks = ((i, seed * 1009 + e) for e, order in enumerate(orders) for i in order)
    stream = stack.enter_context(ReadAhead(load_scenes(dataset, tcfg, tasks,
                                                       num_workers=num_workers)))
    return ((next(stream) for _ in range(len(order))) for order in orders)


def train(
    cfg: PaSCoConfig,
    dataset,
    val_dataset=None,
    n_epochs: int = 60,
    log_dir: str = "logs/pasco_torch",
    class_frequencies=None,
    seed: int = 0,
    limit_train_batches: Optional[int] = None,
    limit_val_batches: Optional[int] = None,
    ckpt_every_epochs: int = 1,
    lr_mode: str = "reference",
    pretrain_sem_epochs: Optional[int] = None,
    accum_steps: int = 1,
    num_workers: int = 3,
    device="cuda",
) -> tstep.TrainState:
    """Train on ``dataset`` (items are lists of per-subnet samples, as
    ``KittiDataset``/``SyntheticKittiDataset`` give them) for ``n_epochs``
    (``pasco_tpu/training/loop.py:159-313``), on ``device``: the card
    unless the caller asks for the CPU; without a card the default raises.
    Single-card, as the reference's (``pasco_tpu/training/loop.py:175-176``):
    the data-parallel step is ``pasco_torch/parallel/mesh.py:dp_train_step``.

    * A new state is the seeded init at the train box; where
      ``<log_dir>/checkpoints`` holds a checkpoint, the latest one is
      restored (auto-resume) and its step counts on.  As in the reference,
      a resumed run then trains all ``n_epochs`` again, and a checkpoint
      that fails to restore (a truncated file, another config) leaves the
      seeded init: one printed line names the error.
    * Epoch ``e`` visits ``RandomState(seed).permutation`` (a new draw per
      epoch, after that generator has collated ``dataset[0]`` as the
      reference does to build its state), cut to ``limit_train_batches``;
      the first
      ``pretrain_sem_epochs`` (default ``{4: 2, 3: 1}.get(n_infers, 0)``)
      are sem-only.
    * ``accum_steps > 1``: one optimizer step per ``accum_steps`` scenes,
      on their mean gradient (:func:`~pasco_torch.training.step.grad_step`,
      :func:`~pasco_torch.training.step.apply_grads`); microbatch ``k`` of
      optimizer step ``g`` draws from ``step_generator(seed, g *
      accum_steps + k)``.  A window an epoch leaves unfinished is dropped,
      as in the reference.  With ``accum_steps == 1`` each scene is one
      optimizer step, bit for bit what
      :func:`~pasco_torch.training.step.train_step` computes.
    * Every ``LOG_EVERY`` optimizer steps a ``train/`` metric line; after
      each epoch :func:`validate` on ``val_dataset`` (if given), an
      ``epoch`` line (``epoch_time``: the epoch's training, host clock) and,
      every ``ckpt_every_epochs``, a checkpoint with ``{"monitor":
      pq_dagger}``.

    ``state.history`` holds one record per optimizer step: ``step``,
    ``epoch``, ``total_loss`` (the window's mean), ``grad_norm``,
    ``is_predict_panop``, ``step_s`` and, on a CUDA device, ``event_ms``
    (the window's sum) and ``micro_event_ms`` (:class:`StepTimer`)."""
    from pasco_torch.training.checkpoint import CheckpointManager

    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    tcfg = train_config(cfg)
    if pretrain_sem_epochs is None:
        pretrain_sem_epochs = PRETRAIN_SEM_EPOCHS.get(cfg.model.n_infers, 0)
    rng = np.random.RandomState(seed)
    collate(dataset[0], tcfg, rng=rng)       # the reference's draws (loop.py:204)
    orders = [rng.permutation(len(dataset))[:limit_train_batches or None]
              for _ in range(n_epochs)]

    with contextlib.ExitStack() as stack:
        epochs = _epoch_scenes(dataset, tcfg, orders, seed, num_workers, stack)
        state = new_train_state(cfg, device, seed, lr_mode)
        dev = next(state.net.parameters()).device
        lw, cw = loss_weights(cfg, class_frequencies, dev)
        logger = stack.enter_context(contextlib.closing(MetricLogger(log_dir)))
        ckpt = CheckpointManager(os.path.join(log_dir, "checkpoints"), cfg)
        try:
            if ckpt.restore(state) is not None:
                print(f"resumed from step {state.step}", flush=True)
        except Exception as e:  # noqa: BLE001 -- the reference starts afresh (loop.py:215-223)
            print(f"could not restore {ckpt.directory} ({type(e).__name__}: {e}); "
                  f"starting afresh", flush=True)
            state = new_train_state(cfg, device, seed, lr_mode)   # a restore may stop halfway
        for epoch, scenes in enumerate(epochs):
            panop = epoch >= pretrain_sem_epochs
            t_epoch = time.perf_counter()
            window = []
            tstep.zero_grads(state)
            for scene in scenes:
                inp = scene_to_model_input(scene, dev)
                tgt = tstep.targets_to_device(scene.targets, dev)
                timer = StepTimer(dev)
                gen = tstep.step_generator(seed, state.step * accum_steps + len(window), dev)
                logs = tstep.grad_step(state, inp, tgt, lw, cw, tcfg, gen, panop)
                window.append((float(logs["total_loss"]), timer.stop()))
                if len(window) < accum_steps:
                    continue
                timer = StepTimer(dev)
                logs["grad_norm"] = tstep.apply_grads(state, accum_steps)
                tail = timer.stop()
                rec = {"step": state.step, "epoch": epoch,
                       "total_loss": float(np.mean([w[0] for w in window])),
                       "grad_norm": float(logs["grad_norm"]), "is_predict_panop": panop,
                       "step_s": sum(w[1]["step_s"] for w in window) + tail["step_s"]}
                if dev.type == "cuda":
                    rec["micro_event_ms"] = [w[1]["event_ms"] for w in window]
                    rec["event_ms"] = sum(rec["micro_event_ms"]) + tail["event_ms"]
                state.history.append(rec)
                window = []
                tstep.zero_grads(state)
                if state.step % LOG_EVERY == 0:
                    logger.log(state.step, logs, prefix="train/")
                    print(f"step {state.step}: total_loss {rec['total_loss']:.4f}, "
                          f"grad_norm {rec['grad_norm']:.4f}", flush=True)
            epoch_time = time.perf_counter() - t_epoch
            monitor = 0.0
            if val_dataset is not None:
                monitor = validate(cfg, state.net, val_dataset, logger, state.step,
                                   limit_val_batches)
            logger.log(state.step, {"epoch": epoch, "epoch_time": epoch_time})
            print(f"epoch {epoch}: step {state.step}, {epoch_time:.1f} s, val pq_dagger "
                  f"{monitor:.4f}", flush=True)
            if (epoch + 1) % ckpt_every_epochs == 0:
                ckpt.save(state.step, state, {"monitor": monitor})
    ckpt.wait()
    return state


@torch.no_grad()
def validate(cfg: PaSCoConfig, net, val_dataset, logger: MetricLogger, step: int,
             limit_batches: Optional[int] = None) -> float:
    """The validation pass (``pasco_tpu/training/loop.py:316-342``):
    ``run_scene_inference`` at ``cfg.scene.box_extent`` (the full box, as
    the reference validates, not the box ladder) on the first
    ``limit_batches`` scenes, outputs 0 and S scored without uncertainty;
    logs ``val/pq_dagger_all`` (and ``val/s_per_scene``, the host clock per
    scene) and returns the ensemble's PQ-dagger, the checkpoints'
    monitor."""
    from pasco_torch.inference.pipeline import Evaluator, run_scene_inference

    S = cfg.model.n_infers
    dev = next(net.parameters()).device
    net.eval()
    evaluator = Evaluator(cfg)
    n = len(val_dataset)
    indices = range(n if not limit_batches else min(n, limit_batches))
    t0 = time.perf_counter()
    with ReadAhead(scene_iterator(val_dataset, cfg, indices)) as scenes:
        for scene in scenes:
            results = run_scene_inference(
                lambda i: net(i, box_extent=cfg.scene.box_extent),
                scene_to_model_input(scene, dev), scene, cfg)
            evaluator.add_scene(results, scene.semantic_label_origin,
                                scene.instance_label_origin, eval_list=[0, S],
                                compute_uncertainty=False)
    s_per_scene = (time.perf_counter() - t0) / max(len(indices), 1)
    monitor = float(evaluator.summary()[-1]["pq_all"]["pq_dagger"])
    logger.log(step, {"pq_dagger_all": monitor, "s_per_scene": s_per_scene}, prefix="val/")
    return monitor
