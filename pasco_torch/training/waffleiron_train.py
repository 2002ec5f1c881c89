"""WaffleIron segmentation training (counterpart of
``pasco_tpu/training/waffleiron_train.py``, the reference frontend trainer
``WaffleIron_mod/utils/trainer.py:25-306``): the SemSeg loss (CE ignore-255
+ Lovasz on valid points), confusion-matrix mIoU/oAcc/mAcc scoring, the
``WarmupCosine`` factor schedule, host-side point-cloud augmentations,
train/eval steps on :class:`~pasco_torch.models.waffleiron.Segmenter` and
best/last checkpoints keyed on val mIoU.

The scores, the transforms and :class:`InstanceCutMix` are the
reference's numpy code, copied: the same draws from the same
``RandomState`` give identical arrays.

A step runs the batch scan by scan: every BatchNorm takes the statistics
of one scan, as ``jax.vmap`` of the reference's forward does, and the new
running statistics are the mean over the scans of each scan's update
(``waffleiron_train.py:456-467``); the loss and the histogram are taken
over the flattened batch.  The optimizer is optax's ``adamw(lr *
factor(count), weight_decay)`` written out (:class:`WaffleAdamW`).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import pickle
import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from pasco_torch.loss.lovasz import lovasz_softmax
from pasco_torch.models.norm import BatchNorm, commit_batch_stats
from pasco_torch.models.waffleiron import Segmenter, grid_cell_indices, knn_indices

IGNORE = 255


# ---------------------------------------------------------------------------
# Loss (reference utils/metrics.py:44-63) and confusion metrics (:23-41)
# ---------------------------------------------------------------------------


def semseg_loss(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                lovasz_weight: float = 1.0) -> torch.Tensor:
    """Cross-entropy (ignore 255) + Lovasz-softmax over valid points:
    ``logits [N, C]``, ``labels [N]`` (255 ignored), ``valid [N]``."""
    keep = valid & (labels != IGNORE)
    safe = torch.where(keep, labels, torch.zeros_like(labels))
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    ce = torch.where(keep, nll, torch.zeros_like(nll)).sum() / keep.float().sum().clamp(min=1.0)
    if lovasz_weight > 0:
        return ce + lovasz_weight * lovasz_softmax(logits, labels, keep)
    return ce


def fast_hist(pred: torch.Tensor, label: torch.Tensor, valid: torch.Tensor,
              n: int) -> torch.Tensor:
    """[n, n] confusion matrix over valid, labelled points (rows: label)."""
    keep = valid & (label != IGNORE)
    idx = torch.where(keep, n * label + pred, torch.full_like(label, n * n))
    return torch.bincount(idx, minlength=n * n + 1)[: n * n].reshape(n, n)


def per_class_iu(hist: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.diag(hist) / (hist.sum(1) + hist.sum(0) - np.diag(hist))


def overall_accuracy(hist: np.ndarray) -> float:
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.diag(hist).sum() / hist.sum())


def per_class_accuracy(hist: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.diag(hist) / hist.sum(1)


# ---------------------------------------------------------------------------
# Schedule (reference utils/scheduler.py:19-33)
# ---------------------------------------------------------------------------


def warmup_cosine_factor(warmup_end: int, max_iter: int, factor_min: float):
    """The reference ``WarmupCosine`` lambda: the factor at update ``step``."""

    def fn(step: int) -> float:
        if step < warmup_end:
            return step / max(warmup_end, 1)
        t = (step - warmup_end) / max(max_iter - warmup_end, 1) * math.pi
        return factor_min + 0.5 * (1 - factor_min) * (math.cos(t) + 1)

    return fn


# ---------------------------------------------------------------------------
# Host-side augmentations (reference utils/transforms.py)
# ---------------------------------------------------------------------------


class Compose:
    def __init__(self, transformations: Sequence[Callable]):
        self.transformations = transformations

    def __call__(self, pcloud, labels):
        for t in self.transformations:
            pcloud, labels = t(pcloud, labels)
        return pcloud, labels


class RandomApply:
    def __init__(self, transformation, prob=0.5, rng=None):
        self.transformation = transformation
        self.prob = prob
        self.rng = rng or np.random

    def __call__(self, pcloud, labels):
        if self.rng.rand() < self.prob:
            pcloud, labels = self.transformation(pcloud, labels)
        return pcloud, labels


class Rotation:
    """Random rotation about axis ``dim`` (reference ``transforms.py:67-92``)."""

    def __init__(self, dim=2, range=np.pi, rng=None):
        self.dim = dim
        self.range = range
        self.rng = rng or np.random

    def __call__(self, pcloud, labels):
        theta = (2 * self.rng.rand() - 1) * self.range
        cos, sin = np.cos(theta), np.sin(theta)
        dims = [d for d in range(3) if d != self.dim]
        rot = np.array([[cos, -sin], [sin, cos]], pcloud.dtype)
        pcloud = pcloud.copy()
        pcloud[:, dims] = pcloud[:, dims] @ rot.T
        return pcloud, labels


class Scale:
    def __init__(self, dims=(0, 1), range=0.05, rng=None):
        self.dims = list(dims)
        self.range = range
        self.rng = rng or np.random

    def __call__(self, pcloud, labels):
        pcloud = pcloud.copy()
        pcloud[:, self.dims] *= 1 + (2 * self.rng.rand() - 1) * self.range
        return pcloud, labels


class FlipXY:
    def __init__(self, rng=None):
        self.rng = rng or np.random

    def __call__(self, pcloud, labels):
        pcloud = pcloud.copy()
        pcloud[:, self.rng.randint(2)] *= -1.0
        return pcloud, labels


class LimitNumPoints:
    """Keep the ``max_points`` closest to a (random or origin) center."""

    def __init__(self, dims=(0, 1, 2), max_point=30000, random=False, rng=None):
        self.dims = list(dims)
        self.max_points = max_point
        self.random = random
        self.rng = rng or np.random

    def __call__(self, pcloud, labels):
        if pcloud.shape[0] <= self.max_points:
            return pcloud, labels
        if self.random:
            center = pcloud[self.rng.randint(pcloud.shape[0])][None, self.dims]
        else:
            center = np.zeros((1, len(self.dims)), pcloud.dtype)
        d = np.square(pcloud[:, self.dims] - center).sum(axis=1)
        idx = np.argsort(d)[: self.max_points]
        return pcloud[idx], labels[idx]


class Crop:
    def __init__(self, dims=(0, 1, 2), fov=((-64, -64, -8), (64, 64, 8)), eps=1e-4):
        self.dims = list(dims)
        self.fov = fov
        self.eps = eps

    def __call__(self, pcloud, labels):
        where = np.ones(pcloud.shape[0], bool)
        for i, d in enumerate(self.dims):
            where &= (pcloud[:, d] > self.fov[0][i] + self.eps) & (
                pcloud[:, d] < self.fov[1][i] - self.eps
            )
        return pcloud[where], labels[where]


class Voxelize:
    """Downsample to one (random or first) point per voxel."""

    def __init__(self, dims=(0, 1, 2), voxel_size=0.1, random=False, rng=None):
        self.dims = list(dims)
        self.voxel_size = voxel_size
        self.random = random
        self.rng = rng or np.random

    def __call__(self, pcloud, labels):
        if self.voxel_size <= 0:
            return pcloud, labels
        pc = pcloud[:, self.dims]
        if self.random:
            permute = self.rng.permutation(pc.shape[0])
            pc, pcloud, labels = pc[permute], pcloud[permute], labels[permute]
        cells = np.floor(pc / self.voxel_size).astype(np.int64)
        cells -= cells.min(0, keepdims=True)
        key = (cells[:, 0] * (cells[:, 1].max() + 1) + cells[:, 1]) * (
            cells[:, 2].max() + 1
        ) + cells[:, 2]
        _, first = np.unique(key, return_index=True)
        return pcloud[first], labels[first]


class InstanceCutMix:
    """Training-time instance bank + paste augmentation (reference
    ``WaffleIron_mod/datasets/semantic_kitti.py:27-152``).

    First pass over the dataset ``cut``s rare-thing instances (bicycle 1,
    motorcycle 2, person 5, bicyclist 6 in WaffleIron train ids) out of
    every scan — centered on their xy-mean / z-min — into a per-class
    bank (in-memory, optionally mirrored to ``rootdir`` as ``.bin`` files
    like the reference's temp dir).  Once the bank is loaded, ``mix``
    pastes up to ``num_to_add`` augmented (flip/rotate/scale) instances
    per class onto random drivable-surface points (classes 8-10:
    road/parking/sidewalk), each at least 1 m apart (1 m random voxel
    downsample of the candidate surface).
    """

    BANK_CLASSES = (1, 2, 5, 6)
    SURFACE = (8, 10)                # road..sidewalk (inclusive)

    def __init__(self, rootdir: str = "", num_to_add: int = 40, rng=None):
        self.rootdir = rootdir
        self.num_to_add = num_to_add
        self.rng = rng or np.random.RandomState(0)
        self.bank = {c: [] for c in self.BANK_CLASSES}
        self.loaded = False
        self.aug = Compose(
            (
                FlipXY(rng=self.rng),
                Rotation(rng=self.rng),
                Scale(dims=(0, 1, 2), range=0.1, rng=self.rng),
            )
        )
        self.vox = Voxelize(
            dims=(0, 1, 2), voxel_size=1.0, random=True, rng=self.rng
        )
        if rootdir and os.path.isdir(rootdir):
            import glob as _glob

            for c in self.BANK_CLASSES:
                for f in sorted(_glob.glob(os.path.join(rootdir, str(c), "*.bin"))):
                    self.bank[c].append(
                        np.fromfile(f, dtype=np.float32).reshape(-1, 4)
                    )
            self.loaded = any(len(v) for v in self.bank.values())

    def finalize_bank(self):
        self.loaded = True

    def cut(self, pc, class_label, instance_label):
        """Harvest instances from one scan into the bank
        (reference ``:99-117``; instances of <= 5 points skipped)."""
        for c in self.BANK_CLASSES:
            for iid in np.unique(instance_label[class_label == c]):
                where = instance_label == iid
                if where.sum() <= 5:
                    continue
                inst = pc[where].astype(np.float32).copy()
                inst[:, :2] -= inst[:, :2].mean(0, keepdims=True)
                inst[:, 2] -= inst[:, 2].min(0, keepdims=True)
                self.bank[c].append(inst)
                if self.rootdir:
                    d = os.path.join(self.rootdir, str(c))
                    os.makedirs(d, exist_ok=True)
                    inst.tofile(
                        os.path.join(d, f"{len(self.bank[c]) - 1:07d}.bin")
                    )

    def mix(self, pc, class_label):
        """Paste augmented bank instances onto drivable surface points
        (reference ``:119-147``)."""
        pc_vox, lab_vox = self.vox(pc, class_label)
        surf = np.where(
            (lab_vox >= self.SURFACE[0]) & (lab_vox <= self.SURFACE[1])
        )[0]
        surf = surf[self.rng.permutation(len(surf))]
        new_pc, new_label = [pc], [class_label]
        id_tot = 0
        for c in self.BANK_CLASSES:
            if not self.bank[c]:
                continue
            n_add = int(self.rng.randint(self.num_to_add))
            for _ in range(n_add):
                if id_tot >= len(surf):
                    break
                p = pc_vox[surf[id_tot]]
                obj = self.bank[c][int(self.rng.randint(len(self.bank[c])))]
                lab = np.full((obj.shape[0],), c, class_label.dtype)
                obj, lab = self.aug(obj.copy(), lab)
                obj[:, :3] += p[:3][None]
                new_pc.append(obj)
                new_label.append(lab)
                id_tot += 1
        return np.concatenate(new_pc, 0), np.concatenate(new_label, 0)

    def __call__(self, pc, class_label, instance_label=None):
        if not self.loaded:
            if instance_label is not None:
                self.cut(pc, class_label, instance_label)
            return None, None
        return self.mix(pc, class_label)


# ---------------------------------------------------------------------------
# Batch assembly (reference datasets/pc_dataset.py:213-285, zero-padded)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PointBatch:
    feats: torch.Tensor        # [B, N, C] f32
    neighbors: torch.Tensor    # [B, K, N] int64
    cell_inds: torch.Tensor    # [B, n_grids, N] int64
    mask: torch.Tensor         # [B, N] bool
    labels: torch.Tensor       # [B, N] int64


def build_point_batch(
    clouds: Sequence[np.ndarray],     # per item [n_i, 3+f] (xyz + feats)
    labels: Sequence[np.ndarray],     # per item [n_i]
    num_points: int,
    k_neighbors: int = 16,
    grids_shape=((250, 250), (250, 12), (250, 12)),
    fov: float = 50.0,
    *,
    device,
) -> PointBatch:
    """Zero-pad a list of clouds to a static [B, num_points] batch with
    neighbor and 2D-cell indices computed on the host (the reference's
    arrays), as tensors on ``device``."""
    B = len(clouds)
    C = clouds[0].shape[1]
    feats = np.zeros((B, num_points, C), np.float32)
    neigh = np.zeros((B, k_neighbors, num_points), np.int32)
    cells = np.zeros((B, len(grids_shape), num_points), np.int32)
    mask = np.zeros((B, num_points), bool)
    labs = np.full((B, num_points), IGNORE, np.int32)
    for b, (pc, lab) in enumerate(zip(clouds, labels)):
        n = min(pc.shape[0], num_points)
        feats[b, :n] = pc[:n]
        mask[b, :n] = True
        labs[b, :n] = lab[:n]
        neigh[b, :, :n] = knn_indices(pc[:n, :3], k=k_neighbors)
        cells[b, :, :n] = grid_cell_indices(pc[:n, :3], grids_shape, fov=fov)

    def put(a, dtype):
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    return PointBatch(feats=put(feats, torch.float32), neighbors=put(neigh, torch.int64),
                      cell_inds=put(cells, torch.int64), mask=put(mask, torch.bool),
                      labels=put(labs, torch.int64))


# ---------------------------------------------------------------------------
# Optimizer, train / eval steps
# ---------------------------------------------------------------------------


class WaffleAdamW:
    """``optax.adamw(learning_rate=lambda s: lr * factor(s), weight_decay)``
    written out (``waffleiron_train.py:412-426``): f32 moments, no gradient
    clip, decay on every parameter, the schedule read at the number of
    updates already taken (so with ``warmup_end >= 1`` update 0 moves
    nothing)."""

    def __init__(self, lr: float, weight_decay: float, factor: Callable[[int], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.weight_decay, self.factor = lr, weight_decay, factor
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               opt_state: dict) -> None:
        """One update of ``params`` in place; ``opt_state`` is advanced."""
        b1, b2 = self.b1, self.b2
        lr = self.lr * self.factor(opt_state["count"])
        opt_state["count"] += 1
        c1, c2 = 1 - b1 ** opt_state["count"], 1 - b2 ** opt_state["count"]
        for k, p in params.items():
            g = grads[k].float()
            mu = (1 - b1) * g + b1 * opt_state["mu"][k]
            nu = (1 - b2) * g.square() + b2 * opt_state["nu"][k]
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.weight_decay * p
            p.add_(upd, alpha=-lr)
            opt_state["mu"][k], opt_state["nu"][k] = mu, nu


def make_waffleiron_optimizer(
    lr: float = 0.001,
    weight_decay: float = 0.003,
    warmup_end: int = 4000,
    max_iter: int = 45000,
    factor_min: float = 0.00001,
) -> WaffleAdamW:
    """AdamW + the reference WarmupCosine factor (``launch_train.py``
    defaults: lr 1e-3, wd 3e-3, warmup 4 epochs of the 45-epoch run)."""
    return WaffleAdamW(lr, weight_decay, warmup_cosine_factor(warmup_end, max_iter, factor_min))


@dataclasses.dataclass
class WaffleTrainState:
    opt_state: dict
    step: int


def create_waffle_state(net: Segmenter, tx: WaffleAdamW) -> WaffleTrainState:
    """The optimizer state over ``net``'s parameters (as they stand: seed
    them with ``net.reset_parameters`` or load weights first)."""
    return WaffleTrainState(opt_state=tx.init(dict(net.named_parameters())), step=0)


def _per_scan(net: Segmenter, batch: PointBatch):
    """``net`` on each scan of ``batch``: the logits ``[B * N, C]``; in
    training mode every BatchNorm's parked statistics become the mean over
    the scans of each scan's."""
    bns = [m for m in net.modules() if isinstance(m, BatchNorm)]
    logits, parked = [], {m: [] for m in bns}
    for b in range(batch.feats.shape[0]):
        lg, _ = net(batch.feats[b], batch.neighbors[b], batch.cell_inds[b], batch.mask[b])
        logits.append(lg)
        for m in bns:
            if m.pending:
                parked[m].append(m.pending.pop(None))
    for m, stats in parked.items():
        if stats:
            m.pending[None] = tuple(torch.stack(s).mean(0) for s in zip(*stats))
    return torch.cat(logits)


def waffleiron_train_step(state: WaffleTrainState, batch: PointBatch, *, net: Segmenter,
                          tx: WaffleAdamW, lovasz_weight: float = 1.0):
    """One step: the forward scan by scan, the loss over the flattened
    batch, the update of ``net``'s parameters and running statistics in
    place, and the step's confusion matrix for streaming mIoU.  Returns
    the new state and ``{"loss", "hist"}`` (tensors on the batch's
    device)."""
    net.train()
    params = dict(net.named_parameters())
    flat_logits = _per_scan(net, batch)
    labels, valid = batch.labels.reshape(-1), batch.mask.reshape(-1)
    loss = semseg_loss(flat_logits, labels, valid, lovasz_weight)
    grads = torch.autograd.grad(loss, list(params.values()))
    tx.update(params, dict(zip(params, grads)), state.opt_state)
    commit_batch_stats(net)
    hist = fast_hist(flat_logits.detach().argmax(-1), labels, valid, net.n_classes)
    return (WaffleTrainState(opt_state=state.opt_state, step=state.step + 1),
            {"loss": loss.detach(), "hist": hist})


@torch.no_grad()
def waffleiron_eval_step(state: WaffleTrainState, batch: PointBatch, *, net: Segmenter):
    """The eval-mode forward of every scan, the loss and the confusion
    matrix over the flattened batch: ``{"loss", "hist"}``."""
    net.eval()
    flat_logits = _per_scan(net, batch)
    labels, valid = batch.labels.reshape(-1), batch.mask.reshape(-1)
    return {"loss": semseg_loss(flat_logits, labels, valid),
            "hist": fast_hist(flat_logits.argmax(-1), labels, valid, net.n_classes)}


# ---------------------------------------------------------------------------
# Trainer (reference utils/trainer.py:25-306)
# ---------------------------------------------------------------------------


class WaffleIronTrainer:
    """Epoch loop with streaming confusion metrics, per-epoch logging, and
    best/last checkpoints keyed on val mIoU.  :attr:`step_sec` holds the
    host seconds of every train step (each ends in reading its loss)."""

    def __init__(
        self,
        net: Segmenter,
        tx: WaffleAdamW,
        state: WaffleTrainState,
        out_dir: str,
        lovasz_weight: float = 1.0,
    ):
        self.net = net
        self.tx = tx
        self.state = state
        self.out_dir = out_dir
        self.lovasz_weight = lovasz_weight
        self.best_miou = 0.0
        self.current_epoch = 0
        self.step_sec: List[float] = []
        os.makedirs(out_dir, exist_ok=True)

    def _scores(self, hist: np.ndarray) -> Dict[str, float]:
        ious = per_class_iu(hist)
        return {
            "oAcc": 100 * overall_accuracy(hist),
            "mAcc": 100 * float(np.nanmean(per_class_accuracy(hist))),
            "mIoU": 100 * float(np.nanmean(ious)),
            "ious": [float(100 * v) for v in ious],
        }

    def one_epoch(self, batches, training=True) -> Dict[str, float]:
        hist = 0
        running = 0.0
        n = 0
        t0 = time.time()
        for batch in batches:
            t_step = time.perf_counter()
            if training:
                self.state, logs = waffleiron_train_step(
                    self.state, batch, net=self.net, tx=self.tx,
                    lovasz_weight=self.lovasz_weight)
            else:
                logs = waffleiron_eval_step(self.state, batch, net=self.net)
            running += float(logs["loss"])
            if training:
                self.step_sec.append(time.perf_counter() - t_step)
            hist = hist + logs["hist"].cpu().numpy()
            n += 1
        out = self._scores(hist)
        out["loss"] = running / max(n, 1)
        out["sec"] = time.time() - t0
        tag = "train" if training else "val"
        line = (
            f"epoch {self.current_epoch} [{tag}] loss={out['loss']:.3f} "
            f"oAcc={out['oAcc']:.1f} mAcc={out['mAcc']:.1f} "
            f"mIoU={out['mIoU']:.1f} ({out['sec']:.1f}s)"
        )
        print(line)
        with open(os.path.join(self.out_dir, "log.jsonl"), "a") as f:
            f.write(json.dumps({"epoch": self.current_epoch, "tag": tag, **out}) + "\n")
        return out

    def save_state(self, best=False):
        """``ckpt_best.pkl`` / ``ckpt_last.pkl``: ``{"epoch", "best_miou",
        "model"}`` (the ``state_dict`` as numpy arrays, which
        :func:`pasco_torch.convert.load_waffleiron_state_dict` reads) and
        ``"opt_state"``, ``"step"``."""
        name = "ckpt_best.pkl" if best else "ckpt_last.pkl"
        opt = self.state.opt_state

        def host(d):
            return {k: v.detach().cpu().numpy() for k, v in d.items()}

        payload = {
            "epoch": self.current_epoch,
            "best_miou": self.best_miou,
            "model": host(self.net.state_dict()),
            "opt_state": {"count": opt["count"], "mu": host(opt["mu"]), "nu": host(opt["nu"])},
            "step": self.state.step,
        }
        with open(os.path.join(self.out_dir, name), "wb") as f:
            pickle.dump(payload, f)

    def load_state(self, best=False):
        name = "ckpt_best.pkl" if best else "ckpt_last.pkl"
        with open(os.path.join(self.out_dir, name), "rb") as f:
            payload = pickle.load(f)
        dev = next(self.net.parameters()).device

        def dev_of(d):
            return {k: torch.from_numpy(v).to(dev) for k, v in d.items()}

        self.net.load_state_dict(dev_of(payload["model"]))
        opt = payload["opt_state"]
        self.state = WaffleTrainState(
            opt_state={"count": opt["count"], "mu": dev_of(opt["mu"]), "nu": dev_of(opt["nu"])},
            step=payload["step"])
        self.best_miou = payload["best_miou"]
        self.current_epoch = payload["epoch"] + 1

    def train(self, train_batches_fn, val_batches_fn, max_epoch: int):
        """``*_batches_fn()`` -> iterable of :class:`PointBatch` per epoch
        (callables so augmentation re-draws every epoch)."""
        for _ in range(self.current_epoch, max_epoch):
            self.one_epoch(train_batches_fn(), training=True)
            scores = self.one_epoch(val_batches_fn(), training=False)
            if scores["mIoU"] > self.best_miou:
                self.best_miou = scores["mIoU"]
                self.save_state(best=True)
                print(f"*** new best mIoU {self.best_miou:.1f}")
            self.save_state()
            self.current_epoch += 1
