"""Data parallelism over ``torch.distributed`` (counterpart of
``pasco_tpu/parallel/mesh.py``).

The reference trains with Lightning DDP over NCCL and SyncBatchNorm
(``scripts/train.py:213-236``); ``pasco_tpu`` gives it as a ``data`` mesh
axis under ``shard_map``.  Here a process group takes the mesh's place:
every rank holds the whole state, takes the loss and gradient of its own
scenes, and the gradients, logged scalars and running statistics are
averaged over the ranks before one identical update on every rank.
BatchNorm statistics are reduced over the ranks (SyncBN) where the net was
built with ``build_net(cfg, process_group=group)`` (off by default, as the
reference's ``axis_name``).

The gradients are reduced explicitly after ``backward()``, in one flat
buffer, not by ``DistributedDataParallel``: DDP's bucket hooks fire inside
``backward()``, where ``torch.utils.checkpoint`` reruns forwards, and a
sem-only step leaves the refiners and the transformer without gradients,
which DDP rejects.  A parameter that no rank reached counts a zero
gradient, as :func:`~pasco_torch.training.step.apply_grads` counts it.

Two differences from the reference, whose behaviour is a fault
(ROADMAP.md, queue 3): a rank that holds several scenes adds every one of
them, as gradient accumulation does (the reference keeps only the first
scene of each device's shard, ``mesh.py:83-84, 201-202``); and
:func:`ssc_counts_from_output` counts ``fn`` over the whole ground truth
inside the subnet box, not only over the extracted cells (``mesh.py:170-175``).

The ranks of one group must run the same collectives in the same order:
every rank takes the same number of scenes (:func:`shard_scenes`) and the
same ``is_predict_panop``, and with SyncBN the training forward runs every
BatchNorm on every rank whatever its scene keeps.

Gloo reduces CUDA tensors, so two ranks can share one card (NCCL refuses
two ranks on one device); several cards take NCCL, one rank per card
(``torchrun --nproc_per_node <cards>``, then ``make_group("nccl")``).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from pasco_torch.models.norm import BatchNorm
from pasco_torch.models.unet import scene_to_model_input
from pasco_torch.training import step as tstep

# per-rank generator seeds: a stand-in for jax.random.fold_in(key, axis_index)
_RANK_STRIDE = 1_000_033
# how long a collective of spawn_ranks' group waits for the other ranks
_RANK_TIMEOUT = datetime.timedelta(minutes=10)


# ---------------------------------------------------------------------------
# the group and placement (make_mesh, replicate_to_mesh, shard_batch_to_mesh)
# ---------------------------------------------------------------------------


def make_group(backend: str = "nccl", init_method: str = "env://", rank: int = -1,
               world_size: int = -1):
    """The group the data-parallel steps reduce over: the default group,
    initialised here (``backend``, ``init_method``, ``rank``,
    ``world_size``; the ``env://`` defaults read what ``torchrun`` sets)
    unless it already is."""
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    return dist.group.WORLD


def _state_tensors(obj) -> List[torch.Tensor]:
    """Every tensor that must agree across ranks: the net's parameters and
    buffers, and for a ``TrainState`` the optimizer's moments."""
    if isinstance(obj, tstep.TrainState):
        opt = obj.opt
        return (_state_tensors(obj.net) + [opt.mu[k] for k in sorted(opt.mu)]
                + [opt.nu[k] for k in sorted(opt.nu)])
    return [t.data for t in obj.parameters()] + list(obj.buffers())


def replicate_to_group(obj, group=None):
    """Rank 0's parameters, buffers and (for a ``TrainState``) optimizer
    moments, update count and step on every rank of ``group``, in place;
    returns ``obj``."""
    src = dist.get_global_rank(group, 0) if group is not None else 0
    ts = _state_tensors(obj)
    for t in ts:
        dist.broadcast(t, src, group=group)
    if isinstance(obj, tstep.TrainState):
        counts = torch.tensor([obj.step, obj.opt.count], dtype=torch.int64,
                              device=ts[0].device)
        dist.broadcast(counts, src, group=group)
        obj.step, obj.opt.count = (int(c) for c in counts.tolist())
    return obj


def shard_scenes(scenes: Sequence, rank: int, world: int) -> List:
    """Rank ``rank``'s share of ``scenes``: the ``rank``-th of ``world``
    equal contiguous blocks, as the reference's ``P("data")`` splits the
    leading axis.  Every rank must take as many scenes."""
    n = len(scenes)
    if n % world:
        raise ValueError(f"{n} scenes do not split evenly over {world} ranks")
    k = n // world
    return list(scenes[rank * k:(rank + 1) * k])


def _all_reduce_flat(ts: Sequence[torch.Tensor], group, scale: float = 1.0) -> None:
    """Sum ``ts`` (f32, on one device) over the ranks of ``group`` in place,
    as one flat buffer, then multiply by ``scale``."""
    flat = torch.cat([t.reshape(-1) for t in ts])
    dist.all_reduce(flat, group=group)
    if scale != 1.0:
        flat *= scale
    o = 0
    for t in ts:
        t.copy_(flat[o:o + t.numel()].view_as(t))
        o += t.numel()


# ---------------------------------------------------------------------------
# the training step (mesh.py:53-128)
# ---------------------------------------------------------------------------


def rank_generator(seed: int, micro: int, rank: int, fold_axis_rng: bool, device):
    """The generator of microbatch ``micro``'s draws on ``rank``: with
    ``fold_axis_rng`` the rank is folded into the seed (``mesh.py:74-77``),
    without it every rank draws what ``step_generator(seed, micro)`` draws,
    the single-device step's generator."""
    if fold_axis_rng:
        seed = seed * _RANK_STRIDE + rank + 1
    return tstep.step_generator(seed, micro, device)


def dp_train_step(state: tstep.TrainState, scenes: Sequence, rng_seed: int, *, group,
                  labelweights: Dict[int, torch.Tensor], class_weight: torch.Tensor,
                  cfg, is_predict_panop: bool = True,
                  fold_axis_rng: bool = True) -> Dict[str, torch.Tensor]:
    """One data-parallel optimisation step in place on every rank of
    ``group`` (``pasco_tpu/parallel/mesh.py:53-128``).

    ``scenes`` are this rank's collated scenes (:func:`shard_scenes`).
    Each goes through :func:`~pasco_torch.training.step.grad_step`, which
    adds its gradient into ``.grad`` and folds its batch statistics into
    the running ones; scene ``k`` draws from :func:`rank_generator` at
    ``state.step * len(scenes) + k``.  Then, over the ranks: the gradient
    sum and the logs' sum are reduced and divided by the number of scenes
    in the group (the mean gradient), the running statistics are averaged,
    and :func:`~pasco_torch.training.step.apply_grads` clips and updates
    on the mean gradient on every rank.  Returns the logs' mean over every
    scene of the group, with ``grad_norm``, the pre-clip norm of the mean
    gradient."""
    net = state.net
    dev = next(net.parameters()).device
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    k = len(scenes)
    tstep.zero_grads(state)
    sums: Dict[str, torch.Tensor] = {}
    for i, scene in enumerate(scenes):
        gen = rank_generator(rng_seed, state.step * k + i, rank, fold_axis_rng, dev)
        logs = tstep.grad_step(state, scene_to_model_input(scene, dev),
                               tstep.targets_to_device(scene.targets, dev), labelweights,
                               class_weight, cfg, gen, is_predict_panop)
        for key, v in logs.items():
            sums[key] = sums[key] + v if key in sums else v.float()
    n = world * k
    params = list(state.opt.params.values())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _all_reduce_flat([p.grad for p in params], group)
    keys = sorted(sums)
    logs_vec = torch.stack([sums[key] for key in keys])
    _all_reduce_flat([logs_vec], group, 1.0 / n)
    stats = [b for m in net.modules() if isinstance(m, BatchNorm) for b in (m.mean, m.var)]
    _all_reduce_flat(stats, group, 1.0 / world)
    out = dict(zip(keys, logs_vec))
    out["grad_norm"] = tstep.apply_grads(state, n)
    return out


# ---------------------------------------------------------------------------
# evaluation (mesh.py:143-220)
# ---------------------------------------------------------------------------


def ssc_counts_from_output(out, semantic_dense: torch.Tensor, subnet_min: torch.Tensor,
                           n_classes: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class int64 ``(tp, fp, fn)`` of the scale-1 semantic prediction
    of subnet 0 (the argmax of its logits at the extracted cells) against
    subnet 0's dense ground truth ``semantic_dense [X, Y, Z]`` (the subnet
    frame, from ``subnet_min``), 255 ignored (``mesh.py:143-177``).  ``tp``
    and ``fp`` count the extracted cells inside the ground truth's box;
    ``fn`` is the class's ground-truth cell count minus ``tp``, so a cell
    the extraction missed counts too (the reference counts only extracted
    cells)."""
    grid = out.sem_grids[1]
    coords, mask = grid.coords[..., -3:], grid.mask
    if coords.dim() == 3:         # per-subnet grids: subnet 0
        coords, mask = coords[0], mask[0]
    pred = out.sem_logits[1][:, 0].argmax(-1)
    shape = torch.tensor(semantic_dense.shape, device=coords.device)
    rel = coords.long() - subnet_min.long()[None]
    in_box = mask & (rel >= 0).all(-1) & (rel < shape).all(-1)
    relc = torch.minimum(rel.clamp(min=0), shape - 1)
    gt = semantic_dense.long()[relc[:, 0], relc[:, 1], relc[:, 2]]
    valid = in_box & (gt != 255)
    cls = torch.arange(n_classes, device=coords.device)
    p = (pred[:, None] == cls) & valid[:, None]
    g = (gt[:, None] == cls) & valid[:, None]
    tp = (p & g).sum(0)
    fp = (p & ~g).sum(0)
    gt_count = torch.bincount(semantic_dense.reshape(-1).long(), minlength=256)[:n_classes]
    return tp, fp, gt_count - tp


@torch.no_grad()
def dp_eval_step(net, scenes: Sequence, *, group, n_classes: int):
    """The eval forward of this rank's ``scenes`` and their per-class
    ``(tp, fp, fn)`` (:func:`ssc_counts_from_output`), summed over the
    scenes and over the ranks of ``group``: every rank returns the group's
    counts (``mesh.py:180-220``, the reference's ``sync_dist=True``)."""
    dev = next(net.parameters()).device
    net.eval()
    total = torch.zeros((3, n_classes), dtype=torch.int64, device=dev)
    for scene in scenes:
        inp = scene_to_model_input(scene, dev)
        gt = torch.as_tensor(scene.targets.semantic_dense[0]).to(dev)
        total += torch.stack(ssc_counts_from_output(net(inp), gt, inp.subnet_min[0],
                                                    n_classes))
    dist.all_reduce(total, group=group)
    return total[0], total[1], total[2]


# ---------------------------------------------------------------------------
# ranks on one host
# ---------------------------------------------------------------------------


def _rank_main(rank, fn, world, tmp, args):
    dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "rendezvous"),
                            rank=rank, world_size=world, timeout=_RANK_TIMEOUT)
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh, protocol=pickle.HIGHEST_PROTOCOL)


def spawn_ranks(fn: Callable, world: int, *args) -> List:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes
    (``torch.multiprocessing.spawn``) joined in one default gloo group, and
    return each rank's result in rank order.  The rendezvous is a file in a
    new temporary directory, so no port is involved; each rank pickles its
    result there.  ``fn`` must be importable by name (a module's top-level
    function).  A failed rank ends the others and raises with its
    traceback; a collective that waits longer than ten minutes fails."""
    with tempfile.TemporaryDirectory(prefix="pasco_ranks_") as tmp:
        torch.multiprocessing.spawn(_rank_main, args=(fn, world, tmp, args), nprocs=world)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
    return out
