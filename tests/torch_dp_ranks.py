"""Rank workers of the port's data-parallel tests (``tests/test_torch_parallel*.py``).

``pasco_torch.parallel.mesh.spawn_ranks`` runs them in new processes, which
import this module by name: it imports torch and ``pasco_torch`` only, so a
rank starts in seconds.  Every result is on the CPU.
"""

import contextlib

import torch
import torch.distributed as dist

from pasco_torch.models import norm
from pasco_torch.models.unet import build_net
from pasco_torch.parallel.mesh import (
    dp_eval_step, dp_train_step, replicate_to_group, shard_scenes)
from pasco_torch.training import step as tstep


def cut_all_reduce_sum(t, group):
    """A BatchNorm reduction that a plain ``dist.all_reduce`` makes: the
    sum over the ranks in the forward, but the backward passes this rank's
    cotangent only, so the other ranks' losses no longer reach the
    statistics' gradient."""
    total = t.detach().clone()
    dist.all_reduce(total, group=group)
    return t + (total - t.detach())


@contextlib.contextmanager
def bn_reduction(cut: bool):
    saved = norm.all_reduce_sum
    if cut:
        norm.all_reduce_sum = cut_all_reduce_sum
    try:
        yield
    finally:
        norm.all_reduce_sum = saved


def _grid_coords(grids):
    return {s: (g.coords.clone(), g.mask.clone()) for s, g in grids.items()}


def train_rank(rank, world, cfg, scene_sets, init_sd, lw, cw, sync_bn, fold_axis_rng,
               cut_bn_grad=False, seed=0):
    """For each list of ``scene_sets``, one ``dp_train_step`` of this
    rank's share of it from ``init_sd`` (rank 0's, replicated: the other
    ranks start from another init).  Returns one record per set: the logs,
    the mean gradient (``.grad`` over the scenes of the group), the state
    dict before and after, and this rank's extraction coords of its first
    scene."""
    torch.set_num_threads(1)
    group = dist.group.WORLD
    lw = {s: torch.as_tensor(v) for s, v in lw.items()}
    cw = torch.as_tensor(cw)
    out = []
    for scenes in scene_sets:
        net = build_net(cfg, "cpu", process_group=group if sync_bn else None)
        if rank == 0:
            net.load_state_dict(init_sd)
        else:
            net.reset_parameters(torch.Generator().manual_seed(100 + rank))
        state = replicate_to_group(tstep.create_train_state(net, cfg), group)
        before = {k: v.clone() for k, v in net.state_dict().items()}
        outs = []
        net.register_forward_hook(lambda _m, _i, o: outs.append(o))
        mine = shard_scenes(scenes, rank, world)
        with bn_reduction(cut_bn_grad):
            logs = dp_train_step(state, mine, seed, group=group, labelweights=lw,
                                 class_weight=cw, cfg=cfg, fold_axis_rng=fold_axis_rng)
        n = world * len(mine)
        out.append(dict(
            logs={k: v.clone() for k, v in logs.items()},
            grads={k: p.grad / n for k, p in net.named_parameters()},
            before=before, after=net.state_dict(), step=state.step,
            sem_grids=_grid_coords(outs[0].sem_grids),
            panop_grids=_grid_coords(outs[0].panop_grids)))
    return out


def eval_rank(rank, world, cfg, scenes, init_sd):
    """``dp_eval_step`` of this rank's share of ``scenes`` on ``init_sd``."""
    torch.set_num_threads(1)
    net = build_net(cfg, "cpu")
    net.load_state_dict(init_sd)
    tp, fp, fn = dp_eval_step(net, shard_scenes(scenes, rank, world),
                              group=dist.group.WORLD, n_classes=cfg.model.n_classes)
    return torch.stack([tp, fp, fn])


def replicate_rank(rank, world, cfg):
    """A state that differs on every rank (init, optimizer moments, step and
    count), then ``replicate_to_group``; returns its tensors and counts and
    whether any tensor of this rank changed."""
    net = build_net(cfg, "cpu")
    net.reset_parameters(torch.Generator().manual_seed(rank))
    state = tstep.create_train_state(net, cfg)
    gen = torch.Generator().manual_seed(10 + rank)
    for moments in (state.opt.mu, state.opt.nu):
        for v in moments.values():
            v.copy_(torch.rand(v.shape, generator=gen).to(v.dtype))
    state.step = state.opt.count = 7 if rank == 0 else 3

    def tensors():
        out = {k: v.clone() for k, v in net.state_dict().items()}
        out.update({f"mu/{k}": v.clone() for k, v in state.opt.mu.items()})
        out.update({f"nu/{k}": v.clone() for k, v in state.opt.nu.items()})
        return out

    before = tensors()
    replicate_to_group(state, dist.group.WORLD)
    after = tensors()
    return dict(step=state.step, count=state.opt.count, tensors=after,
                differed=any(not torch.equal(before[k], after[k]) for k in after))
