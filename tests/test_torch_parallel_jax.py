"""The port's data-parallel train step (``pasco_torch/parallel/mesh.py``)
against the reference's ``dp_train_step`` on the CPU, in f32.

Two ranks of the port (spawned gloo processes, file rendezvous) and a
2-device mesh of the reference (``tests/conftest.py``'s virtual CPU
devices) each take one step on the same two distinct scenes, one per rank,
from the same perturbed weights, at ``step_config(n_infers=2)`` (the
decoder caps raised so that no cap binds and no Gumbel draw matters, no
dropout: ``tests/test_torch_train.py``), without SyncBN here and with it in
``tests/test_torch_parallel_syncbn.py``.  Held to the bounds of
``tests/test_torch_train.py``: each rank's extraction coords identical to
its device's, every loss term and ``grad_norm`` (the mean over the ranks),
every parameter's mean gradient, the averaged running statistics and the
update.  The reference runs once per configuration (``_reference_dp``);
its mean gradient comes out through the optimizer's state
(:class:`GradsOut`), each device's coords through a debug callback
(:class:`Recorder`).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dp_ranks
from test_torch_convert import flatten, nest, perturbed
from test_torch_train import (
    _reference_fns, check_gradients_across_seeds, check_loss_terms,
    check_running_stats_and_update, check_step_coords, step_config, synthetic_batch)

from pasco_torch.convert import flax_to_torch
from pasco_torch.models.unet import build_net
from pasco_torch.parallel.mesh import spawn_ranks

torch.set_num_threads(1)
WORLD = 2
SEEDS = range(5)


class GradsOut:
    """An optax transformation that also hands the gradient it was given
    out through its state."""

    def __init__(self, tx):
        self.tx = tx

    def init(self, params):
        return self.tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(self, grads, state, params):
        updates, inner = self.tx.update(grads, state[0], params)
        return updates, (inner, grads)


class Recorder:
    """The reference net; its forward hands each device's extraction coords
    and masks to the host (``store[device index]``)."""

    def __init__(self, net, store):
        self.net, self.store = net, store

    def apply(self, *args, **kw):
        res = self.net.apply(*args, **kw)
        out = res[0]
        grids = {w: {s: (g.coords, g.mask) for s, g in getattr(out, w).items()}
                 for w in ("sem_grids", "panop_grids")}
        jax.debug.callback(self._put, jax.lax.axis_index("data"), grids)
        return res

    def _put(self, idx, grids):
        self.store[int(idx)] = jax.tree_util.tree_map(np.asarray, grids)


def loss_weights(cfg):
    """The label and class weights of ``run_both_steps``."""
    from pasco_torch.training import step as tstep

    freqs = {s: np.random.RandomState(s).rand(cfg.model.n_classes) + 0.1 for s in (1, 2, 4)}
    return (tstep.labelweights_for(cfg, freqs),
            tstep.class_weight_vector(cfg.model.n_classes, cfg.loss.no_object_weight))


@functools.lru_cache(maxsize=None)
def _reference_dp(cfg, sync_bn):
    """The reference's ``dp_train_step`` on a 2-device mesh, jitted once
    per configuration and SyncBN setting."""
    from pasco_tpu.models.dense_unet import DensePaSCoNet
    from pasco_tpu.parallel.mesh import dp_train_step, make_mesh
    from pasco_tpu.training.optim import make_optimizer

    lw_np, cw_np = loss_weights(cfg)
    store = {}
    net = Recorder(DensePaSCoNet(cfg, axis_name="data" if sync_bn else None), store)
    tx = GradsOut(make_optimizer(cfg.optim))
    mesh = make_mesh(WORLD)
    step = jax.jit(functools.partial(
        dp_train_step, mesh=mesh, net=net, tx=tx,
        labelweights={s: jnp.asarray(w) for s, w in lw_np.items()},
        class_weight=jnp.asarray(cw_np), cfg=cfg))
    return step, tx, mesh, store


def reference_dp_runs(sync_bn, seeds=SEEDS):
    """One data-parallel step of the reference from the same perturbed
    weights on each seed's pair of scenes (``synthetic_batch`` of seeds
    ``2k`` and ``2k + 1``, 500 points per subnet, as
    ``tests/test_torch_mimo_train.py`` draws them).  Returns ``(cfg,
    inputs, refs)``: the port's inputs (the scene pairs, the weights, the
    loss weights) and one ``ref`` dictionary of ``tests/test_torch_train.py``'s
    checks per seed, each device's coords under ``"coords"``."""
    from pasco_tpu.parallel.mesh import replicate_to_mesh, shard_batch_to_mesh, stack_scenes
    from pasco_tpu.training import step as jstep

    cfg = step_config(n_infers=2)
    sets = [[synthetic_batch(cfg, seed=2 * k + r, n_points=500) for r in range(WORLD)]
            for k in seeds]
    lw_np, cw_np = loss_weights(cfg)
    init, _, _ = _reference_fns(cfg, True)
    flat = perturbed(flatten(init(jstep.scene_to_model_input(sets[0][0]),
                                  {s: jnp.asarray(w) for s, w in lw_np.items()})), seed=1)
    v = nest(flat)
    step, tx, mesh, store = _reference_dp(cfg, sync_bn)
    jstate = replicate_to_mesh(jstep.TrainState(
        v["params"], v["batch_stats"], tx.init(v["params"]), jnp.zeros((), jnp.int32)), mesh)
    refs = []
    for cols in sets:
        inp, tgt = stack_scenes(cols)
        store.clear()
        new_state, jlogs = step(jstate, shard_batch_to_mesh(inp, mesh),
                                shard_batch_to_mesh(tgt, mesh), jax.random.PRNGKey(0))
        jax.effects_barrier()
        refs.append(dict(
            grads=flax_to_torch(flatten({"params": new_state.opt_state[1]})),
            params=flax_to_torch(flatten({"params": new_state.params})),
            stats=flax_to_torch(flatten({"batch_stats": new_state.batch_stats})),
            stats_before=flax_to_torch({k: v for k, v in flat.items()
                                        if k.startswith("batch_stats/")}),
            logs=jlogs, coords=[store[d] for d in range(WORLD)]))
    return cfg, (sets, flax_to_torch(flat), lw_np, cw_np), refs


def port_dp_runs(cfg, inputs, sync_bn, cut_bn_grad=False):
    """The same steps on two ranks of the port (``remat=True``); one
    ``got`` dictionary per seed, from rank 0 (every rank's state is
    asserted identical), each rank's coords under ``"coords"``."""
    sets, init_sd, lw_np, cw_np = inputs
    pcfg = cfg.replace(model=dataclasses.replace(cfg.model, remat=True))
    ranks = spawn_ranks(torch_dp_ranks.train_rank, WORLD, pcfg, sets, init_sd, lw_np, cw_np,
                        sync_bn, True, cut_bn_grad)
    gots = []
    for i in range(len(sets)):
        mine = [r[i] for r in ranks]
        for r in mine[1:]:
            assert all(torch.equal(r["after"][k], mine[0]["after"][k]) for k in r["after"])
        net = build_net(pcfg, device="cpu")
        net.load_state_dict(mine[0]["after"])
        gots.append(dict(
            grads=mine[0]["grads"], net=net, before=mine[0]["before"], logs=mine[0]["logs"],
            coords=[{w: r[w] for w in ("sem_grids", "panop_grids")} for r in mine]))
    return gots


def run_dp_both(sync_bn):
    """``(cfg, [(ref, got) per seed], inputs)``."""
    cfg, inputs, refs = reference_dp_runs(sync_bn)
    return cfg, list(zip(refs, port_dp_runs(cfg, inputs, sync_bn))), inputs


def check_coords(ref, got):
    """Each rank's extraction coords are its device's, at every scale."""
    class Grid:
        def __init__(self, coords, mask):
            self.coords, self.mask = (torch.as_tensor(np.array(t)) for t in (coords, mask))

    def outputs(c):
        return type("Out", (), {w: {s: Grid(*g) for s, g in c[w].items()}
                                for w in ("sem_grids", "panop_grids")})

    for r in range(WORLD):
        for which in ("sem_grids", "panop_grids"):
            check_step_coords({"out": outputs(ref["coords"][r])},
                              {"out": outputs(got["coords"][r])}, which)


@pytest.fixture(scope="module")
def dp_runs():
    return run_dp_both(sync_bn=False)


def test_dp_coords_per_rank(dp_runs):
    for ref, got in dp_runs[1]:
        check_coords(ref, got)


def test_dp_loss_terms(dp_runs):
    for ref, got in dp_runs[1]:
        check_loss_terms(ref, got, 2 + 5 * 4 + 2)


def test_dp_gradients(dp_runs):
    check_gradients_across_seeds(dp_runs[1])


def test_dp_running_stats_and_update(dp_runs):
    cfg, pairs, _ = dp_runs
    for ref, got in pairs:
        check_running_stats_and_update(cfg, ref, got, only_where_grads_agree=True)
