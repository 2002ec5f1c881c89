"""Gradient accumulation of the port against the reference's on the CPU,
in f32: two microbatches (``grad_step`` on two scenes, then
``apply_grads``) at ``tests/test_torch_train.py:step_config()`` against
``pasco_tpu.training.step.grad_step`` / ``accumulate_grads`` /
``apply_grads`` on shared weights (one JAX compile, the jitted
``grad_step``), within ``test_torch_train.py``'s bounds for the gradients
(here the window's mean), for the running statistics after both
microbatches and for the update.  The port runs with ``remat=True``, the
reference without.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch
from test_torch_convert import flatten, nest, perturbed
from test_torch_train import (
    T, check_gradients, check_running_stats_and_update, step_config, synthetic_batch)

from pasco_torch.convert import flax_to_torch, torch_to_flax
from pasco_torch.models.unet import build_net, scene_to_model_input
from pasco_torch.training import step as tstep

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def accumulated():
    from pasco_tpu.training import step as jstep
    from pasco_tpu.training.optim import make_optimizer

    cfg = step_config()
    cols = [synthetic_batch(cfg, seed=s) for s in (0, 1)]
    pcfg = cfg.replace(model=dataclasses.replace(cfg.model, remat=True))
    net = build_net(pcfg, device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(0))
    flat = perturbed(torch_to_flax(net.state_dict()), seed=1)
    net.load_state_dict(flax_to_torch(flat), strict=True)
    freqs = {s: np.random.RandomState(s).rand(cfg.model.n_classes) + 0.1 for s in (1, 2, 4)}
    lw_np = tstep.labelweights_for(cfg, freqs)
    cw_np = tstep.class_weight_vector(cfg.model.n_classes, cfg.loss.no_object_weight)

    # the reference: grad_step per microbatch (its running statistics
    # carried), accumulate_grads, apply_grads on the sum
    from pasco_tpu.models.dense_unet import DensePaSCoNet

    tx = make_optimizer(cfg.optim)
    v = nest(flat)
    jstate = jstep.TrainState(v["params"], v["batch_stats"], tx.init(v["params"]),
                              jax.numpy.zeros((), jax.numpy.int32))
    grad_fn = jax.jit(lambda st, i, t, k: jstep.grad_step(
        st, i, t, k, net=DensePaSCoNet(cfg), labelweights={s: jax.numpy.asarray(w) for s, w
                                                             in lw_np.items()},
        class_weight=jax.numpy.asarray(cw_np), cfg=cfg))
    acc = None
    for k, col in enumerate(cols):
        grads, _, new_bs = grad_fn(jstate, jstep.scene_to_model_input(col),
                                   jstep.targets_to_device(col.targets), jax.random.PRNGKey(k))
        jstate = jstate._replace(batch_stats=new_bs)
        acc = jstep.accumulate_grads(acc, grads)
    mean = jax.tree_util.tree_map(lambda g: g / 2, acc)
    new = jstep.apply_grads(jstate, acc, 2, tx=tx)
    ref = dict(
        grads=flax_to_torch(flatten({"params": mean})),
        params=flax_to_torch(flatten({"params": new.params})),
        stats=flax_to_torch(flatten({"batch_stats": new.batch_stats})),
        stats_before=flax_to_torch({k: v for k, v in flat.items()
                                    if k.startswith("batch_stats/")}),
        logs={"grad_norm": optax.global_norm(mean)}, step=int(new.step))

    # the port: two grad_steps add into .grad, apply_grads takes the mean
    state = tstep.create_train_state(net, pcfg)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    lw, cw = {s: T(w) for s, w in lw_np.items()}, T(cw_np)
    tstep.zero_grads(state)
    for k, col in enumerate(cols):
        tstep.grad_step(state, scene_to_model_input(col, "cpu"),
                        tstep.targets_to_device(col.targets, "cpu"), lw, cw, pcfg,
                        tstep.step_generator(0, k, "cpu"))
    mean_t = {k: None if p.grad is None else p.grad / 2 for k, p in net.named_parameters()}
    norm = tstep.apply_grads(state, 2)
    got = dict(grads=mean_t, net=net, before=before, norm=float(norm), step=state.step)
    return cfg, ref, got


def test_accumulated_gradients_match_reference(accumulated):
    _, ref, got = accumulated
    check_gradients(ref, got)
    np.testing.assert_allclose(got["norm"], float(ref["logs"]["grad_norm"]), rtol=1e-3)


def test_accumulated_update_matches_reference(accumulated):
    cfg, ref, got = accumulated
    check_running_stats_and_update(cfg, ref, got)
    assert got["step"] == ref["step"] == 1
