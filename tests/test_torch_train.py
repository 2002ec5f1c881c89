"""The port's training slice against the JAX reference on the CPU, in f32.

* BatchNorm in training mode against ``MaskedBatchNorm``, ``DenseBN`` and
  ``DenseBNResizeCoords``: outputs and the updated running statistics at
  ``rtol=1e-4, atol=1e-5`` (same f32 math, another summation order).
* One whole train step at ``tiny_f32_config()`` with the decoder caps
  raised to the box's cell count (no cap binds, so the Gumbel draws do not
  matter) against ``pasco_tpu.training.step.train_step``'s body on shared
  weights and inputs (one JAX compile, shared through a module fixture).
  The port runs with ``remat=True`` (the reference with ``remat=False``:
  same function, cheaper compile), so its rematerialised forward and the
  running statistics' once-per-step fold are exercised.  Required:
  identical extraction coords at every scale; every loss term within
  ``rtol=1e-3, atol=1e-5``; every parameter's gradient within the bounds
  stated at ``test_step_gradients`` (bf16 rounding inside the model sets
  them); the updated running statistics within
  ``rtol=1e-3, atol=1e-5``, every one of them moved; the parameters after
  the update (``lr=1e-3``, no warmup) within ``2 * lr + 1e-6`` (Adam's
  first step is ``lr * g / (|g| + 1e-8)`` on the clipped gradient, whose
  sign is noise below the gradient tolerance), and the update itself
  within ``1e-3 * lr`` wherever ``|g_ref|`` exceeds twice the gradient
  tolerance and the clipped ``|g_ref|`` exceeds ``1e-5``.
* The trainer (``pasco_torch/training/loop.py:train``): 5 steps on one
  synthetic scene at ``tiny_config`` lower the loss (the counterpart of
  ``tests/test_train_step.py:29-66``).

The panoptic target slots are capped at the query count: with more slots
than queries the reference's in-graph assignment is inexact
(``tests/test_torch_losses.py``), and the port's host solver is exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from chip_smoke import STRUCTURALLY_ZERO
from test_torch_convert import flatten, nest, perturbed, tiny_f32_config

from pasco_tpu.core.config import OptimConfig, tiny_config
from pasco_tpu.core.sparse import Box as JBox
from pasco_tpu.data.semantic_kitti.collate import collate
from pasco_tpu.data.semantic_kitti.dataset import process_scene
from pasco_tpu.data.synthetic import make_scene
from pasco_tpu.ops import dense_ops as jd
from pasco_torch.convert import flax_to_torch
from pasco_torch.core.sparse import Box
from pasco_torch.models.norm import BatchNorm, commit_batch_stats
from pasco_torch.models.unet import build_net, scene_to_model_input

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, ref, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


# --------------------------------------------------------------------------
# BatchNorm in training mode
# --------------------------------------------------------------------------


def _bn_vars(r, c, shape=None):
    shape = (c,) if shape is None else shape
    return (
        {"scale": (r.rand(*shape) + 0.5).astype(np.float32),
         "bias": (r.randn(*shape) * 0.1).astype(np.float32)},
        {"mean": (r.randn(*shape) * 0.1).astype(np.float32),
         "var": (r.rand(*shape) + 0.5).astype(np.float32)},
    )


def _port_bn(params, stats, shape):
    bn = BatchNorm(shape)
    bn.load_state_dict({k: T(v) for k, v in {**params, **stats}.items()})
    return bn.train()


def test_masked_batchnorm_train():
    """Point-MLP BN (``MaskedBatchNorm``) on ``[N, C]`` rows."""
    from pasco_tpu.models.norm import MaskedBatchNorm

    r = np.random.RandomState(0)
    x = (r.randn(300, 6) * 2 + 1).astype(np.float32)
    m = r.rand(300) < 0.6
    params, stats = _bn_vars(r, 6)
    ref, upd = MaskedBatchNorm().apply({"params": params, "batch_stats": stats},
                                       x, m, True, mutable=["batch_stats"])
    bn = _port_bn(params, stats, 6)
    close(bn(T(x), T(m)).detach(), ref)
    commit_batch_stats(bn)
    close(bn.mean, upd["batch_stats"]["mean"])
    close(bn.var, upd["batch_stats"]["var"])


@pytest.mark.parametrize("with_mask", [True, False])
def test_dense_batchnorm_train(with_mask):
    """Volume BN: ``DenseBN`` (masked statistics) and, without a mask, the
    bottleneck's ``DenseBatchNorm`` (every cell)."""
    from pasco_tpu.models.dense_unet import DenseBN
    from pasco_tpu.models.norm import DenseBatchNorm

    r = np.random.RandomState(1)
    x = (r.randn(6, 4, 10, 5) * 2 + 0.5).astype(np.float32)
    m = r.rand(6, 4, 10) < 0.5
    params, stats = _bn_vars(r, 5)
    v = {"params": params, "batch_stats": stats}
    if with_mask:
        ref, upd = DenseBN().apply(v, x, m, True, mutable=["batch_stats"])
    else:
        ref, upd = DenseBatchNorm().apply(v, x, True, mutable=["batch_stats"])
    bn = _port_bn(params, stats, 5)
    got = bn(T(x), T(m) if with_mask else None).detach()
    close(got, ref)
    bn.pending.clear()
    bn(T(x), T(m) if with_mask else None)      # a rematerialised re-run
    commit_batch_stats(bn)                      # folds in once
    close(bn.mean, upd["batch_stats"]["mean"])
    close(bn.var, upd["batch_stats"]["var"])


def test_bn_resize_coords_train():
    """``resize_bn`` + the 1x1 resize with the coordinate statistics from
    mask marginals (``DenseBNResizeCoords`` on the packed layout)."""
    from pasco_tpu.models.dense_unet import DenseBNResizeCoords
    from pasco_torch.models.dense_unet import DenseDecoderStage

    r = np.random.RandomState(2)
    X, Z, Y, ch, scale = 6, 4, 8, 5, 2
    x = (r.randn(X, Z, Y, ch) + 0.3).astype(np.float32)
    m = r.rand(X, Z, Y) < 0.5
    gmin = np.array([-8, 4, -2], np.int32)
    params, stats = _bn_vars(r, ch + 3)
    wr = (r.randn(1, ch + 3, ch) * 0.3).astype(np.float32)
    br = (r.randn(ch) * 0.1).astype(np.float32)
    box_j = JBox.create(gmin, (X * scale, Y * scale, Z * scale))
    ref, upd = DenseBNResizeCoords().apply(
        {"params": params, "batch_stats": stats}, jd.pack_z2(jnp.asarray(x)),
        jnp.asarray(m), box_j, scale, jnp.asarray(wr[0]), jnp.asarray(br), True,
        mutable=["batch_stats"])
    ref = np.asarray(jd.unpack_z2(ref))

    stage = DenseDecoderStage(2 * ch, ch, 1, 3, 0, scale, False).train()
    stage.resize_bn.load_state_dict({k: T(v) for k, v in {**params, **stats}.items()})
    stage.resize.kernel.data.copy_(T(wr))
    stage.resize.bias.data.copy_(T(br))
    got = stage._resize(T(x), T(m), Box.create(T(gmin), (X * scale, Y * scale, Z * scale)))
    close(got.detach(), ref)
    commit_batch_stats(stage)
    close(stage.resize_bn.mean, upd["batch_stats"]["mean"])
    close(stage.resize_bn.var, upd["batch_stats"]["var"])


# --------------------------------------------------------------------------
# one whole train step against the reference
# --------------------------------------------------------------------------


def step_config(n_infers=1):
    """``tiny_f32_config(n_infers)`` with the decoder caps at the box's cell
    count per scale (no cap binds), the reference's cheaper ``remat=False``,
    and ``lr=1e-3`` without warmup so that the update is well above f32
    rounding of the parameters."""
    cfg = tiny_f32_config(n_infers)
    ex, ey, ez = cfg.scene.box_extent
    n = ex * ey * ez
    cap = dataclasses.replace(cfg.capacity, dec_s4=n // 64, dec_s2=n // 8, dec_s1=n)
    return cfg.replace(model=dataclasses.replace(cfg.model, remat=False), capacity=cap,
                       optim=OptimConfig(lr=1e-3, warmup_steps=0))


def synthetic_batch(cfg, seed=0, n_points=1500):
    """One training scene with targets: a distinct synthetic scan of
    ``n_points`` points per subnet, as the reference's training split
    draws them (``pasco_tpu/data/semantic_kitti/dataset.py:464-489``)."""
    rng = np.random.RandomState(seed)
    views = []
    for _ in range(cfg.model.n_infers):
        scene = make_scene(rng, scene_size=cfg.scene.scene_size, n_points=n_points,
                           point_feat_dim=cfg.model.in_channels - 6, n_things=3)
        views.append(process_scene(scene, None, rng))
    return collate(views, cfg, max_targets=cfg.model.transformer.num_queries, rng=rng)


@functools.lru_cache(maxsize=None)
def _reference_fns(cfg, is_predict_panop):
    """The reference's init and the body of
    ``pasco_tpu.training.step.train_step`` (also returning the gradients
    and the model output), each jitted once per configuration."""
    from pasco_tpu.models.dense_unet import DensePaSCoNet
    from pasco_tpu.training import step as jstep
    from pasco_tpu.training.optim import make_optimizer

    net = DensePaSCoNet(cfg)
    tx = make_optimizer(cfg.optim)
    init = jax.jit(lambda inp, lw: net.init({"params": jax.random.PRNGKey(0)}, inp, lw,
                                            train=False))

    class Capture:     # hands the forward's output out through the aux
        def apply(self, *a, **k):
            res = net.apply(*a, **k)
            self.out = res[0]
            return res

    def step(state, inp, tgt, rng, lw, cw):
        drop_rng, sample_rng = jax.random.split(jax.random.fold_in(rng, state.step))

        def loss_fn(params):
            cap = Capture()
            total, logs, mutated = jstep.compute_losses(
                cap, {"params": params, "batch_stats": state.batch_stats}, inp, tgt,
                lw, cw, cfg, {"dropout": drop_rng, "sample": sample_rng}, train=True,
                is_predict_panop=is_predict_panop)
            return total, (logs, mutated["batch_stats"], cap.out)

        (_, (logs, new_bs, out)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        updates, _ = tx.update(grads, state.opt_state, state.params)
        logs["grad_norm"] = optax.global_norm(grads)
        return grads, optax.apply_updates(state.params, updates), new_bs, logs, out

    return init, tx, jax.jit(step)


def run_both_steps(cfg, col, is_predict_panop=True):
    """One train step of the reference and of the port (with ``remat=True``)
    from the same perturbed weights on ``col``; returns ``(ref, got)``
    dictionaries for the ``check_*`` functions below."""
    from pasco_tpu.training import step as jstep
    from pasco_torch.training import step as tstep

    # The featurizer's scatter-max splits a tie's gradient evenly in the
    # port and pairwise in the reference's scan: keep ties out (no two
    # points of one cell with the same features).
    pts = np.concatenate([col.point_coords, col.point_feats.view(np.int32)], 1)
    pts = pts[col.point_mask]
    assert len(np.unique(pts, axis=0)) == len(pts)
    freqs = {s: np.random.RandomState(s).rand(cfg.model.n_classes) + 0.1 for s in (1, 2, 4)}
    lw_np = tstep.labelweights_for(cfg, freqs)
    cw_np = tstep.class_weight_vector(cfg.model.n_classes, cfg.loss.no_object_weight)
    lw = {s: jnp.asarray(w) for s, w in lw_np.items()}
    init, tx, step = _reference_fns(cfg, is_predict_panop)
    jinp = jstep.scene_to_model_input(col)
    flat = perturbed(flatten(init(jinp, lw)), seed=1)
    v = nest(flat)
    jstate = jstep.TrainState(v["params"], v["batch_stats"], tx.init(v["params"]),
                              jnp.zeros((), jnp.int32))
    grads, new_params, new_bs, jlogs, jout = step(
        jstate, jinp, jstep.targets_to_device(col.targets), jax.random.PRNGKey(0), lw,
        jnp.asarray(cw_np))

    pcfg = cfg.replace(model=dataclasses.replace(cfg.model, remat=True))
    net = build_net(pcfg, device="cpu")
    net.load_state_dict(flax_to_torch(flat), strict=True)
    state = tstep.create_train_state(net, pcfg)
    captured = []
    net.register_forward_hook(lambda _m, _i, o: captured.append(o))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    logs = tstep.train_step(
        state, scene_to_model_input(col, "cpu"), tstep.targets_to_device(col.targets, "cpu"),
        {s: T(w) for s, w in lw_np.items()}, T(cw_np), pcfg,
        is_predict_panop=is_predict_panop)
    tgrads = {k: p.grad for k, p in net.named_parameters()}
    ref = dict(
        grads=flax_to_torch(flatten({"params": grads})),
        params=flax_to_torch(flatten({"params": new_params})),
        stats=flax_to_torch(flatten({"batch_stats": new_bs})),
        stats_before=flax_to_torch({k: v for k, v in flat.items()
                                    if k.startswith("batch_stats/")}),
        logs=jlogs, out=jout)
    got = dict(grads=tgrads, net=net, before=before, logs=logs, out=captured[0])
    return ref, got


@pytest.fixture(scope="module")
def both_steps():
    cfg = step_config()
    return (cfg, *run_both_steps(cfg, synthetic_batch(cfg)))


def check_step_coords(ref, got, which):
    for scale in (1, 2, 4):
        jg, tg = getattr(ref["out"], which)[scale], getattr(got["out"], which)[scale]
        np.testing.assert_array_equal(tg.mask.numpy(), np.asarray(jg.mask))
        np.testing.assert_array_equal(tg.coords.numpy(), np.asarray(jg.coords))
        assert tg.mask.sum() > 0


def check_loss_terms(ref, got, n_terms):
    jl, tl = ref["logs"], got["logs"]
    assert set(tl) == set(jl)
    assert len(jl) == n_terms
    for k in jl:
        close(tl[k].numpy(), jl[k], rtol=1e-3, atol=1e-5)
    assert np.isfinite(float(tl["total_loss"])) and float(tl["grad_norm"]) > 0


def check_gradients(ref, got):
    """Bounds at ``test_step_gradients``.  A parameter the step does not
    reach (the refiners and the transformer in a sem-only step) has a zero
    gradient in the reference and none in the port."""
    assert set(ref["grads"]) == set(got["grads"])
    top = max(g.abs().max().item() for g in ref["grads"].values())
    n_zero = 0
    for k, g_ref in ref["grads"].items():
        g = got["grads"][k]
        if g is None:
            assert not g_ref.any(), k
            continue
        if STRUCTURALLY_ZERO.search(k):
            n_zero += 1
            assert max(g.abs().max().item(), g_ref.abs().max().item()) <= 1e-3 * top, k
            continue
        err = (g - g_ref).abs().max().item()
        bound = 2e-2 * g_ref.abs().max().item() + 1e-6
        assert err <= bound, (k, err, bound)
        assert (g - g_ref).norm() <= 1e-2 * g_ref.norm() + 1e-6, k
    assert 0 < n_zero < len(ref["grads"]) // 4


def check_gradients_across_seeds(runs):
    """The gradient rule of the ``n_infers = 3`` step tests, over the
    ``(ref, got)`` pairs of several seeds (the reason is given in
    ``tests/test_torch_mimo_train.py``): every parameter meets the bounds
    of :func:`check_gradients` on at least one seed, and is within
    ``1e-1 * |g_ref|`` in norm on every seed."""
    met = {}
    for ref, got in runs:
        assert set(ref["grads"]) == set(got["grads"])
        top = max(g.abs().max().item() for g in ref["grads"].values())
        for k, g_ref in ref["grads"].items():
            g = got["grads"][k]
            if g is None:
                assert not g_ref.any(), k
                continue
            if STRUCTURALLY_ZERO.search(k):
                assert max(g.abs().max().item(), g_ref.abs().max().item()) <= 1e-3 * top, k
                continue
            diff, ref_norm = (g - g_ref).norm().item(), g_ref.norm().item()
            assert diff <= 1e-1 * ref_norm + 1e-6, (k, diff / ref_norm)
            strict = ((g - g_ref).abs().max().item() <= 2e-2 * g_ref.abs().max().item() + 1e-6
                      and diff <= 1e-2 * ref_norm + 1e-6)
            met[k] = met.get(k, False) or strict
    missed = sorted(k for k, ok in met.items() if not ok)
    assert met and not missed, missed


def check_running_stats_and_update(cfg, ref, got, only_where_grads_agree=False):
    """Bounds at ``test_step_running_stats_and_update``; the running
    statistics that moved are the ones the reference moved.  With
    ``only_where_grads_agree`` the update itself is compared only where
    the two gradients also agree within :func:`check_gradients`'
    per-element bound (a gradient moved by a ReLU-kink flip moves Adam's
    sign-like first step with it; the gradient rule covers those)."""
    net, before = got["net"], got["before"]
    sd = net.state_dict()
    for k, v in ref["stats"].items():
        close(sd[k].numpy(), v.numpy(), rtol=1e-3, atol=1e-5)
    moved = {k for k, v in ref["stats"].items() if not torch.equal(v, ref["stats_before"][k])}
    assert moved and moved == {k for k in ref["stats"] if not torch.equal(sd[k], before[k])}
    lr = cfg.optim.lr      # no warmup: the first step's rate
    clip = min(1.0, cfg.optim.grad_clip / float(ref["logs"]["grad_norm"]))
    for k, p_ref in ref["params"].items():
        p = dict(net.named_parameters())[k].detach()
        close(p.numpy(), p_ref.numpy(), rtol=0, atol=2 * lr + 1e-6)
        # Where the sign of g is sure and the clipped |g| is far above
        # Adam's eps (1e-8), the first step is lr * (sign(g) + wd * p) in
        # both: compare the update itself.
        g_ref = ref["grads"][k].abs()
        sure = (g_ref > 2 * (2e-2 * g_ref.max() + 1e-6)) & (g_ref * clip > 1e-5)
        if only_where_grads_agree and got["grads"][k] is not None:
            sure &= (got["grads"][k] - ref["grads"][k]).abs() <= 2e-2 * g_ref.max() + 1e-6
        du, du_ref = (p - before[k])[sure], (p_ref - before[k])[sure]
        close(du.numpy(), du_ref.numpy(), rtol=0, atol=1e-3 * lr)


@pytest.mark.parametrize("which", ["sem_grids", "panop_grids"])
def test_step_extraction_coords_identical(both_steps, which):
    _, ref, got = both_steps
    check_step_coords(ref, got, which)


def test_step_loss_terms(both_steps):
    _, ref, got = both_steps
    check_loss_terms(ref, got, 2 + 5 * 4 + 2)   # compl, 5 terms x 4 levels, total, norm


def test_step_gradients(both_steps):
    """Every parameter's gradient.  The model rounds to bf16 inside even in
    an f32 config (the sem logits and their cotangents, the cross
    attention's q, k, v and probabilities), so a cotangent that differs by
    f32 noise can round one bf16 step apart: gradients agree within
    ``1e-2 * |g_ref|`` in norm and ``2e-2 * max|g_ref| + 1e-6`` per
    element (measured: at most 0.43% in norm, median 0.15%).  The
    structurally zero ones (``chip_smoke.STRUCTURALLY_ZERO``: a bias
    feeding a training-mode BN, the attention key biases) are rounding
    noise in both and stay below ``1e-3`` of the largest gradient."""
    _, ref, got = both_steps
    check_gradients(ref, got)


def test_step_running_stats_and_update(both_steps):
    cfg, ref, got = both_steps
    check_running_stats_and_update(cfg, ref, got)


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------


def test_trainer_lowers_loss():
    """``loop.train``: 5 steps on one synthetic scene at ``tiny_config``
    (bf16), ``lr=1e-3``, no warmup: finite losses, the last below the
    first."""
    from pasco_torch.training.loop import train

    cfg = tiny_config(n_infers=1).replace(optim=OptimConfig(lr=1e-3, warmup_steps=0))
    col = synthetic_batch(cfg, seed=3)
    freqs = {s: np.ones(cfg.model.n_classes) for s in (1, 2, 4)}
    state = train(cfg, [col] * 5, device="cpu", class_frequencies=freqs, log=None)
    losses = [h["total_loss"] for h in state.history]
    assert len(losses) == 5 and state.step == 5
    assert all(np.isfinite(losses)), losses
    assert all(h["grad_norm"] > 0 for h in state.history)
    assert losses[-1] < losses[0], losses
