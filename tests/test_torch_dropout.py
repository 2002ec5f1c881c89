"""The port's dropouts against the reference's, on the CPU in f32 at
``tiny_f32_config()`` with every rate set: the point dropout
(``encoder_dropouts[0]``), the whole-channel spatial dropouts after the
last three encoder stages, after the bottleneck and before the heads of
the three decoder stages, and the transformer dropout.

Random draws differ between the packages, so both take the same keep
vectors: the reference through ``flax.linen.intercept_methods`` on
``DenseSpatialDropout.__call__`` and ``nn.Dropout.__call__`` (a seeded
keep per module path, nothing in ``pasco_tpu/`` changed) and a patched
``point_dropout``; the port through ``SpatialDropout.draw``, the hook
``chip_smoke.DecisionPins`` pins on the card, and its ``point_dropout`` and
transformer ``dropout``.  One JAX compile (the training-mode and the
MC-dropout forwards in one jitted function).  Required, in training mode
and under ``mc_dropout``: identical extraction coords at every scale, and
the semantic, query and voxel logits within ``rtol=2e-2, atol=1e-2`` (the
bound of ``tests/test_torch_slice.py``).  The decoder caps are raised to
the box's cell count, so the Gumbel draws of training mode do not matter.

Then the port alone: the eval forward is deterministic; MC samples vary
with the generator and repeat with it; zero rates add no module, no
parameter and no draw, so the MC forward equals the eval forward; and the
draws stay outside the rematerialised regions (a training step's
gradients are the same with and without remat).
"""

import dataclasses
import itertools
import zlib

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
from test_model_forward import make_input
from test_torch_convert import nest, perturbed, tiny_f32_config

from pasco_torch.convert import flax_to_torch, torch_to_flax
from pasco_torch.models import dense_unet as pdu
from pasco_torch.models import transformer as ptr
from pasco_torch.models.unet import ModelInput, build_net
from pasco_torch.training.step import eval_step, mc_eval_step

torch.set_num_threads(1)

RATE = 0.2
POINT_KEEP = 0.97


def dropout_config():
    cfg = tiny_f32_config()
    ex, ey, ez = cfg.scene.box_extent
    n = ex * ey * ez
    m = cfg.model
    return cfg.replace(
        model=dataclasses.replace(
            m, encoder_dropouts=(0.05, 0.0, 0.0, RATE, RATE, RATE),
            decoder_dropouts=(RATE, RATE, RATE, 0.0, 0.0), dense3d_dropout=RATE,
            transformer=dataclasses.replace(m.transformer, dropout=RATE)),
        capacity=dataclasses.replace(cfg.capacity, dec_s4=n // 64, dec_s2=n // 8, dec_s1=n))


def keep_of(name, shape, p_keep=1.0 - RATE):
    """The pinned keep of the module at reference path ``name``."""
    r = np.random.RandomState(zlib.crc32(name.encode()))
    return r.rand(*shape) < p_keep


def transformer_names(cfg):
    """The transformer's dropout sites in call order at n_infers 1."""
    out = []
    for i in range(len(cfg.model.transformer.src_scales)):
        out += [f"transformer/cross_{i}/drop", f"transformer/self_{i}/drop",
                f"transformer/ffn_{i}/drop1", f"transformer/ffn_{i}/drop2"]
    return out


def reference_outputs(cfg, inp, flat, point_keep, monkeypatch):
    """The reference's training-mode and MC-dropout forwards on the pinned
    keeps, in one jitted function."""
    import jax.numpy as jnp
    from test_model_forward import labelweights

    from pasco_tpu.models import dense_unet as jdu

    monkeypatch.setattr(jdu, "point_dropout", lambda pm, rate, rng: pm & point_keep)
    seen = []

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name != "__call__" or not isinstance(
                mod, (jdu.DenseSpatialDropout, fnn.Dropout)):
            return next_fun(*args, **kwargs)
        x = args[0]
        det = kwargs.get("deterministic", args[1] if len(args) > 1 else None)
        if det:
            return x
        name = "/".join(mod.path)
        seen.append(name)
        if isinstance(mod, fnn.Dropout):
            keep = jnp.asarray(keep_of(name, x.shape))
        else:
            c = x.shape[-1] // 2 if mod.packed else x.shape[-1]
            keep = keep_of(name, (c,))
            keep = jnp.asarray(np.concatenate([keep, keep]) if mod.packed else keep)
        return jnp.where(keep, x / (1.0 - mod.rate), 0).astype(x.dtype)

    net = jdu.DensePaSCoNet(cfg)
    lw = labelweights(cfg)
    key = jax.random.PRNGKey(0)

    def both(v, i):
        with fnn.intercept_methods(interceptor):
            train, _ = net.apply(v, i, lw, train=True, mutable=["batch_stats"],
                                 rngs={"dropout": key, "sample": key})
            mc = net.apply(v, i, lw, train=False, mc_dropout=True, rngs={"dropout": key})
        return train, mc

    return jax.jit(both)(nest(flat), inp), seen


@pytest.fixture(scope="module")
def both():
    cfg = dropout_config()
    inp = make_input(cfg, rng=0, n_pts=1500)
    point_keep = keep_of("point", inp.point_mask.shape, POINT_KEEP)
    net = build_net(cfg, device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(0))
    flat = perturbed(torch_to_flax(net.state_dict()), seed=1)
    net.load_state_dict(flax_to_torch(flat), strict=True)
    with pytest.MonkeyPatch.context() as mp:
        (jtrain, jmc), seen = reference_outputs(cfg, inp, flat, point_keep, mp)

    tin = ModelInput(*(torch.from_numpy(np.array(a)) for a in inp))
    order = itertools.cycle(transformer_names(cfg))
    drawn = []

    def draw(self, c, generator, device):
        drawn.append(self.name)
        return torch.from_numpy(keep_of(self.name, (c,)))

    def tdrop(x, rate, live, generator):
        if rate == 0.0 or not live:
            return x
        name = next(order)
        drawn.append(name)
        keep = torch.from_numpy(keep_of(name, tuple(x.shape)))
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pdu.SpatialDropout, "draw", draw)
        mp.setattr(ptr, "dropout", tdrop)
        mp.setattr(pdu, "point_dropout", lambda pm, rate, gen: pm & torch.from_numpy(point_keep))
        lw = {s: torch.ones(cfg.model.n_classes) for s in (1, 2, 4)}
        net.train()
        with torch.no_grad():
            ttrain = net(tin, lw, torch.Generator().manual_seed(0))
        net.eval()
        with torch.no_grad():
            tmc = net(tin, generator=torch.Generator().manual_seed(0), mc_dropout=True)
    return dict(train=(jtrain, ttrain), mc=(jmc, tmc), seen=seen, drawn=drawn)


def test_every_dropout_site_pinned(both):
    """Both packages drew at the same sites in the same order: 7 spatial
    dropouts and 4 transformer dropouts per level, in each of the two
    forwards."""
    assert both["seen"] == both["drawn"]
    names = set(both["seen"])
    assert {"enc_drop_s2", "enc_drop_s4", "enc_drop_s8", "dense3d_drop", "dec_s4/drop",
            "dec_s2/drop", "dec_s1/drop"} <= names
    assert sum(n.startswith("transformer/") for n in names) >= 4


@pytest.mark.parametrize("mode", ["train", "mc"])
def test_dropout_forward_matches_reference(both, mode):
    jout, tout = both[mode]
    for which in ("sem_grids", "panop_grids"):
        for scale in (1, 2, 4):
            jg, tg = getattr(jout, which)[scale], getattr(tout, which)[scale]
            np.testing.assert_array_equal(tg.mask.numpy(), np.asarray(jg.mask))
            np.testing.assert_array_equal(tg.coords.numpy(), np.asarray(jg.coords))
            assert tg.mask.sum() > 0
    for scale in (1, 2, 4):
        np.testing.assert_allclose(tout.sem_logits[scale].numpy(),
                                   np.asarray(jout.sem_logits[scale]), rtol=2e-2, atol=1e-2)
    p_t, p_j = tout.predictor, jout.predictor
    np.testing.assert_allclose(p_t.query_logits.numpy(), np.asarray(p_j.query_logits),
                               rtol=2e-2, atol=1e-2)
    np.testing.assert_allclose(p_t.voxel_logits.numpy(), np.asarray(p_j.voxel_logits),
                               rtol=2e-2, atol=1e-2)


def _port_net(cfg):
    net = build_net(cfg, device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(0))
    flat = perturbed(torch_to_flax(net.state_dict()), seed=1)
    net.load_state_dict(flax_to_torch(flat), strict=True)
    inp = ModelInput(*(torch.from_numpy(np.array(a))
                       for a in make_input(cfg, rng=0, n_pts=1500)))
    return net, inp


def _flat(out):
    return torch.cat([out.predictor.query_logits.reshape(-1),
                      out.predictor.voxel_logits.reshape(-1),
                      *(v.reshape(-1) for v in out.sem_logits.values())])


def test_eval_deterministic_and_mc_samples_vary():
    """``eval_step`` twice gives the same outputs; ``mc_eval_step`` samples
    differ between generators, repeat with one, and leave the net's state
    as it was."""
    net, inp = _port_net(dropout_config())
    before = {k: v.clone() for k, v in net.state_dict().items()}
    e1, e2 = _flat(eval_step(net, inp)), _flat(eval_step(net, inp))
    m = [_flat(mc_eval_step(net, inp, torch.Generator().manual_seed(s))) for s in (1, 2, 1)]
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())
    assert torch.equal(e1, e2)
    assert not torch.equal(m[0], m[1]) and not torch.equal(m[0], e1)
    assert torch.equal(m[0], m[2])
    assert torch.isfinite(m[0]).all() and torch.isfinite(m[1]).all()


def test_zero_rates_add_nothing():
    """At zero rates (the released recipe) no dropout module exists, the
    parameter and buffer names are those of a net with every rate set
    (dropout adds none), and the MC forward is the eval forward."""
    cfg = tiny_f32_config()
    net, inp = _port_net(cfg)
    assert not any(isinstance(m, pdu.SpatialDropout) for m in net.modules())
    dropped = build_net(dropout_config(), device="cpu")
    assert sum(isinstance(m, pdu.SpatialDropout) for m in dropped.modules()) == 7
    assert list(net.state_dict()) == list(dropped.state_dict())
    with torch.no_grad():
        e = _flat(net(inp))
        m = _flat(net(inp, generator=torch.Generator().manual_seed(1), mc_dropout=True))
    assert torch.equal(e, m)


def test_draws_outside_remat_regions():
    """A training forward and backward with every dropout live gives the
    same loss and gradients with ``remat`` on and off: the recomputed
    regions draw nothing from the explicit generator."""
    cfg = dropout_config()
    grads = []
    for remat in (False, True):
        c = cfg.replace(model=dataclasses.replace(cfg.model, remat=remat))
        net, inp = _port_net(c)
        net.train()
        lw = {s: torch.ones(cfg.model.n_classes) for s in (1, 2, 4)}
        out = net(inp, lw, torch.Generator().manual_seed(3))
        loss = _flat(out).square().mean()
        loss.backward()
        grads.append((loss.detach(), {k: p.grad for k, p in net.named_parameters()
                                      if p.grad is not None}))
    (l0, g0), (l1, g1) = grads
    assert torch.equal(l0, l1)
    assert set(g0) == set(g1) and len(g0) > 100
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-7)
