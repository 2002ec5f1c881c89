"""The sparse substrate's dropouts against ``pasco_tpu``'s, and the port's
trainer and evaluation path on the sparse net, on the CPU in f32 at
``tests/test_torch_sparse_net.py:sparse_config`` (no cap binds; rows are
compared keyed by coordinate).

* The dropouts with every rate set (the point dropout, the decoder
  stages', the bottleneck's and the transformer's), in training mode and
  under ``mc_dropout``, on keep vectors pinned in both packages (the pins
  of ``tests/test_torch_dropout.py``; one JAX compile): identical kept
  coordinate sets, and the semantic and query logits within the bound of
  ``tests/test_torch_sparse_net.py``.
* The trainer (``train``) end to end, and ``run_scene_inference`` with the
  ``Evaluator`` through ``AdaptiveForward``, port alone.
"""

import dataclasses
import itertools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_model_forward import labelweights, make_input
from test_torch_convert import nest, perturbed
from test_torch_dropout import POINT_KEEP, RATE, keep_of, transformer_names
from test_torch_sparse_net import NET_TOL, assert_close, assert_same_rows, keyed, sparse_config

from pasco_torch.convert import flax_to_torch, torch_to_flax
from pasco_torch.models import blocks as pblocks
from pasco_torch.models import transformer as ptr
from pasco_torch.models import unet as punet
from pasco_torch.models.unet import ModelInput, build_net

torch.set_num_threads(1)


# --------------------------------------------------------------------------
# dropouts on pinned keeps
# --------------------------------------------------------------------------


def dropout_config():
    cfg = sparse_config()
    m = cfg.model
    return cfg.replace(model=dataclasses.replace(
        m, encoder_dropouts=(0.05, 0.0, 0.0, 0.0, 0.0, 0.0),
        decoder_dropouts=(RATE, RATE, RATE, 0.0, 0.0), dense3d_dropout=RATE,
        transformer=dataclasses.replace(m.transformer, dropout=RATE)))


@pytest.fixture(scope="module")
def dropped():
    from pasco_tpu.models import blocks as jblocks
    from pasco_tpu.models import dense_unet as jdu
    from pasco_tpu.models.unet import PaSCoNet as JNet

    cfg = dropout_config()
    inp = make_input(cfg, rng=0, n_pts=1500)
    point_keep = keep_of("point", inp.point_mask.shape, POINT_KEEP)
    net = build_net(cfg, device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(0))
    flat = perturbed(torch_to_flax(net.state_dict()), seed=1)
    net.load_state_dict(flax_to_torch(flat), strict=True)
    seen = []

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name != "__call__" or not isinstance(
                mod, (jblocks.SpatialDropout, fnn.Dropout)):
            return next_fun(*args, **kwargs)
        x = args[0]
        det = kwargs.get("deterministic", args[1] if len(args) > 1 else None)
        if det:
            return x
        name = "/".join(mod.path)
        seen.append(name)
        channel = isinstance(mod, jblocks.SpatialDropout) or mod.broadcast_dims
        keep = jnp.asarray(keep_of(name, (x.shape[-1],) if channel else x.shape))
        return jnp.where(keep, x / (1.0 - mod.rate), 0).astype(x.dtype)

    jnet = JNet(cfg)
    lw = labelweights(cfg)
    key = jax.random.PRNGKey(0)

    def both(v, i):
        with fnn.intercept_methods(interceptor):
            train, _ = jnet.apply(v, i, lw, train=True, mutable=["batch_stats"],
                                  rngs={"dropout": key, "sample": key})
            mc = jnet.apply(v, i, lw, train=False, mc_dropout=True, rngs={"dropout": key})
        return train, mc

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdu, "point_dropout", lambda pm, rate, rng: pm & point_keep)
        jtrain, jmc = jax.jit(both)(nest(flat), inp)

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

    tin = ModelInput(*(torch.from_numpy(np.array(a)) for a in inp))
    tlw = {s: torch.from_numpy(np.array(w)) for s, w in lw.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pblocks.SpatialDropout, "draw", draw)
        mp.setattr(ptr, "dropout", tdrop)
        mp.setattr(punet, "point_dropout",
                   lambda pm, rate, gen: pm & torch.from_numpy(point_keep))
        net.train()
        with torch.no_grad():
            ttrain = net(tin, tlw, torch.Generator().manual_seed(0))
        net.eval()
        with torch.no_grad():
            tmc = net(tin, tlw, torch.Generator().manual_seed(0), mc_dropout=True)
    return dict(train=(jtrain, ttrain), mc=(jmc, tmc), seen=seen, drawn=drawn)


def test_every_dropout_site_pinned(dropped):
    """Both packages drew at the same sites in the same order, in each of
    the two forwards: the decoder stages', the bottleneck's and the
    transformer's."""
    assert dropped["seen"] == dropped["drawn"]
    names = set(dropped["seen"])
    assert {"decoder/block_s4/drop", "decoder/block_s2/drop", "decoder/block_s1/drop",
            "dense_bottleneck/Dropout_0"} <= names
    assert sum(n.startswith("transformer/") for n in names) >= 4


@pytest.mark.parametrize("mode", ["train", "mc"])
def test_dropout_forward_matches_reference(dropped, mode):
    jout, tout = dropped[mode]
    for scale in (4, 2, 1):
        assert_same_rows(tout.sem_grids[scale], jout.sem_grids[scale],
                         (tout.sem_logits[scale], jout.sem_logits[scale]))
        jp, tp = jout.panop_grids[scale], tout.panop_grids[scale]
        tc, _ = keyed(tp.coords[0].numpy(), tp.mask[0].numpy())
        jc, _ = keyed(jp.coords[0], jp.mask[0])
        np.testing.assert_array_equal(tc, jc)
    assert_close(tout.predictor.query_logits.numpy(), jout.predictor.query_logits, NET_TOL)


# --------------------------------------------------------------------------
# the port's trainer and evaluation path on the sparse net
# --------------------------------------------------------------------------


def test_trainer_end_to_end(tmp_path):
    """``train`` on the sparse net: one epoch of four scenes in two
    accumulated steps with validation, then a resumed run of one more
    step in the same directory; finite losses, moved running statistics."""
    from test_torch_trainer import _datasets, _freqs

    from pasco_torch.training import loop

    cfg = sparse_config()
    kw = dict(log_dir=str(tmp_path / "run"), class_frequencies=_freqs(cfg), device="cpu")
    state = loop.train(cfg, _datasets(cfg, 4), _datasets(cfg, 1, split="val", seed=50),
                       n_epochs=1, limit_val_batches=1, accum_steps=2, num_workers=0, **kw)
    assert state.step == 2 and [r["step"] for r in state.history] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) and r["grad_norm"] > 0 for r in state.history)
    assert [r["step"] for r in loop.read_metrics(kw["log_dir"]) if "val/pq_dagger_all" in r] == [2]
    assert not torch.all(state.net.state_dict()["decoder.block_s1.res0.bn1.mean"] == 0)
    more = loop.train(cfg, _datasets(cfg, 4), n_epochs=1, limit_train_batches=1,
                      num_workers=0, **kw)
    assert [r["step"] for r in more.history] == [3]


def test_scene_inference_evaluator_and_adaptive_forward():
    """``run_scene_inference`` and the ``Evaluator`` through
    ``AdaptiveForward`` on a synthetic 3-view scan: S + 1 outputs, each
    scored to finite PQ, SSC and uncertainty figures; the forward at a
    candidate box that covers the scan equals the forward at the full box
    (kept coordinate sets identical)."""
    from chip_smoke import eval_scene

    from pasco_torch.inference.dispatch import AdaptiveForward
    from pasco_torch.inference.pipeline import Evaluator, run_scene_inference
    from pasco_torch.models.unet import scene_to_model_input

    S = 3
    cfg = sparse_config(S)
    net = build_net(cfg, device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(0))
    col = eval_scene(cfg, np.random.RandomState(0), n_points=1500, max_angle=10.0)
    fwd = AdaptiveForward(net)
    inp = scene_to_model_input(col, "cpu")
    assert fwd.box_for(inp) in fwd.cands
    res = run_scene_inference(fwd, inp, col, cfg)
    assert len(res["outputs"]) == S + 1
    for o in res["outputs"]:
        assert o["panoptic_seg_dense"].shape == tuple(cfg.scene.scene_size)
    ev = Evaluator(cfg)
    ev.add_scene(res, col.semantic_label_origin, col.instance_label_origin)
    summary = ev.summary()
    assert len(summary) == S + 1
    for i, s in enumerate(summary):
        vals = [s["pq_all"]["pq"], s["ssc"]["iou_ssc_mean"], s["ssc"]["nonempty_ece"],
                s["uncertainty"]["ins_ece"]]
        assert all(np.isfinite(v) for v in vals), s
        assert ev.ssc[i].completion_tp + ev.ssc[i].completion_fn > 0


def test_data_parallel_copies_equal_the_single_step():
    """``dp_train_step`` on two gloo ranks holding copies of one scene,
    SyncBN on (``build_net(cfg, process_group=)``) and shared draws, takes
    the single-process ``train_step`` bit for bit: parameters, running
    statistics, every log and gradient (the reductions of two identical
    halves add and halve exactly)."""
    import torch_dp_ranks
    from test_torch_parallel import _init, _single_steps, _weights
    from test_torch_train import synthetic_batch

    from pasco_torch.parallel.mesh import spawn_ranks

    cfg = sparse_config()
    col = synthetic_batch(cfg, seed=0, n_points=800)
    lw, cw = _weights(cfg)
    init = _init(cfg).state_dict()
    ranks = [r[0] for r in spawn_ranks(torch_dp_ranks.train_rank, 2, cfg, [[col, col]], init,
                                       lw, cw, True, False)]
    state, logs, grads = _single_steps(cfg, init, [col], lw, cw)
    sd = state.net.state_dict()
    for r in ranks:
        assert r["step"] == state.step == 1
        assert all(torch.equal(r["after"][k], sd[k]) for k in sd)
        assert all(torch.equal(r["logs"][k], logs[k].float()) for k in logs)
        assert all(torch.equal(r["grads"][k], grads[k]) for k in grads if grads[k] is not None)
    assert float(logs["grad_norm"]) > 0


def test_eval_and_mc_eval_steps():
    """``eval_step`` on the sparse net is deterministic; ``mc_eval_step``
    samples (every rate set) differ between generators, repeat with one,
    and leave the net's state as it was."""
    from pasco_torch.training.step import eval_step, mc_eval_step

    cfg = dropout_config()
    net = build_net(cfg, device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(0))
    inp = ModelInput(*(torch.from_numpy(np.array(a)) for a in make_input(cfg, rng=0)))
    before = {k: v.clone() for k, v in net.state_dict().items()}

    def flat(out):
        return torch.cat([out.predictor.query_logits.reshape(-1), out.sem_logits[4].reshape(-1)])

    e1, e2 = flat(eval_step(net, inp)), flat(eval_step(net, inp))
    m = [flat(mc_eval_step(net, inp, torch.Generator().manual_seed(s))) for s in (1, 2, 1)]
    assert torch.equal(e1, e2)
    assert not torch.equal(m[0], m[1]) and torch.equal(m[0], m[2])
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())
