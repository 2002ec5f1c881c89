"""The port's WaffleIron trainer (``pasco_torch/training/waffleiron_train.py``)
against the JAX package's (``pasco_tpu/training/waffleiron_train.py``) on
the CPU:

* ``semseg_loss`` (with and without Lovasz), ``fast_hist``, the scores and
  ``warmup_cosine_factor``;
* every transform, ``InstanceCutMix`` (cut and mix) and
  ``build_point_batch``: identical arrays from the same ``RandomState``;
* one train step at B = 2 (depth 4, 32 channels) against
  ``waffleiron_train_step`` from the same variables: loss, hist, the
  updated parameters and the running statistics averaged per scan as
  ``jax.vmap`` gives them, within ``TOL_REL * max|ref| + TOL_ABS``;
  ``embed.nbn1.bias``, whose gradient is zero in exact arithmetic
  (``nbn2``'s batch mean removes its shift), takes Adam's first step on
  rounding noise in both packages, so it is held to one step of the
  learning rate;
* with ``warmup_end >= 1`` update 0 moves no parameter;
* ``waffleiron_eval_step``;
* ``WaffleIronTrainer``: save, load, resume and the ``log.jsonl`` keys; a
  JAX trainer's ``ckpt_last.pkl`` loads into the port's Segmenter.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasco_tpu.models import waffleiron as ref_model
from pasco_tpu.training import waffleiron_train as ref
from pasco_torch.convert import load_waffleiron_state_dict, waffleiron_flax_to_torch
from pasco_torch.models import waffleiron as port_model
from pasco_torch.training import waffleiron_train as port

TOL_REL, TOL_ABS = 1e-4, 1e-5
GRIDS = ((32, 32), (32, 8), (32, 8))
N_CLASSES, C, DEPTH, NUM_POINTS, K = 5, 32, 4, 320, 8


def close(got, want, what, rel=TOL_REL, abs_=TOL_ABS):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + abs_, (what, err, np.abs(want).max())


def cloud(r, n, n_classes=N_CLASSES):
    xyz = r.randn(n, 3).astype(np.float32) * 8
    pc = np.concatenate([xyz, r.rand(n, 2).astype(np.float32)], axis=1)
    lab = (np.floor(xyz[:, 0]) % n_classes).astype(np.int32)
    lab[r.rand(n) < 0.1] = 255
    return pc, lab


def batches(seed=2):
    """The same two clouds (300 and 250 points, padded to 320) as a JAX
    and a port PointBatch."""
    r = np.random.RandomState(seed)
    clouds, labels = zip(*[cloud(r, 300), cloud(r, 250)])
    kw = dict(k_neighbors=K, grids_shape=GRIDS, fov=20.0)
    return (ref.build_point_batch(list(clouds), list(labels), NUM_POINTS, **kw),
            port.build_point_batch(list(clouds), list(labels), NUM_POINTS, **kw, device="cpu"))


def sd_of(params, batch_stats):
    return waffleiron_flax_to_torch(jax.tree_util.tree_map(np.asarray, params),
                                    jax.tree_util.tree_map(np.asarray, batch_stats))


@pytest.fixture(scope="module")
def step_case():
    """A JAX state after ``create_waffle_state`` with random BatchNorm
    statistics, and the port's Segmenter on the same variables."""
    jb, pb = batches()
    net = ref_model.Segmenter(n_classes=N_CLASSES, channels=C, depth=DEPTH, in_channels=5,
                              grids_shape=GRIDS)
    tx = ref.make_waffleiron_optimizer(lr=1e-3, warmup_end=0, max_iter=100)
    state = jax.jit(lambda b: ref.create_waffle_state(net, b, tx, jax.random.PRNGKey(0)))(jb)
    r = np.random.RandomState(7)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: (r.randn(*x.shape) * 0.3 if p[-1].key == "mean"
                      else 0.5 + r.rand(*x.shape)).astype(np.float32), state.batch_stats)
    state = ref.WaffleTrainState(params=state.params, batch_stats=stats,
                                 opt_state=state.opt_state, step=state.step)
    return net, tx, state, jb, pb


def port_net(state):
    net = port_model.Segmenter(n_classes=N_CLASSES, channels=C, depth=DEPTH, in_channels=5,
                               grids_shape=GRIDS)
    net.load_state_dict(sd_of(state.params, state.batch_stats))
    return net


# ---------------------------------------------------------------------------
# Loss, histogram, scores, schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lovasz_weight", [0.0, 1.0, 0.5])
def test_semseg_loss_matches(lovasz_weight):
    r = np.random.RandomState(0)
    logits = (r.randn(200, 19) * 3).astype(np.float32)
    labels = r.randint(0, 19, 200).astype(np.int32)
    labels[r.rand(200) < 0.1] = 255
    valid = r.rand(200) > 0.2
    want = ref.semseg_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid),
                           lovasz_weight)
    got = port.semseg_loss(torch.from_numpy(logits), torch.from_numpy(labels).long(),
                           torch.from_numpy(valid), lovasz_weight)
    close(got, want, "semseg_loss", rel=1e-5, abs_=0.0)


def test_hist_and_scores_match():
    r = np.random.RandomState(1)
    n = 19
    pred = r.randint(0, n, 500)
    lab = r.randint(0, n, 500)
    lab[r.rand(500) < 0.1] = 255
    valid = r.rand(500) > 0.1
    want = np.asarray(ref.fast_hist(jnp.asarray(pred), jnp.asarray(lab), jnp.asarray(valid), n))
    got = port.fast_hist(torch.from_numpy(pred), torch.from_numpy(lab), torch.from_numpy(valid),
                         n).numpy()
    np.testing.assert_array_equal(got, want)
    hist = got.copy()
    hist[3] = 0                          # a class with no points: nan scores
    for fn in ("per_class_iu", "per_class_accuracy"):
        np.testing.assert_array_equal(getattr(port, fn)(hist), getattr(ref, fn)(hist))
    assert port.overall_accuracy(hist) == ref.overall_accuracy(hist)


def test_warmup_cosine_matches():
    for warmup_end, max_iter, fmin in ((100, 1000, 1e-3), (0, 50, 1e-5), (4, 8, 1e-5)):
        jfn = ref.warmup_cosine_factor(warmup_end, max_iter, fmin)
        pfn = port.warmup_cosine_factor(warmup_end, max_iter, fmin)
        for step in range(0, max_iter + 3, max(max_iter // 37, 1)):
            assert abs(pfn(step) - float(jfn(jnp.int32(step)))) <= 1e-6, (warmup_end, step)


# ---------------------------------------------------------------------------
# Host transforms and batches: identical arrays
# ---------------------------------------------------------------------------


def _transforms(mod, rng):
    return [
        mod.Rotation(rng=rng),
        mod.Rotation(dim=0, range=0.5, rng=rng),
        mod.Scale(rng=rng),
        mod.Scale(dims=(0, 1, 2), range=0.1, rng=rng),
        mod.FlipXY(rng=rng),
        mod.LimitNumPoints(max_point=100, rng=rng),
        mod.LimitNumPoints(max_point=100, random=True, rng=rng),
        mod.Crop(fov=((-10, -10, -2), (10, 10, 2))),
        mod.Voxelize(voxel_size=0.5, rng=rng),
        mod.Voxelize(voxel_size=0.5, random=True, rng=rng),
        mod.RandomApply(mod.FlipXY(rng=rng), prob=0.5, rng=rng),
        mod.Compose([mod.Crop(fov=((-20, -20, -8), (20, 20, 8))),
                     mod.Voxelize(voxel_size=0.3, random=True, rng=rng),
                     mod.LimitNumPoints(max_point=150, random=True, rng=rng),
                     mod.RandomApply(mod.Rotation(rng=rng), prob=0.5, rng=rng),
                     mod.RandomApply(mod.Scale(rng=rng), prob=0.5, rng=rng)]),
    ]


def test_transforms_identical():
    pc, lab = cloud(np.random.RandomState(3), 400)
    rngs = np.random.RandomState(11), np.random.RandomState(11)
    for rep in range(3):
        for tr, tp in zip(_transforms(ref, rngs[0]), _transforms(port, rngs[1])):
            a, la = tr(pc, lab)
            b, lb = tp(pc, lab)
            np.testing.assert_array_equal(b, a, err_msg=f"{type(tp).__name__} rep {rep}")
            np.testing.assert_array_equal(lb, la)
    assert rngs[0].rand() == rngs[1].rand()


def _cutmix_scan(r):
    road = np.concatenate([r.uniform(-20, 20, (300, 2)), np.zeros((300, 1)), r.rand(300, 1)],
                          axis=1).astype(np.float32)
    things = [np.concatenate([r.uniform(c, c + 1, (10, 2)), r.uniform(0, 1.8, (10, 1)),
                              r.rand(10, 1)], axis=1).astype(np.float32) for c in range(4)]
    pc = np.concatenate([road, *things])
    labels = np.concatenate([np.full(300, 8, np.int32), np.full(10, 5, np.int32),
                             np.full(10, 1, np.int32), np.full(10, 6, np.int32),
                             np.full(10, 2, np.int32)])
    inst = np.concatenate([np.zeros(300, np.int32), *[np.full(10, 7 + i, np.int32)
                                                     for i in range(4)]])
    return pc, labels, inst


def test_instance_cutmix_identical(tmp_path):
    pc, labels, inst = _cutmix_scan(np.random.RandomState(0))
    mixes = []
    for mod, sub in ((ref, "ref"), (port, "port")):
        cm = mod.InstanceCutMix(rootdir=str(tmp_path / sub), num_to_add=5,
                                rng=np.random.RandomState(0))
        assert cm(pc, labels, inst) == (None, None)
        cm.finalize_bank()
        mixes.append([cm(pc, labels) for _ in range(3)])
        # the bank mirrored to disk loads back
        again = mod.InstanceCutMix(rootdir=str(tmp_path / sub))
        assert again.loaded and all(len(again.bank[c]) == len(cm.bank[c]) for c in cm.bank)
    for (a, la), (b, lb) in zip(*mixes):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(lb, la)
    assert any(len(a) > len(pc) for a, _ in mixes[0])


def test_build_point_batch_identical():
    jb, pb = batches()
    for f in ("feats", "neighbors", "cell_inds", "mask", "labels"):
        np.testing.assert_array_equal(getattr(pb, f).numpy(), np.asarray(getattr(jb, f)), f)
    assert pb.neighbors.dtype == pb.cell_inds.dtype == pb.labels.dtype == torch.int64


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

# gradient zero in exact arithmetic: nbn2's batch mean removes nbn1's shift
STRUCTURALLY_ZERO = ("embed.nbn1.bias",)


def test_train_step_matches_reference(step_case):
    net, tx, state, jb, pb = step_case
    new, logs = jax.jit(lambda s, b: ref.waffleiron_train_step(s, b, net=net, tx=tx))(state, jb)
    pnet = port_net(state)
    ptx = port.make_waffleiron_optimizer(lr=1e-3, warmup_end=0, max_iter=100)
    pstate, plogs = port.waffleiron_train_step(port.create_waffle_state(pnet, ptx), pb,
                                               net=pnet, tx=ptx)
    assert pstate.step == 1 and pstate.opt_state["count"] == 1
    close(plogs["loss"], logs["loss"], "loss", rel=1e-5, abs_=0.0)
    np.testing.assert_array_equal(plogs["hist"].numpy(), np.asarray(logs["hist"]))
    before = sd_of(state.params, state.batch_stats)
    want = sd_of(new.params, new.batch_stats)
    got = pnet.state_dict()
    assert set(want) == set(got)
    for k, w in want.items():
        if k in STRUCTURALLY_ZERO:
            # one Adam step of lr (plus decay) in either direction
            assert (got[k] - before[k]).abs().max() <= 1e-3 * (1 + 3e-3 * before[k].abs().max())
            continue
        close(got[k], w.numpy(), k)
        if k.endswith(("mean", "var")):      # moved by the per-scan statistics
            assert not torch.equal(got[k], before[k]), k
    # the running statistics are the mean over the scans of each scan's update
    one = port_net(state).train()
    one(pb.feats[0], pb.neighbors[0], pb.cell_inds[0], pb.mask[0])
    from pasco_torch.models.norm import commit_batch_stats

    commit_batch_stats(one)
    assert not torch.allclose(one.state_dict()["waffleiron.cmix3.norm.mean"],
                              got["waffleiron.cmix3.norm.mean"], atol=1e-4)


def test_warmup_step_zero_moves_nothing(step_case):
    _, _, state, _, pb = step_case
    pnet = port_net(state)
    tx = port.make_waffleiron_optimizer(lr=1e-3, warmup_end=4, max_iter=100)
    pstate = port.create_waffle_state(pnet, tx)
    params = {k: p.detach().clone() for k, p in pnet.named_parameters()}
    pstate, _ = port.waffleiron_train_step(pstate, pb, net=pnet, tx=tx)
    for k, p in pnet.named_parameters():
        assert torch.equal(p, params[k]), k
    assert pstate.opt_state["count"] == 1
    assert any(v.abs().max() > 0 for v in pstate.opt_state["mu"].values())
    pstate, _ = port.waffleiron_train_step(pstate, pb, net=pnet, tx=tx)
    assert any(not torch.equal(p, params[k]) for k, p in pnet.named_parameters())


def test_eval_step_matches_reference(step_case):
    net, _, state, jb, pb = step_case
    logs = jax.jit(lambda s, b: ref.waffleiron_eval_step(s, b, net=net))(state, jb)
    pnet = port_net(state)
    plogs = port.waffleiron_eval_step(None, pb, net=pnet)
    close(plogs["loss"], logs["loss"], "eval loss", rel=1e-5, abs_=0.0)
    np.testing.assert_array_equal(plogs["hist"].numpy(), np.asarray(logs["hist"]))
    assert not pnet.training


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

LOG_KEYS = {"epoch", "tag", "oAcc", "mAcc", "mIoU", "ious", "loss", "sec"}


def test_trainer_save_load_resume(step_case, tmp_path, capsys):
    _, _, state, _, pb = step_case
    out = str(tmp_path / "run")

    def fresh():
        pnet = port_net(state)
        tx = port.make_waffleiron_optimizer(lr=1e-3, warmup_end=0, max_iter=10)
        return port.WaffleIronTrainer(pnet, tx, port.create_waffle_state(pnet, tx), out)

    tr = fresh()
    tr.train(lambda: [pb], lambda: [pb], 2)
    assert sorted(os.listdir(out)) == ["ckpt_best.pkl", "ckpt_last.pkl", "log.jsonl"]
    logs = [json.loads(line) for line in open(os.path.join(out, "log.jsonl"))]
    assert [(r["epoch"], r["tag"]) for r in logs] == [(0, "train"), (0, "val"),
                                                     (1, "train"), (1, "val")]
    assert all(set(r) == LOG_KEYS for r in logs) and len(logs[0]["ious"]) == N_CLASSES
    assert "epoch 1 [val] loss=" in capsys.readouterr().out
    assert tr.state.step == 2 and len(tr.step_sec) == 2

    back = fresh()
    back.load_state()
    assert back.current_epoch == 2 and back.best_miou == tr.best_miou
    assert back.state.step == 2 and back.state.opt_state["count"] == 2
    for k, v in tr.net.state_dict().items():
        assert torch.equal(back.net.state_dict()[k], v), k
    for k, v in tr.state.opt_state["nu"].items():
        assert torch.equal(back.state.opt_state["nu"][k], v), k
    back.train(lambda: [pb], lambda: [pb], 3)                # resumes at epoch 2
    logs = [json.loads(line) for line in open(os.path.join(out, "log.jsonl"))]
    assert [r["epoch"] for r in logs] == [0, 0, 1, 1, 2, 2]
    assert back.state.step == 3
    # the port's checkpoint carries the Segmenter's weights
    sd = load_waffleiron_state_dict(os.path.join(out, "ckpt_last.pkl"))
    assert all(torch.equal(sd[k], v) for k, v in back.net.state_dict().items())


def test_reference_checkpoint_loads(step_case, tmp_path):
    """A JAX trainer's ``ckpt_last.pkl`` (its train state pickled with numpy
    leaves) loads without JAX classes into the port's Segmenter."""
    net, tx, state, _, _ = step_case
    trainer = ref.WaffleIronTrainer(net, tx, state, str(tmp_path))
    trainer.save_state()
    with open(tmp_path / "ckpt_last.pkl", "rb") as f:
        assert pickle.load(f)["epoch"] == 0
    sd = load_waffleiron_state_dict(str(tmp_path / "ckpt_last.pkl"))
    want = sd_of(state.params, state.batch_stats)
    assert set(sd) == set(want)
    assert all(torch.equal(sd[k], want[k]) for k in want)
    port_net(state).load_state_dict(sd)
