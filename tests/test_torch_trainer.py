"""The port's trainer (``pasco_torch/training/loop.py``, ``step.py``) and its
CLIs against the reference's on the CPU.

* The loaders (``pasco_torch/data/loader.py``): ``scene_iterator`` and
  ``parallel_scene_iterator`` yield the
  same collated scenes as the reference's at ``num_workers`` 0 and 2
  (identical arrays: the host code is the same NumPy).
Gradient accumulation against the reference is in
``tests/test_torch_accum.py``, validation in ``tests/test_torch_validate.py``.

* ``train`` with ``accum_steps=1`` is bit-identical to one ``train_step``
  per scene in the epoch's order.
* ``train`` end to end with validation, checkpoints and auto-resume (the
  counterpart of ``tests/test_training_loop.py``), with worker processes
  and accumulation; the restored state equals the saved one bit for bit,
  and the step goes on.
* The sem-only pretraining epoch at ``n_infers=3``.
* ``torch_to_flax`` and ``flax_to_torch`` invert each other.
* The CLIs: ``scripts_torch/train.py`` builds the reference CLI's config,
  datasets, ``train`` arguments and experiment name from the same flags;
  ``make_bench_ckpt.py`` writes an npz that loads with ``strict=True``;
  ``bench_train_step.py`` exits 1 without a card.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from test_torch_convert import perturbed

from pasco_tpu.core.config import tiny_config
from pasco_torch.convert import flax_to_torch, torch_to_flax
from pasco_torch.data import loader
from pasco_torch.data.synthetic import SyntheticKittiDataset
from pasco_torch.models.unet import build_net, scene_to_model_input
from pasco_torch.training import loop
from pasco_torch.training import step as tstep

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _datasets(cfg, n, cls=SyntheticKittiDataset, **kw):
    return cls(n_scenes=n, n_subnets=cfg.model.n_infers, scene_size=cfg.scene.scene_size,
               n_points=1200, point_feat_dim=cfg.model.in_channels - 6, **kw)


def _assert_same_scene(a, b):
    assert type(a).__name__ == type(b).__name__
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _assert_same_scene(x, y)
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loaders_match_reference(num_workers):
    from pasco_tpu.data.synthetic import SyntheticKittiDataset as JDataset
    from pasco_tpu.training import loop as jloop

    cfg = tiny_config(n_infers=2)
    order = [2, 0, 1]
    ref = list(jloop.parallel_scene_iterator(
        _datasets(cfg, 3, JDataset, data_aug=True), cfg, order, num_workers=num_workers,
        seed=7))
    got = list(loader.parallel_scene_iterator(
        _datasets(cfg, 3, data_aug=True), cfg, order, num_workers=num_workers, seed=7))
    assert len(ref) == len(got) == 3
    for a, b in zip(got, ref):
        _assert_same_scene(a, b)
    if num_workers == 0:
        seq = list(loader.scene_iterator(_datasets(cfg, 3, data_aug=True), cfg, order,
                                       rng=np.random.RandomState(7)))
        for a, b in zip(seq, ref):
            _assert_same_scene(a, b)


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------


def _freqs(cfg):
    return {s: np.ones(cfg.model.n_classes) for s in (1, 2, 4)}


def test_accum1_bit_identical_to_train_step(tmp_path):
    """``train(accum_steps=1)``: each scene is one ``train_step`` with the
    generator of ``(seed, step)``, in the order ``RandomState(seed)``
    draws after the first scene's collate, on the scenes
    ``scene_iterator`` makes with ``RandomState(seed * 1009)``."""
    cfg = tiny_config(n_infers=1)
    ds = _datasets(cfg, 2)
    state = loop.train(cfg, ds, n_epochs=1, log_dir=str(tmp_path), class_frequencies=_freqs(cfg),
                       seed=3, num_workers=0, device="cpu")
    ref = loop.new_train_state(cfg, "cpu", 3, "reference")
    lw, cw = loop.loss_weights(cfg, _freqs(cfg), torch.device("cpu"))
    rng = np.random.RandomState(3)
    loader.collate(ds[0], cfg, rng=rng)
    order = rng.permutation(2)
    for scene in loader.scene_iterator(ds, cfg, order, rng=np.random.RandomState(3 * 1009)):
        tstep.train_step(ref, scene_to_model_input(scene, "cpu"),
                         tstep.targets_to_device(scene.targets, "cpu"), lw, cw, cfg, 3)
    assert state.step == ref.step == 2
    have, want = state.net.state_dict(), ref.net.state_dict()
    assert all(torch.equal(have[k], want[k]) for k in want)
    assert all(torch.equal(state.opt.mu[k], ref.opt.mu[k]) for k in ref.opt.mu)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_epoch_order_matches_reference(num_workers, tmp_path, monkeypatch):
    """``train``'s epochs visit the scenes the reference's ``train``
    visits, in its order, at ``n_infers=3`` (where the collate subsamples
    and so draws): ``RandomState(seed)`` collates the first scene, then
    draws one permutation per epoch, cut to ``limit_train_batches``; epoch
    ``e``'s loader draws with ``seed * 1009 + e``.  Only the data is held
    here: the reference's loaders are recorded and hand it no scene (its
    state is a stand-in, so nothing compiles), and the port's steps are
    stand-ins that count the step."""
    from pasco_tpu.data.synthetic import SyntheticKittiDataset as JDataset
    from pasco_tpu.training import loop as jloop
    from pasco_tpu.training import step as jstep

    cfg = tiny_config(n_infers=3)
    kw = dict(n_epochs=2, class_frequencies=_freqs(cfg), seed=5, limit_train_batches=2,
              num_workers=num_workers)
    ref, real = [], jloop.parallel_scene_iterator

    def recorded(*a, **k):
        ref.append(list(real(*a, **k)))
        return iter(())

    monkeypatch.setattr(jloop, "parallel_scene_iterator", recorded)
    monkeypatch.setattr(jstep, "create_train_state", lambda *a, **k: (None, None))
    jloop.train(cfg, _datasets(cfg, 3, JDataset, data_aug=True), log_dir=str(tmp_path / "ref"),
                ckpt_every_epochs=3, **kw)

    got, to_input = [], loop.scene_to_model_input

    def apply(state, n_accum=1):
        state.step += 1
        return torch.zeros(())

    monkeypatch.setattr(loop, "scene_to_model_input",
                        lambda scene, dev: got.append(scene) or to_input(scene, dev))
    monkeypatch.setattr(tstep, "grad_step", lambda *a: {"total_loss": torch.zeros(())})
    monkeypatch.setattr(tstep, "apply_grads", apply)
    state = loop.train(cfg, _datasets(cfg, 3, data_aug=True), log_dir=str(tmp_path / "got"),
                       device="cpu", **kw)
    assert state.step == 4 and [len(e) for e in ref] == [2, 2] and len(got) == 4
    for a, b in zip(got, ref[0] + ref[1]):
        _assert_same_scene(a, b)


def test_train_end_to_end_with_resume(tmp_path):
    cfg = tiny_config(n_infers=1)
    log_dir = str(tmp_path / "run")
    kw = dict(log_dir=log_dir, class_frequencies=_freqs(cfg), device="cpu")
    state = loop.train(cfg, _datasets(cfg, 4), _datasets(cfg, 1, split="val", seed=50),
                       n_epochs=1, limit_val_batches=1, accum_steps=2, num_workers=2, **kw)
    assert state.step == 2 and [r["step"] for r in state.history] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) and r["grad_norm"] > 0 for r in state.history)
    metrics = loop.read_metrics(log_dir)
    assert [r["epoch"] for r in metrics if "epoch" in r] == [0]
    assert [r["step"] for r in metrics if "val/pq_dagger_all" in r] == [2]
    assert os.path.exists(os.path.join(log_dir, "checkpoints", "config.json"))
    assert os.path.exists(os.path.join(log_dir, "checkpoints", "ckpt_2.pt"))

    resumed = loop.train(cfg, _datasets(cfg, 4), n_epochs=0, **kw)
    assert resumed.step == 2 and resumed.opt.count == state.opt.count
    have, got = state.net.state_dict(), resumed.net.state_dict()
    assert all(torch.equal(have[k], got[k]) for k in have)
    for name in ("mu", "nu"):
        a, b = getattr(state.opt, name), getattr(resumed.opt, name)
        assert all(torch.equal(a[k], b[k]) for k in a)

    more = loop.train(cfg, _datasets(cfg, 4), n_epochs=1, limit_train_batches=1,
                      num_workers=0, **kw)
    assert [r["step"] for r in more.history] == [3]
    assert os.path.exists(os.path.join(log_dir, "checkpoints", "ckpt_3.pt"))


def test_train_starts_afresh_on_a_truncated_checkpoint(tmp_path, capsys):
    """A checkpoint that fails to restore (here a truncated file) leaves
    the seeded init, as the reference's ``train`` does
    (``pasco_tpu/training/loop.py:215-223``), with one printed line that
    names the error; the run then trains from step 0 and saves."""
    from pasco_torch.training.checkpoint import CheckpointManager

    cfg = tiny_config(n_infers=1)
    log_dir = tmp_path / "run"
    mgr = CheckpointManager(str(log_dir / "checkpoints"), cfg)
    mgr.save(5, loop.new_train_state(cfg, "cpu", seed=9))
    path = log_dir / "checkpoints" / "ckpt_5.pt"
    path.write_bytes(path.read_bytes()[: path.stat().st_size // 2])
    kw = dict(log_dir=str(log_dir), class_frequencies=_freqs(cfg), num_workers=0,
              device="cpu")
    fresh = loop.train(cfg, _datasets(cfg, 2), n_epochs=0, **kw)
    out = capsys.readouterr().out
    assert "could not restore" in out and "starting afresh" in out
    init = loop.new_train_state(cfg, "cpu", seed=0)
    assert fresh.step == 0 and fresh.opt.count == 0
    have, want = fresh.net.state_dict(), init.net.state_dict()
    assert all(torch.equal(have[k], want[k]) for k in want)
    state = loop.train(cfg, _datasets(cfg, 2), n_epochs=1, limit_train_batches=1, **kw)
    assert [r["step"] for r in state.history] == [1]
    assert np.isfinite(state.history[0]["total_loss"])
    assert (log_dir / "checkpoints" / "ckpt_1.pt").exists()


def test_sem_only_epoch_at_n_infers_3(tmp_path):
    """At ``n_infers=3`` the first epoch trains the sem-completion losses
    only (``pretrain_sem_epochs = 1``), the second is panoptic."""
    cfg = tiny_config(n_infers=3)
    state = loop.train(cfg, _datasets(cfg, 2), n_epochs=2, limit_train_batches=1,
                       log_dir=str(tmp_path), class_frequencies=_freqs(cfg), num_workers=0,
                       device="cpu")
    assert [r["is_predict_panop"] for r in state.history] == [False, True]
    assert all(np.isfinite(r["total_loss"]) and r["grad_norm"] > 0 for r in state.history)


def test_torch_to_flax_inverts_flax_to_torch():
    net = build_net(tiny_config(n_infers=3), device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(0))
    sd = net.state_dict()
    flat = perturbed(torch_to_flax(sd), seed=2)
    back = torch_to_flax(flax_to_torch(flat))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    assert {k.split("/")[0] for k in flat} == {"params", "batch_stats"}
    assert flat["params/transformer/cross_0/q_proj/kernel"].shape == (48, 48)
    assert "params/transformer/decoder_norm/scale" in flat
    assert "batch_stats/enc_s2/down/bn1/var" in flat
    net.load_state_dict(flax_to_torch(flat), strict=True)


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Recorder:
    def __init__(self):
        self.datasets, self.train = [], None

    def dataset(self, **kw):
        self.datasets.append(kw)
        return kw

    def run(self, cfg, ds, **kw):
        self.train = (cfg.to_dict(), ds, kw)


@pytest.mark.parametrize("argv", [[], ["--net_3d_dropout", "0.2", "--n_infers", "3",
                                       "--heavy_decoder", "--data_aug", "False",
                                       "--accum_batch", "2", "--max_epochs", "5"]])
def test_train_cli_matches_reference(argv, monkeypatch):
    import pasco_tpu.data.semantic_kitti.dataset as jds
    import pasco_tpu.training.loop as jloop

    import pasco_torch.data.semantic_kitti.dataset as pds

    args = ["--dataset_root", "/data/kitti", *argv]
    ref, got = _Recorder(), _Recorder()
    monkeypatch.setattr(jds, "KittiDataset", ref.dataset)
    monkeypatch.setattr(jloop, "train", lambda cfg, ds, **kw: ref.run(cfg, ds, **kw))
    monkeypatch.setattr(sys, "argv", ["train.py", *args])
    _module("scripts_tpu/train.py", "jax_train_cli").main()
    monkeypatch.setattr(pds, "KittiDataset", got.dataset)
    monkeypatch.setattr(loop, "train", lambda cfg, ds, **kw: got.run(cfg, ds, **kw))
    cli = _module("scripts_torch/train.py", "torch_train_cli")
    cli.main(args)
    assert got.datasets == ref.datasets
    (rcfg, rds, rkw), (gcfg, gds, gkw) = ref.train, got.train
    assert gcfg == rcfg and gds == rds
    assert gkw.pop("device") == "cuda"
    assert gkw == rkw
    ja = _module("scripts_tpu/train.py", "jax_train_cli")
    assert os.path.basename(gkw["log_dir"]) == ja.exp_name(cli.parse_args(args))


def _bench_ckpt_inputs(inp):
    return [np.asarray(a) for a in inp]


def test_make_bench_ckpt_writes_a_strict_npz(tmp_path, monkeypatch):
    """``make_bench_ckpt.py`` takes exactly ``--steps`` steps of
    ``train_step`` on the trainer's state (here a tiny net on the CPU, the
    steps stand-ins that count) and saves its weights as an npz that
    ``flax_to_torch`` loads with ``strict=True``."""
    from pasco_torch.core import config

    cfg = tiny_config(n_infers=1)
    monkeypatch.setattr(config, "PaSCoConfig", lambda: cfg)
    states = []

    def fake_step(state, *a, **k):
        state.step += 1
        return {"total_loss": torch.tensor(1.0)}

    monkeypatch.setattr(loop, "new_train_state", _recorded_new_state(states))
    monkeypatch.setattr(tstep, "train_step", fake_step)
    out = tmp_path / "ckpt.npz"
    _module("scripts_torch/make_bench_ckpt.py", "make_bench_ckpt").main(
        ["--steps", "20", "--out", str(out), "--device", "cpu"])
    (state,) = states
    assert state.step == 20
    data = np.load(out)
    other = build_net(cfg, device="cpu")
    other.load_state_dict(flax_to_torch({k: data[k] for k in data.files}), strict=True)
    assert all(torch.equal(a, b) for a, b in zip(other.state_dict().values(),
                                                 state.net.state_dict().values()))


def _recorded_new_state(states):
    real = loop.new_train_state

    def new_state(cfg_, device, seed):
        st = real(cfg_, device, seed)
        states.append(st)
        return st

    return new_state


def test_make_bench_ckpt_recipe_matches_reference(tmp_path, monkeypatch, capsys):
    """``make_bench_ckpt.py`` trains the reference script's recipe: the
    same pool of 8 collated synthetic crops, cycled in order for exactly
    ``--steps`` steps, the loss printed at the same steps (every
    ``--log_every`` and the last).  Both scripts run at ``tiny_config`` with
    their steps as stand-ins that record each step's input (the reference's
    ``jax.jit`` an identity and its state a stand-in, so nothing compiles);
    the inputs are compared array by array."""
    import jax

    from pasco_tpu.core import config as jconfig
    from pasco_tpu.training import step as jstep
    from pasco_torch.core import config

    cfg = tiny_config(n_infers=1)
    steps, every = 11, 4
    ref, got = [], []

    def ref_step(state, inp, tgt, key, **kw):
        ref.append(_bench_ckpt_inputs(inp))
        return state, {"total_loss": 0.0}

    def port_step(state, inp, tgt, lw, cw, cfg_, seed=0):
        got.append(_bench_ckpt_inputs(inp))
        state.step += 1
        return {"total_loss": torch.tensor(0.0)}

    class Stand:
        params, batch_stats = {}, {}

    monkeypatch.setattr(jconfig, "PaSCoConfig", lambda: cfg)
    monkeypatch.setattr(jstep, "create_train_state", lambda *a, **k: (Stand(), None))
    monkeypatch.setattr(jstep, "train_step", ref_step)
    monkeypatch.setattr(jax, "jit", lambda f, **k: f)
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    monkeypatch.setattr(sys, "argv", ["make_bench_ckpt.py", "--steps", str(steps), "--out",
                                      str(tmp_path / "ref.npz"), "--log_every", str(every)])
    _module("scripts_tpu/make_bench_ckpt.py", "jax_make_bench_ckpt").main()
    ref_out = capsys.readouterr().out

    monkeypatch.setattr(config, "PaSCoConfig", lambda: cfg)
    monkeypatch.setattr(tstep, "train_step", port_step)
    _module("scripts_torch/make_bench_ckpt.py", "make_bench_ckpt").main(
        ["--steps", str(steps), "--out", str(tmp_path / "port.npz"), "--log_every",
         str(every), "--device", "cpu"])
    got_out = capsys.readouterr().out

    assert len(ref) == len(got) == steps
    for a, b in zip(ref, got):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    # the pool is 8 distinct scenes, cycled in order
    assert not np.array_equal(got[0][0], got[1][0])
    np.testing.assert_array_equal(got[8][0], got[0][0])

    def logged(text):
        return [line.split(":")[0] for line in text.splitlines() if line.startswith("step ")]

    assert logged(got_out) == logged(ref_out) == ["step 0", "step 4", "step 8", "step 10"]


def test_bench_train_step_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        _module("scripts_torch/bench_train_step.py", "bench_train_step").main(["--steps", "1"])
    assert e.value.code == 1
