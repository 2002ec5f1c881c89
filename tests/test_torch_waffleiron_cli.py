"""The port's two WaffleIron CLIs on the CPU:

* ``scripts_torch/extract_point_features.py`` against the reference's
  ``scripts_tpu/extract_point_features.py``, both ``main()`` run in process
  on one synthetic sequence (a frame of 1500 points, truncated at
  ``--max_points 1024``, and one of 900, which the reference pads) with
  ``--num_votes 2``, the Segmenter of both modules narrowed (depth 4, 32
  channels) and the port loading the JAX init's weights from an ``.npz``
  through ``--checkpoint``: ``coords`` identical, ``embedding`` and
  ``vote`` within ``TOL_REL * max|ref| + TOL_ABS``;
* the reference's own ``--checkpoint`` cannot load that ``.npz``: the
  dict comes back as a 0-d object array and the forward raises (ROADMAP
  queue 3, "Faults in the reference itself");
* the port's extractor at full width on the fake val scan of
  ``tests/test_eval_script.py``: the port's ``KittiDataset`` and
  ``KittiDatasetRobo3D`` read the pickle as PaSCo's 283 input channels;
* ``scripts_torch/train_waffleiron.py --synthetic`` draws the reference's
  batches (identical arrays, the ``first`` batch included) and trains one
  tiny epoch on the CPU; ``--resume`` starts at the next epoch;
* without a card both CLIs raise.
"""

import importlib.util
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax

import pasco_torch.models.waffleiron as port_model
import pasco_tpu.models.waffleiron as ref_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_REL, TOL_ABS = 1e-4, 1e-5
FRAMES = (1500, 900)
MAX_POINTS = 1024


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _narrow(mod):
    full = mod.Segmenter

    def make(n_classes=19, in_channels=5, **kw):
        kw.setdefault("channels", 32)
        kw.setdefault("depth", 4)
        return full(n_classes=n_classes, in_channels=in_channels, **kw)

    return make


def _write_sequence(root, sizes=FRAMES, seq="08"):
    vel = os.path.join(root, "dataset", "sequences", seq, "velodyne")
    os.makedirs(vel)
    r = np.random.RandomState(5)
    for i, n in enumerate(sizes):
        pts = np.concatenate([r.uniform(-40, 40, (n, 2)), r.uniform(-2.5, 1.5, (n, 1)),
                              r.rand(n, 1)], axis=1).astype(np.float32)
        pts.tofile(os.path.join(vel, f"{i:06d}.bin"))


def _jax_init_npz(path):
    """The variables the reference's extractor makes (``net.init`` at
    PRNGKey(0): they depend on the shapes only), as an ``.npz`` of numpy
    arrays under ``variables``."""
    net = _narrow(ref_model)(n_classes=19, in_channels=5)
    P = MAX_POINTS
    v = jax.jit(lambda: net.init({"params": jax.random.PRNGKey(0)}, np.zeros((P, 5), np.float32),
                                 np.zeros((16, P), np.int32), np.zeros((3, P), np.int32),
                                 np.ones(P, bool)))()
    np.savez(path, variables=jax.tree_util.tree_map(np.asarray, v))


def _pickles(out):
    d = os.path.join(out, "waffleiron_v2", "sequences", "08", "seg_feats_tta")
    res = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            res[f] = pickle.load(fh)
    return res


def _extract(path, argv, monkeypatch):
    mod = _load(path, os.path.basename(path)[:-3])
    monkeypatch.setattr(sys, "argv", [path, *argv])
    mod.main()


def test_extractor_matches_reference(tmp_path, monkeypatch, capsys):
    root = str(tmp_path / "kitti")
    _write_sequence(root)
    npz = str(tmp_path / "wi.npz")
    _jax_init_npz(npz)
    monkeypatch.setattr(ref_model, "Segmenter", _narrow(ref_model))
    monkeypatch.setattr(port_model, "Segmenter", _narrow(port_model))
    common = ["--dataset_root", root, "--sequences", "08", "--num_votes", "2",
              "--max_points", str(MAX_POINTS), "--frame_interval", "1"]
    _extract("scripts_tpu/extract_point_features.py",
             [*common, "--output_root", str(tmp_path / "ref")], monkeypatch)
    _extract("scripts_torch/extract_point_features.py",
             [*common, "--output_root", str(tmp_path / "port"), "--checkpoint", npz,
              "--device", "cpu"], monkeypatch)
    out = capsys.readouterr().out
    assert out.count("08/000000: 1024 points") == 2 and out.count("08/000001: 900 points") == 2
    want, got = _pickles(str(tmp_path / "ref")), _pickles(str(tmp_path / "port"))
    assert sorted(got) == sorted(want) == ["000000.pkl", "000001.pkl"]
    for name, n in zip(sorted(want), (MAX_POINTS, 900)):
        w, g = want[name], got[name]
        assert set(g) == set(w) == {"embedding", "coords", "vote"}
        assert g["embedding"].shape == w["embedding"].shape == (2, 32, n)
        np.testing.assert_array_equal(g["coords"], w["coords"])
        assert g["coords"].dtype == w["coords"].dtype
        for key in ("embedding", "vote"):
            err = np.abs(g[key] - w[key]).max()
            assert err <= TOL_REL * np.abs(w[key]).max() + TOL_ABS, (name, key, err)
        # the two votes differ (vote 1 is a random transformation)
        assert np.abs(g["embedding"][0] - g["embedding"][1]).max() > 1e-3


def test_reference_checkpoint_flag_fails(tmp_path, monkeypatch):
    """The reference's ``--checkpoint``: ``dict(np.load(...)).get
    ("variables")`` is the 0-d object array holding the dict, not the
    variables, and its forward raises; the port unwraps it (above)."""
    root = str(tmp_path / "kitti")
    _write_sequence(root, sizes=(300,))
    npz = str(tmp_path / "wi.npz")
    _jax_init_npz(npz)
    loaded = dict(np.load(npz, allow_pickle=True)).get("variables")
    assert type(loaded) is np.ndarray and loaded.shape == () and loaded.dtype == object
    assert set(loaded.item()) == {"params", "batch_stats"}
    monkeypatch.setattr(ref_model, "Segmenter", _narrow(ref_model))
    with pytest.raises(TypeError):
        _extract("scripts_tpu/extract_point_features.py",
                 ["--dataset_root", root, "--output_root", str(tmp_path / "ref"),
                  "--num_votes", "1", "--max_points", "512", "--checkpoint", npz],
                 monkeypatch)


def test_extracted_pickle_feeds_pasco(tmp_path):
    """Full width: the port's extractor on the fake val scan, then the
    port's datasets read 19 votes + intensity + radius + 256 embedding
    columns, which ``collate`` makes the flagship's 283 input channels."""
    import shutil

    from test_eval_script import _write_fake_val_scan

    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.data.semantic_kitti.collate import collate
    from pasco_torch.data.semantic_kitti.dataset import KittiDataset
    from pasco_torch.data.semantic_kitti.robo3d import KittiDatasetRobo3D

    root, pre = str(tmp_path / "kitti"), str(tmp_path / "pre")
    _write_fake_val_scan(root)
    mod = _load("scripts_torch/extract_point_features.py", "extract_point_features")
    mod.main(["--dataset_root", root, "--output_root", pre, "--num_votes", "2",
              "--frame_interval", "1", "--device", "cpu"])
    src = os.path.join(pre, "waffleiron_v2", "sequences", "08", "seg_feats_tta", "000000.pkl")
    with open(src, "rb") as f:
        d = pickle.load(f)
    assert d["embedding"].shape == (2, 256, 400) and d["vote"].shape == (400, 19)
    np.testing.assert_allclose(d["vote"].sum(1), 1.0, rtol=1e-5)
    robo = os.path.join(pre, "waffleiron_v2", "fog", "light", "seg_feats_tta_robo3d", "08")
    os.makedirs(robo)
    shutil.copy(src, robo)
    cfg = PaSCoConfig()
    assert cfg.model.in_channels == 283
    for ds in (KittiDataset(root=root, preprocess_root=pre, split="val"),
               KittiDatasetRobo3D(root=root, preprocess_root=pre, split="val")):
        scene = ds.load_scene("08", "000000")
        assert scene.point_feats.shape[1] == 19 + 1 + 1 + 256
        assert collate(ds[0], cfg).point_feats.shape[-1] == cfg.model.in_channels


def _train_main():
    return _load("scripts_torch/train_waffleiron.py", "train_waffleiron").main


class _Recorder:
    """Stands in for a trainer: records the batches of one epoch."""

    batches = []
    step_sec = []

    def __init__(self, *a, **kw):
        pass

    def load_state(self):
        pass

    def train(self, train_fn, val_fn, epochs):
        for fn in (train_fn, val_fn):
            type(self).batches += [
                {k: np.asarray(getattr(b, k)) for k in
                 ("feats", "neighbors", "cell_inds", "mask", "labels")} for b in fn()]


def test_train_cli_draws_the_reference_batches(tmp_path, monkeypatch):
    import pasco_torch.training.waffleiron_train as port_train
    import pasco_tpu.training.waffleiron_train as ref_train

    argv = ["--synthetic", "--epochs", "1", "--steps_per_epoch", "2", "--num_points", "3000",
            "--depth", "1", "--channels", "8"]
    drawn = []
    for mod, path, extra in ((ref_train, "scripts_tpu/train_waffleiron.py", []),
                             (port_train, "scripts_torch/train_waffleiron.py",
                              ["--device", "cpu"])):
        _Recorder.batches = []
        monkeypatch.setattr(mod, "WaffleIronTrainer", _Recorder)
        monkeypatch.setattr(mod, "create_waffle_state", lambda *a, **kw: None)
        # the first batch: create_waffle_state's argument in the reference
        firsts = []
        real = mod.build_point_batch
        monkeypatch.setattr(mod, "build_point_batch",
                            lambda *a, **kw: firsts.append(real(*a, **kw)) or firsts[-1])
        _extract(path, [*argv, *extra, "--out", str(tmp_path / path.split("/")[0])],
                 monkeypatch)
        drawn.append((np.asarray(firsts[0].feats), _Recorder.batches))
    (rf, rb), (pf, pb) = drawn
    np.testing.assert_array_equal(pf, rf)
    assert len(rb) == len(pb) == 3
    for a, b in zip(rb, pb):
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_train_cli_one_epoch_and_resume(tmp_path, capsys):
    out = str(tmp_path / "run")
    argv = ["--synthetic", "--steps_per_epoch", "1", "--num_points", "2000", "--depth", "2",
            "--channels", "16", "--device", "cpu", "--out", out]
    trainer = _train_main()([*argv, "--epochs", "1"])
    assert {"ckpt_last.pkl", "log.jsonl"} <= set(os.listdir(out))
    assert trainer.current_epoch == 1 and trainer.state.step == 1
    text = capsys.readouterr().out
    assert "epoch 0 [train] loss=" in text and "1 train steps, median" in text
    trainer = _train_main()([*argv, "--epochs", "2", "--resume"])
    assert "at epoch 1" in capsys.readouterr().out
    assert trainer.current_epoch == 2 and trainer.state.step == 2
    logs = [json.loads(line) for line in open(os.path.join(out, "log.jsonl"))]
    assert [(r["epoch"], r["tag"]) for r in logs] == [(0, "train"), (0, "val"),
                                                     (1, "train"), (1, "val")]
    assert all(np.isfinite(r["loss"]) for r in logs)


def test_clis_raise_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = str(tmp_path / "kitti")
    _write_sequence(root, sizes=(50,))
    mod = _load("scripts_torch/extract_point_features.py", "extract_point_features")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--dataset_root", root, "--output_root", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _train_main()(["--synthetic", "--out", str(tmp_path / "t")])
    assert not os.path.exists(tmp_path / "o") and not os.path.exists(tmp_path / "t")
