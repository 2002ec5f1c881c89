"""The KITTI-360 preset at ``n_infers = 2`` (the SSCBench-KITTI360
ensemble) on the CPU.

* The port's whole inference forward against the reference's
  ``DensePaSCoNet`` on shared weights at ``kitti360_config``'s head and
  input widths (19 classes, 8 raw input channels, things 1..6) on
  ``tiny_config``'s trunk, S = 2, in f32 (one JAX compile): identical
  extraction coords at every scale of ``sem_grids`` and of both subnets'
  ``panop_grids``, refined features and logits within ``rtol=2e-2,
  atol=1e-2`` (``tests/test_torch_mimo.py``'s bounds), 19 + 1 query
  classes.
* The featurizer's ``enc_in`` lane blocks at S = 2: subnet ``s``'s points
  land in block ``s`` of their cell, every empty (cell, subnet) block zero.
* ``run_scene_inference`` + ``Evaluator`` on a 2-view scan: 3 outputs,
  scored as the reference's ``Evaluator`` scores them.
* ``train()`` at S = 2 takes no sem-only epoch (the reference's
  ``{4: 2, 3: 1}.get(n_infers, 0)``), and its panoptic step is finite.
* The CLIs: ``scripts_torch/train_kitti360.py`` builds the reference CLI's
  config, datasets and ``train`` arguments from the same flags; both CLIs
  run end to end with ``--device cpu`` on a fake SSCBench layout
  (``tests/test_torch_host.py:write_kitti360_layout``) with the preset
  shrunk to the tiny trunk (the flagship widths do not fit a CPU test).
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_model_forward import make_input
from test_torch_convert import flatten, init_reference, nest, perturbed
from test_torch_host import assert_same, write_kitti360_layout

from pasco_tpu.core.config import tiny_config
from pasco_torch.convert import flax_to_torch
from pasco_torch.models.unet import ModelInput, build_net

torch.set_num_threads(1)
S = 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kitti360_tiny(dtype="float32", scene_size=None):
    """``kitti360_config(n_infers=2)``'s classes, input channels and things
    on ``tiny_config``'s trunk."""
    cfg = tiny_config(n_infers=S, n_classes=19)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, in_channels=8, compute_dtype=dtype),
                      thing_ids=(1, 2, 3, 4, 5, 6))
    if scene_size is not None:
        cfg = cfg.replace(scene=dataclasses.replace(cfg.scene, scene_size=scene_size))
    return cfg


def two_view_input(cfg):
    """``make_input`` with one bounding box per subnet inside the scene."""
    inp = make_input(cfg, rng=2, n_pts=900)
    gmax = np.asarray(inp.global_max)
    lo = np.array([[0, 0, 0], [3, 2, 1]], np.int32)
    hi = np.stack([gmax, gmax - [0, 6, 1]]).astype(np.int32)
    return inp._replace(subnet_min=jnp.asarray(lo), subnet_max=jnp.asarray(hi))


@pytest.fixture(scope="module")
def both_outputs():
    cfg = kitti360_tiny()
    inp = two_view_input(cfg)
    jnet, lw, variables = init_reference(cfg, inp)
    flat = perturbed(flatten(variables), seed=3)
    jout = jax.jit(lambda v, i: jnet.apply(v, i, lw, train=False))(nest(flat), inp)
    net = build_net(cfg, device="cpu")
    net.load_state_dict(flax_to_torch(flat), strict=True)
    tin = ModelInput(*(torch.from_numpy(np.array(a)) for a in inp))
    with torch.no_grad():
        tout = net(tin)
    return cfg, jout, tout, net, tin


@pytest.mark.parametrize("which", ["sem_grids", "panop_grids"])
def test_s2_extraction_coords_identical(both_outputs, which):
    _, jout, tout, _, _ = both_outputs
    for scale in (1, 2, 4):
        jg, tg = getattr(jout, which)[scale], getattr(tout, which)[scale]
        np.testing.assert_array_equal(tg.mask.numpy(), np.asarray(jg.mask))
        np.testing.assert_array_equal(tg.coords.numpy(), np.asarray(jg.coords))
        if which == "panop_grids":
            assert tg.mask.shape[0] == S and all(tg.mask[s].sum() > 0 for s in range(S))
            assert not torch.equal(tg.coords[0, :, 1:], tg.coords[1, :, 1:])
        else:
            assert tg.mask.sum() > 0


def test_s2_features_and_logits_match(both_outputs):
    _, jout, tout, _, _ = both_outputs
    for scale in (1, 2, 4):
        np.testing.assert_allclose(tout.panop_grids[scale].feats.numpy(),
                                   np.asarray(jout.panop_grids[scale].feats),
                                   rtol=2e-2, atol=1e-2)
        np.testing.assert_allclose(tout.sem_logits[scale].numpy(),
                                   np.asarray(jout.sem_logits[scale]), rtol=2e-2, atol=1e-2)
    p_t, p_j = tout.predictor, jout.predictor
    for a, b in ((p_t.query_logits, p_j.query_logits), (p_t.voxel_logits, p_j.voxel_logits)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-2, atol=1e-2)


def test_s2_output_shapes(both_outputs):
    cfg, _, tout, net, _ = both_outputs
    cap, m = cfg.capacity, cfg.model
    Q = m.transformer.num_queries
    assert tout.predictor.query_logits.shape == (S, Q, 19 + 1)
    assert tout.sem_logits[1].shape == (cap.dec_s1, S, 19)
    assert tout.sem_logits_pruned.shape == (S, cap.panop_s1, 19)
    sd = net.state_dict()
    assert sd["enc_in.kernel"].shape == (1, S * m.f, m.f)
    assert sd["point_mlp.fc1.weight"].shape[1] == 8
    assert sd["voxel_feats_s1.conv1.kernel"].shape[0] == S


def test_s2_featurizer_lane_blocks():
    """``scatter_points`` at S = 2 against a direct count: the max of the
    features of subnet ``s``'s points in a cell sits in lane block ``s``
    of that cell, and a block no point of its subnet reached is zero (also
    in a cell the other subnet occupies)."""
    from pasco_torch.ops.featurizer import scatter_points

    r = np.random.RandomState(0)
    ext, F, n = (6, 5, 4), 3, 200
    rel = np.stack([r.randint(0, e, n) for e in ext], 1)
    sub = r.randint(0, S, n)
    f = r.randn(n, F).astype(np.float32)
    in_box = r.rand(n) < 0.9
    x, occ = scatter_points(torch.from_numpy(f), torch.from_numpy(rel), torch.from_numpy(in_box),
                            torch.from_numpy(sub), S, ext, torch.float32)
    want = np.zeros((ext[0], ext[2], ext[1], S * F), np.float32)
    hit = np.zeros((ext[0], ext[2], ext[1], S), bool)
    for (cx, cy, cz), s, v, ok in zip(rel, sub, f, in_box):
        if not ok:
            continue
        blk = want[cx, cz, cy, s * F:(s + 1) * F]
        want[cx, cz, cy, s * F:(s + 1) * F] = v if not hit[cx, cz, cy, s] else np.maximum(blk, v)
        hit[cx, cz, cy, s] = True
    np.testing.assert_array_equal(occ.numpy(), hit)
    np.testing.assert_array_equal(x.numpy(), want)
    assert (hit[..., 0] != hit[..., 1]).any()       # cells only one subnet occupies


def test_s2_scene_inference_and_evaluator():
    """``run_scene_inference`` at S = 2 on one synthetic scan seen under two
    augmentations: 3 outputs, each scored (19 classes, things 1..6) by the
    port's ``Evaluator`` exactly as the reference's ``Evaluator`` scores
    them, with a finite summary."""
    from chip_smoke import eval_scene
    from pasco_tpu.inference.pipeline import Evaluator as JEvaluator
    from pasco_torch.inference.pipeline import Evaluator, run_scene_inference
    from pasco_torch.models.unet import scene_to_model_input

    cfg = kitti360_tiny()
    col = eval_scene(cfg, np.random.RandomState(0), n_points=1500, max_angle=10.0)
    assert (col.point_coords[col.point_mask, 0] == 1).any()
    net = build_net(cfg, device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(0))
    res = run_scene_inference(net, scene_to_model_input(col, "cpu"), col, cfg)
    assert len(res["outputs"]) == S + 1
    for o in res["outputs"]:
        assert o["sem_prob_dense"].shape[0] == 19
    ev, jev = Evaluator(cfg), JEvaluator(cfg)
    for e in (ev, jev):
        e.add_scene(res, col.semantic_label_origin, col.instance_label_origin)
    summary = ev.summary()
    assert repr(jev.summary()) == repr(summary) and len(summary) == S + 1
    for i, s in enumerate(summary):
        assert all(np.isfinite(v) for v in (s["pq_all"]["pq"], s["ssc"]["iou_ssc_mean"],
                                             s["uncertainty"]["ins_ece"]))
        assert ev.ssc[i].tps.shape == (19,)


def test_s2_trains_without_a_sem_only_epoch(tmp_path):
    """At S = 2 ``train()`` pretrains nothing sem-only (``{4: 2, 3: 1}``
    gives 0, as the reference's ``train``): one epoch, one panoptic step
    with finite loss on a 2-view synthetic scene."""
    from pasco_torch.data.synthetic import SyntheticKittiDataset
    from pasco_torch.training import loop

    assert loop.PRETRAIN_SEM_EPOCHS.get(S, 0) == 0
    cfg = kitti360_tiny("bfloat16")
    ds = SyntheticKittiDataset(n_scenes=2, n_subnets=S, scene_size=cfg.scene.scene_size,
                               n_points=1200, point_feat_dim=cfg.model.in_channels - 6)
    freqs = {s: np.ones(19) for s in (1, 2, 4)}
    state = loop.train(cfg, ds, n_epochs=1, limit_train_batches=1, log_dir=str(tmp_path),
                       class_frequencies=freqs, num_workers=0, device="cpu")
    (rec,) = state.history
    assert rec["is_predict_panop"] and np.isfinite(rec["total_loss"]) and rec["grad_norm"] > 0


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_cli_matches_reference(tmp_path, monkeypatch):
    """The same flags give the reference CLI's config, datasets and
    ``train`` arguments (both ``train`` functions are stand-ins)."""
    import sys

    from pasco_tpu.training import loop as jloop
    from pasco_torch.training import loop

    kw = write_kitti360_layout(str(tmp_path), n_frames=1)
    flags = ["--dataset_root", kw["root"], "--label_root", kw["label_root"],
             "--instance_label_root", kw["instance_label_root"], "--match_file",
             kw["match_file"], "--n_infers", "2", "--max_epochs", "3", "--lr", "2e-4",
             "--mask_weight", "20", "--limit_train_batches", "4", "--log_dir",
             str(tmp_path / "logs")]
    calls = {}

    def stand_in(name):
        def fake(cfg, ds, **k):
            calls[name] = (cfg, ds, k)
        return fake

    monkeypatch.setattr(jloop, "train", stand_in("ref"))
    monkeypatch.setattr(loop, "train", stand_in("port"))
    monkeypatch.setattr(sys, "argv", ["train_kitti360.py"] + flags)
    _module("scripts_tpu/train_kitti360.py", "jax_train_kitti360").main()
    _module("scripts_torch/train_kitti360.py", "train_kitti360").main(flags)
    (rcfg, rds, rk), (pcfg, pds, pk) = calls["ref"], calls["port"]
    assert_same(dataclasses.asdict(rcfg), dataclasses.asdict(pcfg))
    assert pcfg.model.n_classes == 19 and pcfg.thing_ids == (1, 2, 3, 4, 5, 6)
    assert pk.pop("device") == "cuda"
    assert set(pk) == set(rk)
    for k in rk:
        if k == "val_dataset":
            assert rk[k].scans == pk[k].scans and rk[k].split == pk[k].split == "val"
        else:
            assert_same(rk[k], pk[k], k)
    assert rds.scans == pds.scans and len(pds) == 1 and pds.n_subnets == 2


@pytest.fixture
def tiny_preset(monkeypatch):
    """``kitti360_config`` of the port shrunk to the tiny trunk, in the
    canonical (256, 256, 32) scene frame of the on-disk labels."""
    from pasco_torch.core import config

    cfg = kitti360_tiny("bfloat16", scene_size=(256, 256, 32))
    monkeypatch.setattr(config, "kitti360_config", lambda n_infers=1: cfg.replace(
        model=dataclasses.replace(cfg.model, n_infers=n_infers)))
    return cfg


def test_kitti360_clis_on_a_fake_layout(tmp_path, tiny_preset, capsys):
    """``train_kitti360.py`` (one epoch of one scan, validation on one
    scan) then ``eval_kitti360.py`` on its checkpoint directory, both with
    ``--device cpu``: a finite step, a saved checkpoint, and every README
    table printed."""
    from pasco_torch.training import loop

    kw = write_kitti360_layout(str(tmp_path / "data"), n_frames=1)
    paths = ["--dataset_root", kw["root"], "--label_root", kw["label_root"],
             "--instance_label_root", kw["instance_label_root"], "--match_file",
             kw["match_file"], "--n_infers", "2", "--device", "cpu"]
    state = _module("scripts_torch/train_kitti360.py", "train_kitti360").main(
        paths + ["--max_epochs", "1", "--limit_train_batches", "1", "--limit_val_batches",
                 "1", "--log_dir", str(tmp_path / "logs")])
    (rec,) = state.history
    assert np.isfinite(rec["total_loss"]) and rec["is_predict_panop"]
    run = tmp_path / "logs" / "pasco_tpu_kitti360_np2"
    assert (run / "checkpoints" / "ckpt_1.pt").exists()
    assert any("val/pq_dagger_all" in r for r in loop.read_metrics(str(run)))
    capsys.readouterr()
    _module("scripts_torch/eval_kitti360.py", "eval_kitti360").main(
        paths + ["--model_path", str(run / "checkpoints"), "--split", "test"])
    out = capsys.readouterr().out
    for want in ("PQ", "mIoU", "car", "road", "building"):
        assert want in out, want
