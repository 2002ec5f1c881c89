"""The port's evaluation and bench entry points on the CPU, at the ``tiny``
preset, on the fake val scan of ``tests/test_eval_script.py`` (a blob of
voxels at the centre of the 256x256x32 label volume, raw velodyne points:
8 input features after collation):

* the eval path against the reference's on one released-format checkpoint
  (``synthetic_reference_state_dict``), in f32: each package converts it
  with its own converter and runs the scan through its own scene-adaptive
  forward (one JAX compile, the small box); extraction coords identical,
  logits within ``test_torch_slice.py``'s ``rtol=2e-2, atol=1e-2``;
* ``scripts_torch/eval.py`` ``main()`` through ``--torch_ckpt`` and through
  a ``CheckpointManager`` round trip (``--model_path``): every table prints,
  and the two runs print the same tables (the timing line aside); the
  restored net's forward is identical to the converted net's;
* ``CheckpointManager``: ``restore`` gives ``None`` on an empty directory,
  restores the net, the optimizer state and the step, and keeps the best
  ``max_to_keep`` by ``monitor`` and the latest;
* ``scripts_torch/eval_robo3d.py`` on a corrupted dump;
* ``scripts_torch/bench.py``'s measuring function, both protocols, on two
  tiny scans (control flow only: no card here);
* ``pasco_torch/utils/timing.py``'s recorder and seed helper on the CPU.
"""

import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from test_eval_robo3d import _write_corrupted_dump
from test_eval_script import _write_fake_val_scan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", os.path.join(REPO, "scripts_torch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_sd(cfg, in_channels=8, seed=3):
    from pasco_torch.training.convert_torch import synthetic_reference_state_dict

    m = cfg.model
    return synthetic_reference_state_dict(
        np.random.RandomState(seed), n_infers=m.n_infers, f=m.f, n_classes=m.n_classes,
        in_channels=in_channels, hidden_dim=m.transformer.hidden_dim,
        num_queries=m.transformer.num_queries, dim_feedforward=m.transformer.dim_feedforward)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The fake val scan and a released-format checkpoint of the tiny
    preset at its 8 input features."""
    from pasco_torch.inference.evaluate import eval_config

    base = tmp_path_factory.mktemp("eval")
    root = str(base / "data")
    os.makedirs(root)
    _write_fake_val_scan(root)
    sd = _reference_sd(eval_config("tiny", 1))
    ckpt = str(base / "pasco_single.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}},
               ckpt)
    return base, root, ckpt, sd


def _run_eval(monkeypatch, capsys, *args):
    main = _script("eval").main
    monkeypatch.setattr(sys, "argv", ["eval.py", *args])
    main()
    return capsys.readouterr().out


def _tables(out):
    assert "mIoU" in out and "Prec" in out and "PQ" in out
    assert "ins ECE" in out and "ssc ECE ne" in out
    assert "inference time:" in out and "ensemble time:" in out
    assert "subnet 0" in out and "ensemble" in out and "per-class PQ" in out
    return "\n".join(l for l in out.splitlines() if not l.startswith("inference time:"))


def _leaves(x):
    """Every tensor of a ``ModelOutput`` (tuples, dicts, ``SparseGrid``s)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def test_eval_path_matches_reference(data):
    """Both converters, both dispatchers, both forwards on the fake scan."""
    import jax

    from pasco_tpu.core.config import tiny_config as jtiny
    from pasco_tpu.data.semantic_kitti.params import CLASS_FREQUENCIES
    from pasco_tpu.inference.dispatch import AdaptiveForward as JAdaptive
    from pasco_tpu.training import step as jstep
    from pasco_tpu.training.convert_torch import convert_reference_checkpoint

    from pasco_torch.data.semantic_kitti.collate import collate
    from pasco_torch.data.semantic_kitti.dataset import KittiDataset
    from pasco_torch.inference import evaluate as ev
    from pasco_torch.models.unet import build_net, scene_to_model_input
    from pasco_torch.training.convert_torch import load_reference_into

    _, root, _, sd = data
    cfg = ev.eval_config("tiny", 1)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    ds = KittiDataset(root=root, split="val", n_subnets=1, data_aug=True, seed=42)
    scene = collate(ds[0], cfg)
    cfg = ev.fit_in_channels(cfg, "tiny", scene.point_feats.shape[-1])
    assert cfg.model.in_channels == 8

    net = build_net(cfg, "cpu")
    assert load_reference_into(net, sd) == []
    fwd = ev.adaptive_forward(cfg, net)
    inp = scene_to_model_input(scene, "cpu")
    box = fwd.box_for(inp)
    assert box == (48, 48, 16)
    with torch.no_grad():
        tout = fwd(inp)

    jb = jtiny(n_infers=1)
    jcfg = jb.replace(
        model=dataclasses.replace(jb.model, compute_dtype="float32", in_channels=8),
        scene=dataclasses.replace(jb.scene, scene_size=(256, 256, 32)))
    assert cfg.to_dict() == jcfg.to_dict()
    params, stats, unmatched = convert_reference_checkpoint(sd, 1)
    assert unmatched == []
    jfwd = JAdaptive(jcfg, jstep.labelweights_for(jcfg, CLASS_FREQUENCIES))
    jinp = jstep.scene_to_model_input(scene)
    assert jfwd.box_for(jinp) == box
    jout = jfwd({"params": params, "batch_stats": stats}, jinp)
    jax.block_until_ready(jout)

    for which in ("sem_grids", "panop_grids"):
        for scale in (1, 2, 4):
            g, jg = getattr(tout, which)[scale], getattr(jout, which)[scale]
            np.testing.assert_array_equal(g.mask.numpy(), np.asarray(jg.mask))
            np.testing.assert_array_equal(g.coords.numpy(), np.asarray(jg.coords))
            assert g.mask.sum() > 0
    for scale in (1, 2, 4):
        np.testing.assert_allclose(tout.sem_logits[scale].numpy(),
                                   np.asarray(jout.sem_logits[scale]), rtol=2e-2, atol=1e-2)
    np.testing.assert_allclose(tout.predictor.query_logits.numpy(),
                               np.asarray(jout.predictor.query_logits), rtol=2e-2, atol=1e-2)


def test_eval_cli_torch_ckpt_and_checkpoint_roundtrip(data, monkeypatch, capsys):
    from pasco_torch.data.semantic_kitti.collate import collate
    from pasco_torch.data.semantic_kitti.dataset import KittiDataset
    from pasco_torch.inference import evaluate as ev
    from pasco_torch.models.unet import scene_to_model_input
    from pasco_torch.training import step as tstep
    from pasco_torch.training.checkpoint import CheckpointManager, load_config

    base, root, ckpt, _ = data
    common = ["--dataset_root", root, "--n_infers", "1", "--limit_batches", "1",
              "--config", "tiny", "--device", "cpu"]
    out_ckpt = _tables(_run_eval(monkeypatch, capsys, *common, "--torch_ckpt", ckpt))

    cfg = ev.fit_in_channels(ev.eval_config("tiny", 1), "tiny", 8)
    net = ev.load_net(cfg, "cpu", torch_ckpt=ckpt)
    ckdir = str(base / "ckpt")
    CheckpointManager(ckdir, cfg).save(7, tstep.create_train_state(net, cfg))
    assert load_config(ckdir)["model"]["in_channels"] == 8
    restored = ev.load_net(cfg, "cpu", model_path=ckdir)
    for k, v in net.state_dict().items():
        assert torch.equal(v, restored.state_dict()[k]), k
    scene = collate(KittiDataset(root=root, split="val", seed=42)[0], cfg)
    inp = scene_to_model_input(scene, "cpu")
    with torch.no_grad():
        a, b = net(inp), restored(inp)
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 10
    for x, y in zip(la, lb):
        assert torch.equal(x, y)

    out_dir = _tables(_run_eval(monkeypatch, capsys, *common, "--model_path", ckdir))
    assert out_dir == out_ckpt


def test_eval_cli_empty_checkpoint_dir(data, monkeypatch, capsys):
    """An empty ``--model_path`` leaves the seeded random init, as the
    reference CLI does."""
    base, root, _, _ = data
    _tables(_run_eval(monkeypatch, capsys, "--dataset_root", root, "--model_path",
                      str(base / "empty"), "--limit_batches", "1", "--config", "tiny",
                      "--device", "cpu"))


def test_checkpoint_manager(tmp_path):
    from pasco_torch.core.config import tiny_config
    from pasco_torch.models.unet import build_net
    from pasco_torch.training import step as tstep
    from pasco_torch.training.checkpoint import CheckpointManager

    cfg = tiny_config()

    def state(seed):
        net = build_net(cfg, device="cpu")
        net.reset_parameters(torch.Generator().manual_seed(seed))
        st = tstep.create_train_state(net, cfg)
        g = torch.Generator().manual_seed(seed + 100)
        st.opt.step({k: torch.randn(p.shape, generator=g) for k, p in st.opt.params.items()})
        st.step = 3 + seed
        return st

    mgr = CheckpointManager(str(tmp_path / "ck"), cfg, max_to_keep=2)
    assert mgr.restore(state(0)) is None and mgr.latest_step() is None
    saved = state(1)
    for step, monitor in ((10, 0.5), (20, 0.9), (30, 0.1), (40, 0.2)):
        mgr.save(step, saved, {"monitor": monitor})
    assert mgr.all_steps() == [10, 20, 40]      # the best two, and the latest
    got = mgr.restore(state(2), step=20)
    assert got.step == saved.step == 4 and got.opt.count == saved.opt.count == 1
    for k, v in saved.net.state_dict().items():
        assert torch.equal(v, got.net.state_dict()[k]), k
    for k in saved.opt.mu:
        assert torch.equal(saved.opt.mu[k], got.opt.mu[k])
        assert torch.equal(saved.opt.nu[k], got.opt.nu[k])
    assert mgr.restore(state(2)).step == 4      # latest by default


def test_eval_robo3d_cli(tmp_path, monkeypatch, capsys):
    root, pre = str(tmp_path / "data"), str(tmp_path / "pre")
    os.makedirs(root)
    _write_fake_val_scan(root)
    _write_corrupted_dump(pre, "fog", "light", "08", "000000")
    mod = _script("eval_robo3d")
    monkeypatch.setattr(sys, "argv", [
        "eval_robo3d.py", "--dataset_root", root, "--dataset_preprocess_root", pre,
        "--model_path", str(tmp_path / "ckpt"), "--condition", "fog", "--level", "light",
        "--limit_batches", "1", "--config", "tiny", "--device", "cpu"])
    mod.main()
    out = capsys.readouterr().out
    assert "Robo3D fog / light" in out and "mIoU" in out and "PQ" in out


@pytest.mark.parametrize("per_scan", [False, True])
def test_bench_measure_on_cpu(per_scan):
    from pasco_torch.core.config import tiny_config
    from pasco_torch.inference.dispatch import AdaptiveForward
    from pasco_torch.models.unet import build_net

    bench = _script("bench")
    cfg = tiny_config()
    net = build_net(cfg, device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(0))
    scans = bench.draw_scans(cfg, 2, "cpu")
    assert all(b in AdaptiveForward(net).cands for _, _, b in scans)
    res = bench.measure(AdaptiveForward(net), [s[1] for s in scans], [s[2] for s in scans],
                        per_scan=per_scan, iters=2)
    assert res["scans_per_sec"] > 0 and res["device_ms"] is None
    assert res["boxes"] == [list(s[2]) for s in scans]
    with torch.no_grad():
        total = bench.reduced(net(scans[0][1], box_extent=scans[0][2]))
    assert total.dtype == torch.float32 and torch.isfinite(total)
    line = bench.result_line(res["scans_per_sec"], 3)
    assert '"metric": "inference_scans_per_sec_n3"' in line and '"vs_baseline"' in line


def test_timing_utils():
    """``pasco_torch/utils/timing.py`` on the CPU: the recorder is off by
    default and records nothing then; on, a span and a counter land in
    ``drain()``'s rows and counters, and the next drain starts afresh; the
    seed fixes both generators."""
    from pasco_torch.utils import timing

    with timing.span("dispatch"):
        timing.count("cells", 3)
    assert timing.drain() == {"rows": [], "counters": {}}
    timing.tracing(True)
    try:
        with timing.span("dispatch"):
            with timing.span("encoder"):
                torch.ones(10).sum()
            timing.count("cells", torch.tensor(3), 2)
    finally:
        timing.tracing(False)
    got = timing.drain()
    assert [(r["name"], r["parent"], r["forward"]) for r in got["rows"]] == [
        ("pasco.dispatch", None, 0), ("pasco.encoder", 0, 0)]
    assert got["rows"][0]["host_ms"] >= got["rows"][1]["host_ms"] >= 0
    assert got["counters"] == {0: {"cells": 6}}
    assert timing.drain() == {"rows": [], "counters": {}}
    g1 = timing.set_random_seed(5)
    a = (np.random.rand(), torch.rand(1).item(), torch.rand(1, generator=g1).item())
    g2 = timing.set_random_seed(5)
    assert a == (np.random.rand(), torch.rand(1).item(), torch.rand(1, generator=g2).item())
