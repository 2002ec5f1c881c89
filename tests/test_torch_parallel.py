"""The port's data parallelism (``pasco_torch/parallel/mesh.py``) on the
CPU, over gloo ranks spawned by ``spawn_ranks`` (file rendezvous).

* Two ranks on two copies of one scene, with shared draws
  (``fold_axis_rng=False``) and SyncBN on, take exactly the single-device
  ``train_step`` (the counterpart of ``tests/test_multichip.py::
  test_dp_update_matches_single_device``): parameters, running statistics,
  optimizer moments, every log and ``grad_norm`` bit for bit (the
  reductions of two identical halves add and halve exactly).  The same
  step with a BatchNorm reduction whose backward passes only the rank's
  own cotangent (a plain ``dist.all_reduce``) must miss it.
* Two scenes per rank count every scene (the reference keeps the first of
  each device's shard): the mean gradient over four scenes is the one
  ``grad_step`` accumulation gives.
* ``dp_eval_step`` on two ranks against the reference's ``dp_eval_step``
  on a 2-device mesh from the same weights (one JAX compile of the eval
  forward, f32): ``tp`` and ``fp`` identical; ``fn`` is the documented
  count, the ground truth's class count minus ``tp``, which is what
  ``SSCMetrics`` counts for classes 1.. when every cell the extraction
  missed is predicted empty; the reference's ``fn`` counts only the
  extracted cells and is smaller.
* The helpers: ``shard_scenes`` and ``replicate_to_group``.
"""

import functools

import numpy as np
import pytest
import torch
import torch_dp_ranks
from test_torch_convert import flatten, init_reference, nest, perturbed, tiny_f32_config
from test_torch_train import synthetic_batch

from pasco_tpu.core.config import tiny_config
from pasco_torch.convert import flax_to_torch
from pasco_torch.models.unet import build_net, scene_to_model_input
from pasco_torch.parallel.mesh import shard_scenes, spawn_ranks
from pasco_torch.training import step as tstep

torch.set_num_threads(1)
STRUCTURALLY_ZERO = __import__("chip_smoke").STRUCTURALLY_ZERO


def _weights(cfg):
    freqs = {s: np.random.RandomState(s).rand(cfg.model.n_classes) + 0.1 for s in (1, 2, 4)}
    return (tstep.labelweights_for(cfg, freqs),
            tstep.class_weight_vector(cfg.model.n_classes, cfg.loss.no_object_weight))


def _init(cfg, seed=0):
    net = build_net(cfg, device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net


def _single_steps(cfg, init_sd, scenes, lw, cw, micros=None):
    """``grad_step`` on each of ``scenes`` (scene ``i`` drawing from
    ``step_generator(0, micros[i])``) then one ``apply_grads`` on their
    mean, from ``init_sd``: one ``train_step`` for one scene."""
    net = build_net(cfg, device="cpu")
    net.load_state_dict(init_sd)
    state = tstep.create_train_state(net, cfg)
    lw_t = {s: torch.as_tensor(v) for s, v in lw.items()}
    if len(scenes) == 1:
        col = scenes[0]
        logs = tstep.train_step(state, scene_to_model_input(col, "cpu"),
                                tstep.targets_to_device(col.targets, "cpu"), lw_t,
                                torch.as_tensor(cw), cfg)
        return state, logs, {k: p.grad for k, p in net.named_parameters()}
    tstep.zero_grads(state)
    for i, col in enumerate(scenes):
        tstep.grad_step(state, scene_to_model_input(col, "cpu"),
                        tstep.targets_to_device(col.targets, "cpu"), lw_t,
                        torch.as_tensor(cw), cfg,
                        tstep.step_generator(0, i if micros is None else micros[i], "cpu"))
    grads = {k: p.grad / len(scenes) for k, p in net.named_parameters()}
    return state, {"grad_norm": tstep.apply_grads(state, len(scenes))}, grads


@pytest.fixture(scope="module")
def copies():
    """Two ranks on two copies of one scene (SyncBN on, shared draws) with
    the autograd-aware reduction and with the cut one, and the
    single-device step."""
    cfg = tiny_config(n_infers=1)
    col = synthetic_batch(cfg, seed=0)
    lw, cw = _weights(cfg)
    init = _init(cfg).state_dict()
    runs = {cut: spawn_ranks(torch_dp_ranks.train_rank, 2, cfg, [[col, col]], init, lw, cw,
                             True, False, cut) for cut in (False, True)}
    return runs, _single_steps(cfg, init, [col], lw, cw)


def test_dp_copies_equal_the_single_device_step(copies):
    runs, (state, logs, grads) = copies
    ranks = [r[0] for r in runs[False]]
    sd = state.net.state_dict()
    for r in ranks:
        assert r["step"] == state.step == 1
        assert set(r["after"]) == set(sd)
        assert all(torch.equal(r["after"][k], sd[k]) for k in sd)
        assert set(r["logs"]) == set(logs)
        assert all(torch.equal(r["logs"][k], logs[k].float()) for k in logs)
        assert all(torch.equal(r["grads"][k], grads[k]) for k in grads if grads[k] is not None)
    assert float(logs["grad_norm"]) > 0


def test_dp_copies_need_the_statistics_gradient(copies):
    """With the cut reduction the forward is the same but the gradient of
    the batch statistics carries only half of the two ranks' losses: the
    step misses the single-device one by far more than rounding."""
    runs, (_, logs, grads) = copies
    cut = runs[True][0][0]
    assert all(torch.equal(cut["logs"][k], logs[k].float()) for k in logs if k != "grad_norm")
    worst = max(((cut["grads"][k] - g).norm() / g.norm()).item()
                for k, g in grads.items()
                if g is not None and g.norm() > 0 and not STRUCTURALLY_ZERO.search(k))
    assert worst > 1e-2, worst
    assert not torch.equal(cut["logs"]["grad_norm"], logs["grad_norm"].float())


def test_dp_counts_every_scene_of_a_rank():
    """Four scenes over two ranks (two each, no SyncBN): the update is the
    one of accumulating all four (``grad_step`` x 4, ``apply_grads``), not
    of the first scene of each rank."""
    cfg = tiny_config(n_infers=1)
    cols = [synthetic_batch(cfg, seed=s, n_points=800) for s in range(4)]
    lw, cw = _weights(cfg)
    init = _init(cfg).state_dict()
    r0, r1 = (r[0] for r in spawn_ranks(torch_dp_ranks.train_rank, 2, cfg, [cols], init,
                                        lw, cw, False, False))
    # with shared draws, scene i of each rank draws from step_generator(0, i)
    state, logs, grads = _single_steps(cfg, init, cols, lw, cw, micros=[0, 1, 0, 1])
    _, _, first_only = _single_steps(cfg, init, [cols[0], cols[2]], lw, cw, micros=[0, 0])
    for k, g in grads.items():
        torch.testing.assert_close(r0["grads"][k], g, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(r0["logs"]["grad_norm"], logs["grad_norm"], rtol=1e-5, atol=0)
    assert all(torch.equal(r0["after"][k], r1["after"][k]) for k in r0["after"])
    params = dict(state.net.named_parameters())
    for k, p in params.items():
        torch.testing.assert_close(r0["after"][k], p.detach(), rtol=0, atol=1e-6)
    moved = sum(((first_only[k] - g).norm() / g.norm()).item() > 1e-2
                for k, g in grads.items() if g.norm() > 0)
    assert moved > 10


# --------------------------------------------------------------------------
# evaluation
# --------------------------------------------------------------------------


def _eval_scenes(cfg):
    from pasco_tpu.data.semantic_kitti.collate import collate
    from pasco_tpu.data.semantic_kitti.dataset import process_scene
    from pasco_tpu.data.synthetic import make_scene

    rng = np.random.RandomState(1)
    return [collate([process_scene(make_scene(
        rng, scene_size=cfg.scene.scene_size, n_points=900 + 50 * k,
        point_feat_dim=cfg.model.in_channels - 6, n_things=2), None, rng)], cfg,
        max_targets=16) for k in range(2)]


@functools.lru_cache(maxsize=None)
def _reference_eval(cfg):
    """Weights, the scenes and the reference's ``dp_eval_step`` counts on a
    2-device mesh."""
    import jax

    from pasco_tpu.parallel.mesh import (
        dp_eval_step, make_mesh, replicate_to_mesh, shard_batch_to_mesh, stack_scenes)
    from pasco_tpu.training.step import scene_to_model_input as jinput

    scenes = _eval_scenes(cfg)
    net, lw, variables = init_reference(cfg, jinput(scenes[0]))
    flat = perturbed(flatten(variables), seed=1)
    mesh = make_mesh(2)
    inp, tgt = stack_scenes(scenes)
    counts = jax.jit(functools.partial(dp_eval_step, mesh=mesh, net=net, labelweights=lw,
                                       n_classes=cfg.model.n_classes))(
        replicate_to_mesh(nest(flat), mesh), shard_batch_to_mesh(inp, mesh),
        shard_batch_to_mesh(tgt, mesh))
    return flat, scenes, np.stack([np.asarray(c) for c in counts])


def _host_counts(cfg, net, scenes):
    """The counts on the host: each scene's scale-1 prediction of subnet 0
    scattered into the ground truth's frame (every cell the extraction
    missed predicted empty) through ``SSCMetrics``, and the per-class
    ground-truth counts."""
    from pasco_torch.metrics.ssc import SSCMetrics

    C = cfg.model.n_classes
    ssc = SSCMetrics(C)
    tp0 = gt0 = 0
    for col in scenes:
        with torch.no_grad():
            out = net(scene_to_model_input(col, "cpu"))
        gt = col.targets.semantic_dense[0].astype(np.int64)
        g = out.sem_grids[1]
        keep = g.mask.numpy()
        rel = g.coords[:, 1:].numpy()[keep] - col.subnet_min[0]
        pred_cls = out.sem_logits[1][:, 0].argmax(-1).numpy()[keep]
        inside = np.all((rel >= 0) & (rel < gt.shape), 1)
        rel, pred_cls = rel[inside], pred_cls[inside]
        pred = np.zeros_like(gt)
        pred[rel[:, 0], rel[:, 1], rel[:, 2]] = pred_cls
        ssc.add_batch(pred, gt)
        at = gt[rel[:, 0], rel[:, 1], rel[:, 2]]
        tp0 += int(((pred_cls == 0) & (at == 0)).sum())
        gt0 += int((gt == 0).sum())
    return ssc, tp0, gt0


def test_dp_eval_counts():
    cfg = tiny_f32_config(1)
    flat, scenes, ref = _reference_eval(cfg)
    init = flax_to_torch(flat)
    got = spawn_ranks(torch_dp_ranks.eval_rank, 2, cfg, scenes, init)
    assert torch.equal(got[0], got[1])
    tp, fp, fn = got[0].numpy()
    np.testing.assert_array_equal(tp, ref[0])
    np.testing.assert_array_equal(fp, ref[1])
    net = build_net(cfg, device="cpu")
    net.load_state_dict(init)
    ssc, tp0, gt0 = _host_counts(cfg, net, scenes)
    np.testing.assert_array_equal(tp[1:], ssc.tps[1:])
    np.testing.assert_array_equal(fp[1:], ssc.fps[1:])
    np.testing.assert_array_equal(fn[1:], ssc.fns[1:])
    assert tp[0] == tp0 and fn[0] == gt0 - tp0
    # the documented difference: the reference counts fn over extracted
    # cells only, so it misses the ground truth the extraction left out
    assert (ref[2] <= fn).all() and (ref[2] < fn).any()
    assert tp.sum() > 0 and fp.sum() > 0


# --------------------------------------------------------------------------
# the helpers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,world", [(4, 2), (6, 3), (2, 2)])
def test_shard_scenes_contiguous_blocks(n, world):
    scenes = list(range(n))
    shards = [shard_scenes(scenes, r, world) for r in range(world)]
    assert sum(shards, []) == scenes
    assert len({len(s) for s in shards}) == 1


def test_shard_scenes_rejects_an_uneven_split():
    with pytest.raises(ValueError):
        shard_scenes(list(range(5)), 0, 2)


def test_replicate_to_group_broadcasts_rank_0():
    """Rank 1 starts from another init, another step and other optimizer
    moments; after ``replicate_to_group`` every tensor (the bf16 first
    moment included) and both counts are rank 0's."""
    cfg = tiny_config(n_infers=1)
    got = spawn_ranks(torch_dp_ranks.replicate_rank, 2, cfg)
    a, b = got
    assert a["step"] == b["step"] == 7 and a["count"] == b["count"] == 7
    assert set(a["tensors"]) == set(b["tensors"])
    assert all(torch.equal(a["tensors"][k], b["tensors"][k]) for k in a["tensors"])
    assert b["differed"]
