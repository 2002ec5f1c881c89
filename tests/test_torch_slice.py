"""The port's whole inference forward against the reference's
``DensePaSCoNet`` on shared weights, at ``tiny_config(n_infers=1)`` in f32
on the CPU (one JAX compile).

Required: identical extraction coords (same sets, same order) at every
scale of ``sem_grids`` and ``panop_grids``; semantic and query logits
within ``rtol=2e-2, atol=1e-2`` (the sem logits are bf16-rounded in both
models, ``tests/test_dense_mode.py:354-362`` is the precedent).
"""

import jax
import numpy as np
import pytest
import torch
from test_model_forward import make_input
from test_torch_convert import init_reference, nest, perturbed, flatten, tiny_f32_config

from pasco_torch.convert import flax_to_torch
from pasco_torch.models.unet import ModelInput, build_net

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both_outputs():
    cfg = tiny_f32_config()
    inp = make_input(cfg, rng=0)
    jnet, lw, variables = init_reference(cfg, inp)
    flat = perturbed(flatten(variables), seed=1)
    jout = jax.jit(lambda v, i: jnet.apply(v, i, lw, train=False))(nest(flat), inp)
    net = build_net(cfg, device="cpu")
    net.load_state_dict(flax_to_torch(flat), strict=True)
    tin = ModelInput(*(torch.from_numpy(np.array(a)) for a in inp))
    with torch.no_grad():
        tout = net(tin)
    return cfg, jout, tout


@pytest.mark.parametrize("which", ["sem_grids", "panop_grids"])
def test_extraction_coords_identical(both_outputs, which):
    _, jout, tout = both_outputs
    for scale in (1, 2, 4):
        jg, tg = getattr(jout, which)[scale], getattr(tout, which)[scale]
        np.testing.assert_array_equal(tg.mask.numpy(), np.asarray(jg.mask))
        np.testing.assert_array_equal(tg.coords.numpy(), np.asarray(jg.coords))
        assert tg.mask.sum() > 0


def test_refined_features_match(both_outputs):
    _, jout, tout = both_outputs
    for scale in (1, 2, 4):
        np.testing.assert_allclose(
            tout.panop_grids[scale].feats.numpy(),
            np.asarray(jout.panop_grids[scale].feats), rtol=2e-2, atol=1e-2)


def test_logits_match(both_outputs):
    cfg, jout, tout = both_outputs
    for scale in (1, 2, 4):
        np.testing.assert_allclose(
            tout.sem_logits[scale].numpy(), np.asarray(jout.sem_logits[scale]),
            rtol=2e-2, atol=1e-2)
    p_t, p_j = tout.predictor, jout.predictor
    np.testing.assert_allclose(p_t.query_logits.numpy(),
                               np.asarray(p_j.query_logits), rtol=2e-2, atol=1e-2)
    np.testing.assert_allclose(p_t.voxel_logits.numpy(),
                               np.asarray(p_j.voxel_logits), rtol=2e-2, atol=1e-2)
    for (ct, mt), (cj, mj) in zip(p_t.aux, p_j.aux):
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=2e-2, atol=1e-2)
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=2e-2, atol=1e-2)


def test_output_shapes(both_outputs):
    cfg, _, tout = both_outputs
    cap, m = cfg.capacity, cfg.model
    Q = m.transformer.num_queries
    assert tout.sem_logits[1].shape == (cap.dec_s1, 1, m.n_classes)
    assert tout.sem_grids[1].feats.shape == (cap.dec_s1, m.f)
    assert tout.sem_logits_pruned.shape == (1, cap.panop_s1, m.n_classes)
    assert tout.predictor.query_logits.shape == (1, Q, m.n_classes + 1)
    assert tout.predictor.voxel_logits.shape == (1, cap.panop_s1, Q)


def test_unported_modes_raise():
    """MC dropout is ported: ``mc_dropout=True`` runs in both modes, with
    finite outputs of the inference shapes; at the released recipe's zero
    spatial and transformer rates (no point dropout at ``tiny_config``) it
    is the eval forward.  (Before the port had it, this test required a
    raise.)"""
    cfg = tiny_f32_config()
    net = build_net(cfg, device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(0))
    inp = ModelInput(*(torch.from_numpy(np.array(a)) for a in make_input(cfg, rng=1)))
    with torch.no_grad():
        plain = net(inp).predictor.query_logits
        for mode in (net.eval, net.train):
            mode()
            out = net(inp, generator=torch.Generator().manual_seed(1), mc_dropout=True)
            q = out.predictor.query_logits
            assert q.shape == plain.shape and torch.isfinite(q).all()
    net.eval()
    with torch.no_grad():
        assert torch.equal(net(inp, mc_dropout=True).predictor.query_logits, plain)


def test_scene_inference_on_synthetic_scan():
    """The port's run_scene_inference end to end on a synthetic scan:
    forward, ensembling and panoptic assembly produce S + 1 outputs."""
    from pasco_tpu.data.semantic_kitti.collate import collate
    from pasco_tpu.data.semantic_kitti.dataset import process_scene
    from pasco_tpu.data.synthetic import make_scene
    from pasco_torch.inference.pipeline import run_scene_inference
    from pasco_torch.models.unet import scene_to_model_input

    cfg = tiny_f32_config()
    rng = np.random.RandomState(0)
    scene = make_scene(rng, scene_size=cfg.scene.scene_size, n_points=1500,
                       point_feat_dim=cfg.model.in_channels - 6)
    col = collate([process_scene(scene, None, rng)], cfg, rng=rng)
    net = build_net(cfg, device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(0))
    res = run_scene_inference(net, scene_to_model_input(col, "cpu"), col, cfg)
    assert len(res["outputs"]) == 2
    for o in res["outputs"]:
        assert o["panoptic_seg_dense"].shape == tuple(cfg.scene.scene_size)
        assert o["sem_prob_dense"].shape[0] == cfg.model.n_classes
    assert res["inference_time"] > 0
