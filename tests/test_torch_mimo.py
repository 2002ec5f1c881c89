"""The MIMO ensemble (``n_infers = 3``): the port's whole inference forward
against the reference's ``DensePaSCoNet`` on shared weights at
``tiny_config(n_infers=3)`` in f32 on the CPU (one JAX compile), and the
port's ``run_scene_inference`` + ``Evaluator`` on a synthetic 3-view scan.

The input's points carry random subnet ids and the three subnets get
different bounding boxes, so the featurizer's per-(cell, subnet) rows,
cells that only some subnets occupy, and the per-subnet keep sets are all
exercised.  Required, as ``tests/test_torch_slice.py``: identical
extraction coords at every scale of ``sem_grids`` and, for every subnet, of
``panop_grids``; refined features and logits within ``rtol=2e-2,
atol=1e-2`` (the sem logits are bf16-rounded in both models).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_model_forward import make_input
from test_torch_convert import flatten, init_reference, nest, perturbed, tiny_f32_config

from pasco_torch.convert import flax_to_torch
from pasco_torch.models.unet import ModelInput, build_net

torch.set_num_threads(1)
S = 3


def mimo_input(cfg):
    """``make_input`` with one bounding box per subnet inside the scene."""
    inp = make_input(cfg, rng=0, n_pts=900)
    gmax = np.asarray(inp.global_max)
    lo = np.array([[0, 0, 0], [4, 0, 1], [0, 6, 0]], np.int32)
    hi = np.stack([gmax, gmax - [0, 5, 0], gmax - [7, 0, 2]]).astype(np.int32)
    return inp._replace(subnet_min=jnp.asarray(lo), subnet_max=jnp.asarray(hi))


@pytest.fixture(scope="module")
def both_outputs():
    cfg = tiny_f32_config(S)
    inp = mimo_input(cfg)
    jnet, lw, variables = init_reference(cfg, inp)
    flat = perturbed(flatten(variables), seed=1)
    jout = jax.jit(lambda v, i: jnet.apply(v, i, lw, train=False))(nest(flat), inp)
    net = build_net(cfg)
    net.load_state_dict(flax_to_torch(flat), strict=True)
    tin = ModelInput(*(torch.from_numpy(np.array(a)) for a in inp))
    with torch.no_grad():
        tout = net(tin)
    return cfg, jout, tout, net, tin


def test_mimo_flax_tree_keeps_subnet_axes(both_outputs):
    """The S=3 flax tree loaded strictly (the fixture) with its S-wide
    shapes: vmapped refiner params and stats, heads, queries, enc_in."""
    cfg, _, _, net, _ = both_outputs
    sd = net.state_dict()
    f, K, Q = cfg.model.f, cfg.model.n_classes, cfg.model.transformer.num_queries
    assert sd["enc_in.kernel"].shape == (1, S * f, f)
    assert sd["voxel_feats_s1.conv1.kernel"].shape == (S, 27, f, f)
    assert sd["voxel_feats_s2.conv2.bias"].shape == (S, 2 * f)
    assert sd["voxel_feats_s4.bn.mean"].shape == (S, 4 * f)
    assert sd["dec_s1.head_kernel"].shape == (S, f, K)
    assert sd["dec_s4.head_bias"].shape == (S, K)
    assert sd["transformer.query_feat"].shape == (S, Q, cfg.model.transformer.hidden_dim)


@pytest.mark.parametrize("which", ["sem_grids", "panop_grids"])
def test_mimo_extraction_coords_identical(both_outputs, which):
    _, jout, tout, _, _ = both_outputs
    for scale in (1, 2, 4):
        jg, tg = getattr(jout, which)[scale], getattr(tout, which)[scale]
        np.testing.assert_array_equal(tg.mask.numpy(), np.asarray(jg.mask))
        np.testing.assert_array_equal(tg.coords.numpy(), np.asarray(jg.coords))
        if which == "panop_grids":
            assert tg.mask.shape[0] == S
            assert all(tg.mask[s].sum() > 0 for s in range(S)), scale
            # the subnets' keep sets differ (their boxes do)
            assert not torch.equal(tg.coords[0, :, 1:], tg.coords[1, :, 1:])
            assert not torch.equal(tg.coords[0, :, 1:], tg.coords[2, :, 1:])
        else:
            assert tg.mask.sum() > 0


def test_mimo_refined_features_match(both_outputs):
    _, jout, tout, _, _ = both_outputs
    for scale in (1, 2, 4):
        np.testing.assert_allclose(
            tout.panop_grids[scale].feats.numpy(),
            np.asarray(jout.panop_grids[scale].feats), rtol=2e-2, atol=1e-2)


def test_mimo_logits_match(both_outputs):
    _, jout, tout, _, _ = both_outputs
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


def test_mimo_output_shapes(both_outputs):
    cfg, _, tout, _, _ = both_outputs
    cap, m = cfg.capacity, cfg.model
    Q = m.transformer.num_queries
    assert tout.sem_logits[1].shape == (cap.dec_s1, S, m.n_classes)
    assert tout.sem_logits_pruned.shape == (S, cap.panop_s1, m.n_classes)
    assert tout.predictor.query_logits.shape == (S, Q, m.n_classes + 1)
    assert tout.predictor.voxel_logits.shape == (S, cap.panop_s1, Q)
    assert tout.panop_grids[1].coords.shape == (S, cap.panop_s1, 4)


def test_mimo_sem_only_forward(both_outputs):
    """``is_predict_panop=False`` skips the refiners and the transformer;
    the completion outputs are those of the full forward."""
    _, _, tout, net, tin = both_outputs
    with torch.no_grad():
        sem = net(tin, is_predict_panop=False)
    assert sem.predictor is None and sem.panop_grids == {}
    assert not sem.sem_logits_pruned.any()
    for scale in (1, 2, 4):
        assert torch.equal(sem.sem_grids[scale].coords, tout.sem_grids[scale].coords)
        assert torch.equal(sem.sem_logits[scale], tout.sem_logits[scale])


def test_mimo_scene_inference_and_evaluator():
    """``run_scene_inference`` at S=3 on one synthetic scan seen under three
    augmentations gives S + 1 outputs, and the ``Evaluator`` gives a finite
    PQ, SSC and uncertainty summary for each, the reference ``Evaluator``'s
    on the same outputs."""
    from chip_smoke import eval_scene
    from pasco_torch.inference.pipeline import Evaluator, run_scene_inference
    from pasco_torch.models.unet import scene_to_model_input

    cfg = tiny_f32_config(S)
    col = eval_scene(cfg, np.random.RandomState(0), n_points=1500, max_angle=10.0)
    assert (col.point_coords[col.point_mask, 0] == 2).any()
    net = build_net(cfg)
    net.reset_parameters(torch.Generator().manual_seed(0))
    res = run_scene_inference(net, scene_to_model_input(col, "cpu"), col, cfg)
    assert len(res["outputs"]) == S + 1
    for o in res["outputs"]:
        assert o["panoptic_seg_dense"].shape == tuple(cfg.scene.scene_size)
        assert o["sem_prob_dense"].shape[0] == cfg.model.n_classes
    ev = Evaluator(cfg)
    ev.add_scene(res, col.semantic_label_origin, col.instance_label_origin)
    summary = ev.summary()
    assert len(summary) == S + 1
    # the reference's Evaluator scores the same outputs identically
    from pasco_tpu.inference.pipeline import Evaluator as JEvaluator

    jev = JEvaluator(cfg)
    jev.add_scene(res, col.semantic_label_origin, col.instance_label_origin)
    assert repr(jev.summary()) == repr(summary)
    for i, s in enumerate(summary):
        vals = [s["pq_all"]["pq"], s["ssc"]["iou_ssc_mean"], s["ssc"]["nonempty_ece"],
                s["uncertainty"]["ins_ece"]]
        assert all(np.isfinite(v) for v in vals), s
        # every output was scored against the scene's labels (the values
        # mean nothing at random init)
        ssc = ev.ssc[i]
        assert ssc.ece_count == 1
        assert ssc.completion_tp + ssc.completion_fn > 0
