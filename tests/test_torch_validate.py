"""The trainer's validation pass (``pasco_torch.training.loop.validate``)
against the reference's (``pasco_tpu.training.loop.validate``) on the CPU,
in f32 at ``tiny_f32_config()``, on the same weights (the port's seeded
init, perturbed, carried across by ``torch_to_flax``, with the query class
and semantic head biases raised toward terrain, class 17, the ground of
every synthetic scene: at random weights the panoptic output overlaps no
label and PQ-dagger is 0 in both) and the same two synthetic validation
scenes: ``run_scene_inference`` at the full box, the
``Evaluator`` on outputs 0 and S without uncertainty, and the ensemble's
PQ-dagger, the checkpoints' monitor.  One JAX compile (the reference's
jitted forward).  Required: a non-zero PQ-dagger, the same within
``1e-2`` of the reference's (relative), and the same ``val/pq_dagger_all``
line in both metric logs.  PQ-dagger is not continuous in the weights: the
two forwards agree to bf16 rounding (``tests/test_torch_slice.py``), and a
voxel whose mask probability or semantic argmax sits at a near-tie lands
on the other side in one of them (measured: 4.3e-4 relative).
"""

import json
from typing import Any, NamedTuple

import numpy as np
import pytest
import torch
from test_torch_convert import nest, perturbed, tiny_f32_config

from pasco_torch.convert import flax_to_torch, torch_to_flax
from pasco_torch.data.synthetic import SyntheticKittiDataset
from pasco_torch.models.unet import build_net
from pasco_torch.training import loop

torch.set_num_threads(1)
TERRAIN = 17


class _State(NamedTuple):
    params: Any
    batch_stats: Any


def _val(cls, cfg):
    return cls(n_scenes=2, n_subnets=1, scene_size=cfg.scene.scene_size, n_points=1500,
               point_feat_dim=cfg.model.in_channels - 6, split="val", seed=50)


@pytest.fixture(scope="module")
def monitors(tmp_path_factory):
    from test_model_forward import labelweights

    from pasco_tpu.data.synthetic import SyntheticKittiDataset as JDataset
    from pasco_tpu.models.unet import build_net as jbuild
    from pasco_tpu.training import loop as jloop

    cfg = tiny_f32_config()
    net = build_net(cfg, device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(0))
    flat = perturbed(torch_to_flax(net.state_dict()), seed=1)
    flat["params/transformer/class_embed/bias"][TERRAIN] += 10.0
    for scale in (1, 2, 4):
        flat[f"params/dec_s{scale}/head_bias"][:, TERRAIN] += 3.0
    net.load_state_dict(flax_to_torch(flat), strict=True)
    v = nest(flat)
    jdir, tdir = tmp_path_factory.mktemp("jax_val"), tmp_path_factory.mktemp("torch_val")
    ref = jloop.validate(cfg, jbuild(cfg), _State(v["params"], v["batch_stats"]),
                         _val(JDataset, cfg), labelweights(cfg), jloop.MetricLogger(str(jdir)),
                         7)
    got = loop.validate(cfg, net, _val(SyntheticKittiDataset, cfg),
                        loop.MetricLogger(str(tdir)), 7)
    logs = [[json.loads(line) for line in open(d / "metrics.jsonl")] for d in (jdir, tdir)]
    return ref, got, logs


def test_validate_pq_dagger_matches_reference(monitors):
    ref, got, _ = monitors
    assert got > 0
    np.testing.assert_allclose(got, ref, rtol=1e-2, atol=0)


def test_validate_logs_the_monitor(monitors):
    _, got, (jlog, tlog) = monitors
    (jrec,), (trec,) = jlog, tlog
    assert trec["step"] == jrec["step"] == 7
    assert trec["val/pq_dagger_all"] == pytest.approx(jrec["val/pq_dagger_all"], rel=1e-2)
    assert trec["val/pq_dagger_all"] == pytest.approx(got)
    assert trec["val/s_per_scene"] > 0
