"""The port's copies of the reference's JAX-free host modules
(``pasco_torch/{core/config,data,native,inference/{ensemble,panoptic},
metrics}``) against the originals in ``pasco_tpu/``: the same calls on the
same numpy-seeded inputs give identical arrays (``np.array_equal``, NaN
equal to NaN), identical dicts, lists and scalars.

Each package runs the whole host chain with its own modules: a synthetic
scene (``make_scene``), its views (``generate_random_transformation``,
``process_scene``), ``collate``, ``prepare_mask_targets``, then random
network outputs through ``ensemble_sem_compl``, ``ensemble_panop`` and
``panoptic_inference``, and the metrics (``SSCMetrics``,
``UncertaintyMetrics``, PQ) on those predictions.  Every stage is its own
case, at ``n_infers`` 1 and 3.
"""

import dataclasses
import functools
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

MODULES = {
    "config": "core.config",
    "params": "data.semantic_kitti.params",
    "transform": "data.transform_utils",
    "dataset": "data.semantic_kitti.dataset",
    "collate": "data.semantic_kitti.collate",
    "synthetic": "data.synthetic",
    "native": "native",
    "panoptic": "inference.panoptic",
    "ensemble": "inference.ensemble",
    "ssc": "metrics.ssc",
    "unc": "metrics.uncertainty",
    "pq": "metrics.pq",
}


def _pkg(name):
    return SimpleNamespace(**{k: importlib.import_module(f"{name}.{v}")
                              for k, v in MODULES.items()})


def assert_same(a, b, path="out"):
    """Identical structure and values; arrays bit-equal (NaN == NaN)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a).__name__ == type(b).__name__ and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        assert_same(dataclasses.asdict(a), dataclasses.asdict(b), path)
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), path
    else:
        assert a == b, (path, a, b)


@functools.lru_cache(maxsize=None)
def host_chain(name, S, seed=0):
    """The whole host chain with package ``name``'s modules."""
    m = _pkg(name)
    cfg = m.config.tiny_config(n_infers=S)
    scene_size = cfg.scene.scene_size
    rng = np.random.RandomState(seed)
    out = {"config": cfg}
    scene = m.synthetic.make_scene(rng, scene_size=scene_size, n_points=1500,
                                   point_feat_dim=cfg.model.in_channels - 6)
    Ts = [m.transform.generate_random_transformation(
        rng, max_angle=10.0, scale_range=0.0, max_translation=(0.2, 0.2, 0.1))
        for _ in range(S)]
    views = [m.dataset.process_scene(scene, T, rng) for T in Ts]
    out["scene"] = (scene, views)
    col = m.collate.collate(views, cfg, rng=rng)
    out["collate"] = col
    labels, mask_id = m.dataset.prepare_mask_targets(
        col.semantic_label_origin, col.instance_label_origin, cfg.thing_ids)
    out["mask_targets"] = (labels, mask_id)

    # random network outputs in each subnet's frame
    C, Q = cfg.model.n_classes, cfg.model.num_queries
    smin, smax = np.asarray(col.subnet_min), np.asarray(col.subnet_max)
    sem_dense, vox, coords, qlogits = [], [], [], []
    for s in range(S):
        size = smax[s] - smin[s] + 1
        sem_dense.append(m.panoptic._softmax(
            rng.randn(*size, C).astype(np.float32)).transpose(3, 0, 1, 2).copy())
        n = int(np.prod(size))
        pick = np.sort(rng.choice(n, size=min(n, 300), replace=False))
        coords.append(np.stack(np.unravel_index(pick, tuple(size)), 1) + smin[s])
        vox.append(1.0 / (1.0 + np.exp(-3.0 * rng.randn(len(pick), Q))))
        qlogits.append(rng.randn(Q, C + 1).astype(np.float32) * 3.0)
    sem = m.ensemble.ensemble_sem_compl(sem_dense, list(smin), list(Ts), scene_size)
    out["ensemble_sem"] = sem
    panop = m.ensemble.ensemble_panop(
        vox, coords, qlogits, list(smin), list(Ts), sem,
        iou_threshold=cfg.inference.iou_threshold, out_size=scene_size)
    out["ensemble_panop"] = panop
    icfg = cfg.inference
    results = []
    for po in panop:
        dense = po["voxel_probs_dense"]
        occ = np.argwhere(dense.sum(0) > 0)
        r = m.panoptic.panoptic_inference(
            dense[:, occ[:, 0], occ[:, 1], occ[:, 2]].T, occ, po["query_probs"],
            np.zeros(3, np.int32), scene_size, cfg.thing_ids,
            overlap_threshold=icfg.overlap_threshold,
            object_mask_threshold=icfg.object_mask_threshold,
            vox_occ_threshold=icfg.vox_occ_threshold)
        r["ssc_confidence"] = m.ensemble.ssc_confidence(
            po["sem_probs_dense"], icfg.ensemble_confidence_type)
        results.append(r)
    out["panoptic"] = results

    # metrics of every output against the scene's labels
    sem_gt = col.semantic_label_origin
    gt_masks = mask_id[None] == np.arange(len(labels))[:, None, None, None]
    gt_pan, gt_seg = m.pq.mask_labels_to_panoptic(labels, gt_masks, cfg.thing_ids)
    unknown = sem_gt == 255
    ssc, unc, pq, matched_all = [], [], [], []
    for r, probs in zip(results, sem):
        pred_pan, gpan = r["panoptic_seg_dense"].copy(), gt_pan.copy()
        pred_pan[unknown] = 0
        gpan[unknown] = 0
        pred_info = [x for x in r["segments_info"] if x["id"] in set(np.unique(pred_pan))]
        gt_info = [x for x in gt_seg if x["id"] in set(np.unique(gpan))]
        stat = m.pq.PQStat()
        matched_all.append(sorted(m.pq.pq_update(stat, gt_info, pred_info, gpan, pred_pan,
                                                 cfg.thing_ids)))
        pq.append((stat.pq_average(None, 0, cfg.thing_ids),
                   stat.pq_average(True, 0, cfg.thing_ids)[0]))
        met = m.ssc.SSCMetrics(C)
        pred = probs.argmax(0)
        met.add_batch(pred, sem_gt)
        met.add_batch_ece(r["ssc_confidence"], pred, probs, sem_gt)
        ssc.append(met.get_stats())
        u = m.unc.UncertaintyMetrics()
        matched = m.pq.find_matched_segments(gt_info, pred_info, gpan, pred_pan, threshold=0.5)
        u.compute_ece_panop(pred_pan, pred_info, r["vox_confidence_dense"], matched, gpan,
                            gt_info, C)
        unc.append((matched, u.get_stats()))
    out["pq"] = (gt_pan, gt_seg, matched_all, pq)
    out["ssc"] = ssc
    out["uncertainty"] = unc
    return out


STAGES = ["config", "scene", "collate", "mask_targets", "ensemble_sem",
          "ensemble_panop", "panoptic", "pq", "ssc", "uncertainty"]


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("stage", STAGES)
def test_host_chain_identical(stage, S):
    assert_same(host_chain("pasco_tpu", S)[stage], host_chain("pasco_torch", S)[stage], stage)


def test_host_chain_exercises_every_stage():
    """The chain's outputs are not trivially empty: kept points, targets,
    panoptic segments and a matched ground truth segment."""
    out = host_chain("pasco_torch", 3)
    assert np.asarray(out["collate"].point_mask).sum() > 0
    assert len(out["mask_targets"][0]) > 0
    assert sum(len(r["segments_info"]) for r in out["panoptic"]) > 0
    assert len(out["ensemble_panop"]) == 4 and len(out["ssc"]) == 4


@pytest.mark.parametrize("name", ["PaSCoConfig", "flagship_narrow_config"])
def test_configs_identical(name):
    ref, port = _pkg("pasco_tpu").config, _pkg("pasco_torch").config
    assert_same(getattr(ref, name)(), getattr(port, name)(), name)
    assert_same(ref.OptimConfig(), port.OptimConfig(), "OptimConfig")
    assert_same(_pkg("pasco_tpu").params.CLASS_FREQUENCIES,
                _pkg("pasco_torch").params.CLASS_FREQUENCIES, "CLASS_FREQUENCIES")


@pytest.mark.parametrize("shape", [(7, 7), (5, 11), (12, 4), (40, 40)])
def test_linear_sum_assignment_identical(shape):
    ref, port = _pkg("pasco_tpu").native, _pkg("pasco_torch").native
    cost = np.random.RandomState(sum(shape)).rand(*shape)
    cost[0, :] = cost[0, 0]                      # ties
    assert port.have_native()
    assert_same(ref.linear_sum_assignment(cost), port.linear_sum_assignment(cost))
    assert_same(ref.assignment_vector(cost), port.assignment_vector(cost))


@pytest.mark.parametrize("p", [0.05, 0.3])
def test_connected_components_identical(p):
    ref, port = _pkg("pasco_tpu").native, _pkg("pasco_torch").native
    mask = np.random.RandomState(int(p * 100)).rand(20, 18, 9) < p
    got = port.connected_components_26(mask)
    assert_same(ref.connected_components_26(mask), got)
    assert got[1] > 1
