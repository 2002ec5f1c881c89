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


@pytest.mark.parametrize("name", ["PaSCoConfig", "flagship_narrow_config",
                                  "kitti360_config"])
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


def _seeded_summary(rng, n_classes=20):
    def pq():
        return {k: float(rng.rand()) for k in ("pq_dagger", "pq", "sq", "rq")}

    ssc = {k: float(rng.rand()) for k in (
        "iou_ssc_mean", "iou", "precision", "recall", "nonempty_ece", "empty_ece",
        "nonempty_nll", "empty_nll")}
    unc = {k: float(rng.rand()) for k in ("ins_ece", "ins_nll", "ins_brier", "ins_fpr95")}
    per_class = {int(c): pq() for c in rng.choice(n_classes + 2, 6, replace=False)}
    return {"pq_all": pq(), "pq_things": pq(), "pq_stuff": pq(), "per_class": per_class,
            "ssc": ssc, "uncertainty": unc}


@pytest.mark.parametrize("S", [1, 3])
def test_tables_identical(S, capsys):
    """``print_all`` prints and returns the same string in both packages on
    a seeded summary of every output (per-class rows include an unknown
    class id, named by its number)."""
    ref = importlib.import_module("pasco_tpu.metrics.tables")
    port = importlib.import_module("pasco_torch.metrics.tables")
    names = _pkg("pasco_torch").params.CLASS_NAMES
    rng = np.random.RandomState(S)
    summaries = [_seeded_summary(rng) for _ in range(S + 1)]
    if S == 3:
        del summaries[0]["uncertainty"]["ins_brier"]       # optional columns
    got = port.print_all(summaries, S, names, inference_time=0.1234, ensemble_time=0.5)
    out_port = capsys.readouterr().out
    want = ref.print_all(summaries, S, names, inference_time=0.1234, ensemble_time=0.5)
    assert got == want and out_port == capsys.readouterr().out
    assert "ensemble" in got and "per-class PQ" in got


@pytest.mark.parametrize("S", [1, 3])
def test_convert_torch_identical(S):
    """The port's copy of the reference-checkpoint converter gives the same
    parameter and statistics trees as the original on a seeded state dict
    (flagship widths), and the spec and the permutations agree."""
    ref = importlib.import_module("pasco_tpu.training.convert_torch")
    port = importlib.import_module("pasco_torch.training.convert_torch")
    assert_same(ref.reference_state_dict_spec(S), port.reference_state_dict_spec(S))
    for k in (1, 2, 3):
        assert_same(ref.me_kernel_permutation(k), port.me_kernel_permutation(k))
    sd_ref = ref.synthetic_reference_state_dict(np.random.RandomState(S), n_infers=S)
    sd = port.synthetic_reference_state_dict(np.random.RandomState(S), n_infers=S)
    assert_same(sd_ref, sd)
    assert_same(ref.convert_reference_checkpoint(sd_ref, S),
                port.convert_reference_checkpoint(sd, S))


def test_visualization_ply_identical(tmp_path):
    """The PLY files of both packages' exports are byte-identical, and so
    is the median filter."""
    ref = importlib.import_module("pasco_tpu.utils.visualization")
    port = importlib.import_module("pasco_torch.utils.visualization")
    rng = np.random.RandomState(0)
    sem = rng.randint(0, 20, (12, 10, 6)).astype(np.uint8)
    sem[rng.rand(*sem.shape) < 0.1] = 255
    pan = rng.randint(0, 5, sem.shape).astype(np.int32)
    segs = [{"id": i, "category_id": int(rng.randint(1, 20)), "isthing": bool(i % 2)}
            for i in range(1, 5)]
    conf = rng.rand(*sem.shape).astype(np.float32)
    for tag, mod in (("ref", ref), ("port", port)):
        d = tmp_path / tag
        mod.export_semantic_ply(str(d / "sem.ply"), sem)
        mod.export_panoptic_ply(str(d / "pan.ply"), pan, segs)
        mod.export_uncertainty_ply(str(d / "unc.ply"), conf, sem)
    for f in ("sem.ply", "pan.ply", "unc.ply"):
        a, b = (tmp_path / "ref" / f).read_bytes(), (tmp_path / "port" / f).read_bytes()
        assert a == b and a.count(b"\n") > 100, f
    assert_same(ref.median_filter_3d(sem), port.median_filter_3d(sem))


# --------------------------------------------------------------------------
# SSCBench-KITTI360 (pasco_torch/data/kitti360)
# --------------------------------------------------------------------------


def write_kitti360_layout(root, layout="sscbench", n_frames=2, seed=0, block=(24, 24, 8)):
    """A fake SSCBench-KITTI360 tree under ``root`` for the first drive of
    each split (the extension of ``tests/test_data_pipeline.py:242``'s
    fixture): ``n_frames`` scans each, a known block of ``block`` voxels at
    the volume's centre (a road floor, a car, a person and a building
    wall, everything else 255), instance ids for the things, and 600 points
    inside the block.  ``layout="sscbench"`` writes the label volumes
    (``<root>/labels/<drive>/<frame>_1_1.npy``), the instance pickles
    (``<root>/instances``), the raw scans by their original 10-digit id
    (``<root>/raw/data_3d_raw``) and ``<root>/match.txt``; ``"fallback"``
    the SemanticKITTI-style ``<root>/raw/data_2d_raw/<drive>/voxels`` and
    ``velodyne_points`` directories.  Returns the dataset's keyword
    arguments."""
    import os
    import pickle

    from pasco_torch.data.kitti360.params import SPLIT_DRIVES

    rng = np.random.RandomState(seed)
    bx, by, bz = block
    x0, y0, z0 = 128 - bx // 2, 128 - by // 2, 12
    match = []
    for split in ("train", "val", "test"):
        drive = SPLIT_DRIVES[split][0]
        for k in range(n_frames):
            frame, raw_id = f"{k:06d}", f"{40 + 7 * k:010d}"
            sem = np.full((256, 256, 32), 255, np.uint8)
            inst = np.zeros(sem.shape, np.int32)
            sem[x0:x0 + bx, y0:y0 + by, z0:z0 + bz] = 0
            sem[x0:x0 + bx, y0:y0 + by, z0] = 7                          # road
            cx, cy = x0 + 2 + rng.randint(0, bx // 2), y0 + 2 + rng.randint(0, by // 2)
            sem[cx:cx + 6, cy:cy + 4, z0 + 1:z0 + 3] = 1                   # car
            inst[cx:cx + 6, cy:cy + 4, z0 + 1:z0 + 3] = 1
            sem[x0 + bx - 3, y0 + 2:y0 + 4, z0 + 1:z0 + 5] = 6             # person
            inst[x0 + bx - 3, y0 + 2:y0 + 4, z0 + 1:z0 + 5] = 2
            sem[x0:x0 + bx, y0 + by - 1, z0 + 1:z0 + bz] = 11              # building
            vox = np.stack([rng.randint(x0, x0 + bx, 600), rng.randint(y0, y0 + by, 600),
                            rng.randint(z0, z0 + bz, 600)], 1)
            xyz = np.array([0.0, -25.6, -2.0]) + 0.2 * (vox + rng.rand(600, 3))
            pts = np.concatenate([xyz, rng.rand(600, 1)], 1).astype(np.float32)
            if layout == "sscbench":
                for sub, name, data in (("labels", "npy", sem), ("instances", "pkl", None)):
                    d = os.path.join(root, sub, drive)
                    os.makedirs(d, exist_ok=True)
                    path = os.path.join(d, f"{frame}_1_1.{name}")
                    if data is not None:
                        np.save(path, data)
                    else:
                        with open(path, "wb") as f:
                            pickle.dump({"semantic_labels": sem, "instance_labels": inst}, f)
                d = os.path.join(root, "raw", "data_3d_raw", drive, "velodyne_points", "data")
                match.append(f"{drive} {raw_id}.png {frame}.png\n")
            else:
                base = os.path.join(root, "raw", "data_2d_raw", drive)
                os.makedirs(os.path.join(base, "voxels"), exist_ok=True)
                sem.astype(np.uint16).reshape(-1).tofile(
                    os.path.join(base, "voxels", f"{frame}.label"))
                np.packbits(np.zeros(sem.size, np.uint8)).tofile(
                    os.path.join(base, "voxels", f"{frame}.invalid"))
                np.packbits((sem.reshape(-1) > 0) & (sem.reshape(-1) < 255)).tofile(
                    os.path.join(base, "voxels", f"{frame}.bin"))
                d = os.path.join(base, "velodyne_points", "data")
                raw_id = frame
            os.makedirs(d, exist_ok=True)
            pts.tofile(os.path.join(d, f"{raw_id}.bin"))
    kw = dict(root=os.path.join(root, "raw"))
    if layout == "sscbench":
        with open(os.path.join(root, "match.txt"), "w") as f:
            f.writelines(match)
        kw.update(label_root=os.path.join(root, "labels"),
                  instance_label_root=os.path.join(root, "instances"),
                  match_file=os.path.join(root, "match.txt"))
    return kw


@pytest.mark.parametrize("layout", ["sscbench", "fallback"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_kitti360_dataset_identical(tmp_path, layout, split):
    """``Kitti360Dataset`` of both packages on the same tree: the same
    scans (SSCBench frames mapped to their raw ids through the match file,
    or the fallback directory's frames) and identical processed samples
    at ``n_subnets=2`` with augmentation (the train split also draws the
    other subnet's scan and crops)."""
    ref = importlib.import_module("pasco_tpu.data.kitti360.dataset")
    port = importlib.import_module("pasco_torch.data.kitti360.dataset")
    kw = write_kitti360_layout(str(tmp_path), layout, n_frames=3)
    if layout == "sscbench":
        assert_same(ref.parse_match_file(kw["match_file"]),
                    port.parse_match_file(kw["match_file"]))
    dss = [m.Kitti360Dataset(split=split, n_subnets=2, data_aug=True, frame_interval=1,
                             seed=3, **kw) for m in (ref, port)]
    assert dss[0].scans == dss[1].scans and len(dss[1]) == 3
    if layout == "sscbench":
        assert dss[1].scans[1][2] == "0000000047"
    for i in (0, 2, 1):
        a, b = dss[0][i], dss[1][i]
        assert len(b) == 2
        assert_same(a, b, f"{split}[{i}]")


def test_kitti360_params_identical():
    ref = importlib.import_module("pasco_tpu.data.kitti360.params")
    port = importlib.import_module("pasco_torch.data.kitti360.params")
    for name in ("THING_IDS", "N_CLASSES", "CLASS_NAMES", "CLASS_FREQUENCIES",
                 "SPLIT_DRIVES"):
        assert_same(getattr(ref, name), getattr(port, name), name)
