"""Forward + MIMO ensembling + panoptic assembly for one scene, and the
metric accumulators over scenes (counterpart of
``pasco_tpu/inference/pipeline.py:41-236``).

The network runs on the tensors' device; everything after it is NumPy
host code: the port's copies of the reference's ensembling, panoptic
assembly, metrics and ``prepare_mask_targets``
(``pasco_torch.inference.{ensemble,panoptic}``, ``pasco_torch.metrics``,
``pasco_torch.data``).  The reference module imports JAX, so
:class:`Evaluator` is restated here.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from pasco_torch.core.config import PaSCoConfig
from pasco_torch.data.semantic_kitti.collate import CollatedScene
from pasco_torch.data.semantic_kitti.dataset import prepare_mask_targets
from pasco_torch.inference.ensemble import ensemble_panop, ensemble_sem_compl, ssc_confidence
from pasco_torch.inference.panoptic import _softmax, panoptic_inference
from pasco_torch.metrics.pq import (
    PQStat, find_matched_segments, mask_labels_to_panoptic, pq_update)
from pasco_torch.metrics.ssc import SSCMetrics
from pasco_torch.metrics.uncertainty import UncertaintyMetrics


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def subnet_sem_prob_dense(out, s: int, subnet_min: np.ndarray,
                          subnet_max: np.ndarray) -> np.ndarray:
    """Dense [C, X', Y', Z'] softmax probs of subnet ``s`` at scale 1, in
    its own frame."""
    grid = out.sem_grids[1]
    coords = _np(grid.coords)[:, 1:]
    mask = _np(grid.mask)
    logits = _np(out.sem_logits[1])[:, s]
    keep = (
        mask
        & np.all(coords >= subnet_min[None], axis=1)
        & np.all(coords <= subnet_max[None], axis=1)
    )
    size = subnet_max - subnet_min + 1
    dense = np.zeros((logits.shape[-1], *size), np.float32)
    rel = coords[keep] - subnet_min[None]
    dense[:, rel[:, 0], rel[:, 1], rel[:, 2]] = _softmax(logits[keep]).T
    return dense


def run_scene_inference(forward_fn, inp, scene: CollatedScene,
                        cfg: PaSCoConfig) -> Dict[str, object]:
    """``forward_fn(inp)`` + MIMO ensembling + panoptic assembly.

    Returns per-output (subnet 0..S-1, then ensemble) canonical-frame
    predictions plus the forward's and the ensembling's wall times.  The
    forward is timed to a device synchronise."""
    S = cfg.model.n_infers
    icfg = cfg.inference
    scene_size = cfg.scene.scene_size
    on_cuda = inp.point_feats.is_cuda

    t0 = time.perf_counter()
    with torch.no_grad():
        out = forward_fn(inp)
    if on_cuda:
        torch.cuda.synchronize(inp.point_feats.device)
    inference_time = time.perf_counter() - t0

    subnet_min = np.asarray(scene.subnet_min)
    subnet_max = np.asarray(scene.subnet_max)
    Ts = np.asarray(scene.Ts)
    sem_dense = [
        subnet_sem_prob_dense(out, s, subnet_min[s], subnet_max[s])
        for s in range(S)
    ]
    t1 = time.perf_counter()
    sem_prob_denses = ensemble_sem_compl(
        sem_dense, [subnet_min[s] for s in range(S)], list(Ts), scene_size
    )
    grid1 = out.panop_grids[1]
    vox_probs, coords_list, qlogits = [], [], []
    for s in range(S):
        m = _np(grid1.mask[s])
        coords_list.append(_np(grid1.coords[s])[m][:, 1:])
        logits = _np(out.predictor.voxel_logits[s])[m]
        vox_probs.append(1.0 / (1.0 + np.exp(-logits)))
        qlogits.append(_np(out.predictor.query_logits[s]))
    panop_outputs = ensemble_panop(
        vox_probs, coords_list, qlogits,
        [subnet_min[s] for s in range(S)], list(Ts), sem_prob_denses,
        iou_threshold=icfg.iou_threshold, out_size=scene_size,
    )
    ensemble_time = time.perf_counter() - t1

    results = []
    for po in panop_outputs:
        dense_probs = po["voxel_probs_dense"]
        occupied = dense_probs.sum(0) > 0
        coords = np.argwhere(occupied)
        vprob = dense_probs[:, coords[:, 0], coords[:, 1], coords[:, 2]].T
        panop = panoptic_inference(
            vprob, coords, po["query_probs"], np.zeros(3, np.int32),
            scene_size, cfg.thing_ids,
            overlap_threshold=icfg.overlap_threshold,
            object_mask_threshold=icfg.object_mask_threshold,
            vox_occ_threshold=icfg.vox_occ_threshold,
        )
        panop["sem_prob_dense"] = po["sem_probs_dense"]
        panop["ssc_confidence"] = ssc_confidence(
            po["sem_probs_dense"], icfg.ensemble_confidence_type
        )
        results.append(panop)
    return {
        "outputs": results,
        "inference_time": inference_time,
        "ensemble_time": ensemble_time,
    }


class Evaluator:
    """SSC, PQ and uncertainty accumulators over scenes for every output
    of :func:`run_scene_inference` (subnets 0..S-1, then the ensemble), as
    the reference's per-``i_infer`` metric dictionaries
    (``net_panoptic_sparse.py:193-208``)."""

    def __init__(self, cfg: PaSCoConfig):
        self.cfg = cfg
        n_out = cfg.model.n_infers + 1
        self.ssc = [SSCMetrics(cfg.model.n_classes) for _ in range(n_out)]
        self.pq = [PQStat() for _ in range(n_out)]
        self.unc = [UncertaintyMetrics() for _ in range(n_out)]

    def add_scene(self, results: Dict[str, object],
                  semantic_label_origin: np.ndarray,   # canonical [X, Y, Z]
                  instance_label_origin: np.ndarray) -> None:
        """Score every output of one scene, uncertainty included, against
        its canonical-frame labels."""
        cfg = self.cfg
        outputs = results["outputs"]
        gt_labels, gt_mask_id = prepare_mask_targets(
            semantic_label_origin, instance_label_origin, cfg.thing_ids)
        gt_masks = gt_mask_id[None] == np.arange(len(gt_labels))[:, None, None, None]
        gt_panoptic, gt_segments = mask_labels_to_panoptic(
            gt_labels, gt_masks, cfg.thing_ids)
        unknown = semantic_label_origin == 255
        for i, o in enumerate(outputs):
            pred_pan = o["panoptic_seg_dense"].copy()
            gt_pan = gt_panoptic.copy()
            pred_pan[unknown] = 0
            gt_pan[unknown] = 0
            pred_ids = set(np.unique(pred_pan).tolist())
            gt_ids = set(np.unique(gt_pan).tolist())
            pred_info = [s for s in o["segments_info"] if s["id"] in pred_ids]
            gt_info = [s for s in gt_segments if s["id"] in gt_ids]
            pq_update(self.pq[i], gt_info, pred_info, gt_pan, pred_pan, cfg.thing_ids)
            sem_prob = o["sem_prob_dense"]
            ssc_pred = sem_prob.argmax(0)
            self.ssc[i].add_batch(ssc_pred, semantic_label_origin)
            self.ssc[i].add_batch_ece(
                o["ssc_confidence"], ssc_pred, sem_prob, semantic_label_origin,
                inference_time=results["inference_time"])
            matched = find_matched_segments(
                gt_info, pred_info, gt_pan, pred_pan, threshold=0.5)
            self.unc[i].compute_ece_panop(
                pred_pan, pred_info, o["vox_confidence_dense"], matched,
                gt_pan, gt_info, cfg.model.n_classes)

    def summary(self) -> List[Dict[str, object]]:
        """Per output: PQ over all, thing and stuff classes, per-class PQ,
        the SSC statistics and the uncertainty statistics."""
        thing_ids = self.cfg.thing_ids
        out = []
        for pq, ssc, unc in zip(self.pq, self.ssc, self.unc):
            all_res, per_class = pq.pq_average(None, 0, thing_ids)
            out.append({
                "pq_all": all_res,
                "pq_things": pq.pq_average(True, 0, thing_ids)[0],
                "pq_stuff": pq.pq_average(False, 0, thing_ids)[0],
                "per_class": per_class,
                "ssc": ssc.get_stats(),
                "uncertainty": unc.get_stats(),
            })
        return out
