"""Forward + MIMO ensembling + panoptic assembly for one scene
(counterpart of ``pasco_tpu/inference/pipeline.py:41-145``).

The network runs on the tensors' device; everything after it is the
reference's NumPy host code (``pasco_tpu.inference.{ensemble,panoptic}``),
reused as it is.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from pasco_tpu.core.config import PaSCoConfig
from pasco_tpu.data.semantic_kitti.collate import CollatedScene
from pasco_tpu.inference.ensemble import ensemble_panop, ensemble_sem_compl, ssc_confidence
from pasco_tpu.inference.panoptic import _softmax, panoptic_inference


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
