"""Panoptic segment assembly from query/mask predictions.

Re-design of ``panoptic_inference`` (reference
``pasco/models/helper.py:91-303``).  The reference loops over ~100 kept
queries on GPU with ``.item()`` syncs; here the per-voxel winner
computation is one vectorised argmax and only the tiny (<=100-entry) greedy
segment-id bookkeeping (stuff merging, overlap filtering) runs as a host
loop over query-level scalars.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def semantic_inference(
    voxel_probs: np.ndarray,    # [N, Q] sigmoid mask probs
    query_logits: np.ndarray,   # [Q, C+1]
) -> Optional[np.ndarray]:
    """Per-voxel semantic logits from the panoptic head
    (reference ``semantic_inference_v2``, ``helper.py:7-39``)."""
    n_classes = query_logits.shape[-1] - 1
    q_prob = _softmax(query_logits)
    keep = np.argmax(q_prob, axis=-1) != n_classes
    if not keep.any():
        return None
    p = voxel_probs[:, keep] + 1e-8
    p = p / p.sum(axis=1, keepdims=True)
    return p @ query_logits[keep, :-1]


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - np.max(x, axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def panoptic_inference(
    voxel_probs: np.ndarray,     # [N, Q] sigmoid mask probs (valid rows)
    coords: np.ndarray,          # [N, 3] absolute voxel coords
    query_probs: np.ndarray,     # [Q, C+1] softmax query probs
    min_C: np.ndarray,           # [3] scene box min
    scene_size: Sequence[int],
    thing_ids: Sequence[int],
    overlap_threshold: float = 0.4,
    object_mask_threshold: float = 0.7,
    vox_occ_threshold: float = 0.3,
) -> Dict[str, object]:
    """Greedy Mask2Former panoptic assembly for one subnet.

    Returns dense [X, Y, Z] panoptic / semantic / confidence volumes plus
    ``segments_info`` dicts matching the reference schema
    (``helper.py:248-268``).
    """
    n_classes = query_probs.shape[-1] - 1
    X, Y, Z = scene_size

    probs = query_probs.max(-1)
    labels = query_probs.argmax(-1)
    keep = (labels != 0) & (labels != n_classes) & (probs > object_mask_threshold)
    kept = np.nonzero(keep)[0]

    N = voxel_probs.shape[0]
    panoptic_seg = np.zeros((N,), np.int32)
    semantic_seg = np.zeros((N,), np.int32)
    ins_uncertainty = np.zeros((N,), np.float32)
    vox_uncertainty = np.zeros((N,), np.float32)
    vox_confidence = np.zeros((N,), np.float32)
    segments_info: List[dict] = []

    if kept.size > 0:
        fm = voxel_probs[:, kept]                       # [N, K]
        fq = probs[kept]                                # [K]
        combined = fq[None, :] * fm                     # [N, K]
        cur_ids = combined.argmax(1)                    # [N]
        norm_mask_prob = fm / (fm.sum(1, keepdims=True) + 1e-8)
        vox_unc_all = combined / np.maximum(
            combined.sum(1, keepdims=True), 1e-20
        )
        vox_unc_max = vox_unc_all.max(1)

        occ = fm >= vox_occ_threshold                   # [N, K]
        original_area = occ.sum(0)                      # [K]
        winner = np.equal(cur_ids[:, None], np.arange(kept.size)[None, :]) & occ
        mask_area = winner.sum(0)                       # [K]

        # Greedy id allocation over query-level scalars only.
        seg_id_of_k = np.zeros((kept.size,), np.int32)
        write_of_k = np.zeros((kept.size,), bool)   # writes panoptic id
        full_of_k = np.zeros((kept.size,), bool)    # also writes sem/conf
        current = 0
        stuff_memory: Dict[int, int] = {}
        for j, q in enumerate(kept):
            cls = int(labels[q])
            if mask_area[j] == 0 or original_area[j] == 0:
                continue
            if mask_area[j] / original_area[j] < overlap_threshold:
                continue
            if cls == 0:
                continue
            isthing = cls in thing_ids
            if not isthing and cls in stuff_memory:
                # Merged stuff region: reference only writes the panoptic id
                # for these voxels (helper.py:233-237 `continue`).
                seg_id_of_k[j] = stuff_memory[cls]
                write_of_k[j] = True
                continue
            current += 1
            if not isthing:
                stuff_memory[cls] = current
            seg_id_of_k[j] = current
            write_of_k[j] = True
            full_of_k[j] = True
            segments_info.append(
                {
                    "id": current,
                    "isthing": bool(isthing),
                    "category_id": cls,
                    "query_id": int(q),
                    "confidence": float(fq[j]),
                    "all_class_probs": query_probs[q].copy(),
                }
            )

        occ_win = occ[np.arange(N), cur_ids]
        sel = write_of_k[cur_ids] & occ_win
        sel_full = full_of_k[cur_ids] & occ_win
        panoptic_seg = np.where(sel, seg_id_of_k[cur_ids], 0).astype(np.int32)
        cls_of_k = labels[kept].astype(np.int32)
        semantic_seg = np.where(sel_full, cls_of_k[cur_ids], 0).astype(np.int32)
        ins_uncertainty = np.where(sel_full, fq[cur_ids], 0).astype(np.float32)
        vox_confidence = np.where(
            sel_full, norm_mask_prob[np.arange(N), cur_ids], 0
        ).astype(np.float32)
        vox_uncertainty = np.where(sel_full, vox_unc_max, 0).astype(np.float32)

    def densify(vals: np.ndarray) -> np.ndarray:
        out = np.zeros((X, Y, Z), vals.dtype)
        rel = coords - np.asarray(min_C)[None, :]
        ok = np.all((rel >= 0) & (rel < np.asarray([X, Y, Z])[None, :]), axis=1)
        out[rel[ok, 0], rel[ok, 1], rel[ok, 2]] = vals[ok]
        return out

    return {
        "panoptic_seg": panoptic_seg,
        "semantic_seg": semantic_seg,
        "panoptic_seg_dense": densify(panoptic_seg),
        "semantic_seg_dense": densify(semantic_seg),
        "ins_uncertainty_dense": densify(ins_uncertainty),
        "vox_uncertainty_dense": densify(vox_uncertainty),
        "vox_confidence_dense": densify(vox_confidence),
        "segments_info": segments_info,
    }
