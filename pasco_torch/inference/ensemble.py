"""MIMO ensemble fusion of per-subnet predictions.

Re-design of ``Ensembler`` (reference ``pasco/models/ensembler.py:15-192``)
and its helpers (``sample_scene``/``transform`` in
``pasco/models/transform_utils.py:60-181``, ``find_matching_indices_v2`` in
``pasco/models/utils.py:153-198``):

* Each subnet saw a differently-augmented copy of the scan (rigid transform
  ``T`` in metres).  Fusion resamples each subnet's dense predictions back
  into the canonical 256x256x32 frame by *inverse lookup*: every canonical
  cell center is pushed through ``T`` and nearest-sampled in the subnet
  grid (hole-free by construction).
* Subnet queries are matched to the anchor subnet with Hungarian matching
  on soft-IoU cost, then running-averaged.

All of this is NumPy host code — it is the post-network ensemble step the
reference also times separately ("ensemble time").
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pasco_torch import native
from pasco_torch.inference.panoptic import _softmax

# Canonical SemanticKITTI SSC volume (kitti_dataset.py:86-89).
WORLD_MIN = np.array([0.0, -25.6, -2.0])


def transform_voxel_coords(
    coords: np.ndarray, T: np.ndarray, resolution: float = 0.2
) -> np.ndarray:
    """Voxel coords -> world (cell centers) -> T -> voxel coords (rounded)
    (reference ``transform``, ``transform_utils.py:60-75``)."""
    pts = coords.astype(np.float64) * resolution + resolution / 2 + WORLD_MIN
    homo = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    out = (np.asarray(T, np.float64) @ homo.T).T[:, :3]
    out = (out - WORLD_MIN - resolution / 2) / resolution
    return np.round(out).astype(np.int32)


def resample_to_canonical(
    dense: np.ndarray,           # [C, X, Y, Z] subnet-frame volume
    subnet_min: np.ndarray,      # [3] subnet bbox min (voxel units)
    T: np.ndarray,               # [4, 4] the subnet's augmentation
    out_size: Sequence[int] = (256, 256, 32),
    resolution: float = 0.2,
) -> np.ndarray:
    """Nearest-neighbour inverse-warp into the canonical frame
    (reference ``sample_scene``, ``transform_utils.py:160-181``)."""
    X, Y, Z = out_size
    gx, gy, gz = np.meshgrid(
        np.arange(X), np.arange(Y), np.arange(Z), indexing="ij"
    )
    canon = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)
    proj = transform_voxel_coords(canon, T, resolution) - np.asarray(
        subnet_min, np.int32
    )
    shape = np.asarray(dense.shape[1:], np.int32)
    ok = np.all((proj >= 0) & (proj < shape[None, :]), axis=1)
    projc = np.clip(proj, 0, shape[None, :] - 1)
    vals = dense[:, projc[:, 0], projc[:, 1], projc[:, 2]]
    vals = np.where(ok[None, :], vals, 0)
    return vals.reshape(dense.shape[0], X, Y, Z)


def find_matching_indices(
    anchor_masks: np.ndarray,    # [Q, ...] dense prob volumes
    anchor_query_prob: np.ndarray,
    aux_masks: np.ndarray,
    aux_query_prob: np.ndarray,
    iou_threshold: float,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Soft-IoU Hungarian query matching (reference
    ``find_matching_indices_v2``, ``models/utils.py:153-198``)."""
    q = anchor_masks.shape[0]
    a = anchor_masks.reshape(q, -1).astype(np.float64)
    b = aux_masks.reshape(q, -1).astype(np.float64)
    inter = a @ b.T
    union = a.sum(1, keepdims=True) + b.sum(1, keepdims=True).T - inter
    iou = np.where(union != 0, inter / np.maximum(union, 1e-12), 0.0)
    iou = iou * (iou > iou_threshold)
    cost = 1.0 - iou
    ai, xi = native.linear_sum_assignment(cost)
    return ai, xi, iou[ai, xi]


def ensemble_sem_compl(
    sem_probs_dense: List[np.ndarray],   # per subnet [C, X', Y', Z'] in subnet frame
    subnet_mins: List[np.ndarray],
    Ts: List[np.ndarray],
    out_size: Sequence[int] = (256, 256, 32),
) -> List[np.ndarray]:
    """Per-subnet canonical-frame semantic probs + mean ensemble appended
    (reference ``ensemble_sem_compl``, ``ensembler.py:159-187``).  Cells not
    covered by a subnet get empty-class probability 1."""
    outs = []
    for probs, mn, T in zip(sem_probs_dense, subnet_mins, Ts):
        canon = resample_to_canonical(probs, mn, T, out_size)
        empty = canon.sum(0) == 0
        canon[0][empty] = 1.0
        outs.append(canon)
    outs.append(np.mean(np.stack(outs, 0), axis=0))
    return outs


def ensemble_panop(
    voxel_probs: List[np.ndarray],       # per subnet [N_i, Q] sigmoid probs
    coords: List[np.ndarray],            # per subnet [N_i, 3]
    query_logits: List[np.ndarray],      # per subnet [Q, C+1]
    subnet_mins: List[np.ndarray],
    Ts: List[np.ndarray],
    ensemble_sem_prob_denses: List[np.ndarray],
    iou_threshold: float = 0.2,
    out_size: Sequence[int] = (256, 256, 32),
) -> List[Dict[str, np.ndarray]]:
    """Cross-subnet query matching + running average
    (reference ``ensemble_panop``, ``ensembler.py:20-131``).

    Returns one entry per subnet plus the ensemble, each holding canonical
    dense voxel mask probs [Q', X, Y, Z] and query probs [Q', C+1].
    """
    n_subnets = len(voxel_probs)
    q = query_logits[0].shape[0]

    dense_probs = []
    query_probs = []
    for i in range(n_subnets):
        mn = np.asarray(coords[i]).min(0) if len(coords[i]) else subnet_mins[i]
        mx = np.asarray(coords[i]).max(0) if len(coords[i]) else subnet_mins[i]
        size = mx - mn + 1
        dense = np.zeros((q, *size), np.float32)
        rel = coords[i] - mn[None, :]
        dense[:, rel[:, 0], rel[:, 1], rel[:, 2]] = voxel_probs[i].T
        dense_probs.append(resample_to_canonical(dense, mn, Ts[i], out_size))
        query_probs.append(_softmax(query_logits[i]))

    anchor_q = query_probs[0].copy()
    anchor_v = dense_probs[0].copy()
    ious = []
    for i in range(1, n_subnets):
        ai, xi, iou = find_matching_indices(
            anchor_v, anchor_q, dense_probs[i], query_probs[i], iou_threshold
        )
        anchor_q[ai] = (anchor_q[ai] * i + query_probs[i][xi]) / (i + 1)
        anchor_v[ai] = (anchor_v[ai] * i + dense_probs[i][xi]) / (i + 1)
        ious.append(iou)

    if ious:
        iou = np.stack(ious, 0).mean(0)
        keep = iou > iou_threshold
        anchor_v = anchor_v[keep]
        anchor_q = anchor_q[keep]

    ens_sem_class = ensemble_sem_prob_denses[-1].argmax(0)
    anchor_v = anchor_v * (ens_sem_class != 0)[None].astype(np.float32)

    dense_probs.append(anchor_v)
    query_probs.append(anchor_q)

    outputs = []
    for i in range(len(dense_probs)):
        outputs.append(
            {
                "voxel_probs_dense": dense_probs[i],
                "query_probs": query_probs[i],
                "sem_probs_dense": ensemble_sem_prob_denses[i],
            }
        )
    return outputs


def ssc_uncertainty(subnet_sem_prob_denses: List[np.ndarray]) -> np.ndarray:
    """Cross-subnet variance map (reference ``ssc_uncertainty``,
    ``ensembler.py:189-192``)."""
    return np.stack(subnet_sem_prob_denses, 0).var(0).mean(0)


def ssc_confidence(
    sem_prob_dense: np.ndarray, kind: str = "max_prob"
) -> np.ndarray:
    """Per-voxel confidence (reference ``net_panoptic_sparse.py:252-310``)."""
    if kind == "max_prob":
        return sem_prob_dense.max(0)
    if kind == "entropy":
        p = sem_prob_dense
        ent = -(p * np.log(np.maximum(p, 1e-12))).sum(0) / np.log(p.shape[0])
        return 1.0 - ent
    raise ValueError(kind)


def ensemble_occ(
    occ_probs_dense: List[np.ndarray],   # per subnet [1, X', Y', Z'] probs
    subnet_mins: List[np.ndarray],
    Ts: List[np.ndarray],
    out_size: Sequence[int] = (256, 256, 32),
) -> np.ndarray:
    """Mean canonical-frame occupancy probability over subnets
    (reference ``ensemble_occ``, ``ensembler.py:133-157``)."""
    outs = [
        resample_to_canonical(p, mn, T, out_size)
        for p, mn, T in zip(occ_probs_dense, subnet_mins, Ts)
    ]
    return np.mean(np.stack(outs, 0), axis=0)
