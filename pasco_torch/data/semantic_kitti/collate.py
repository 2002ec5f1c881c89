"""Collation of per-subnet samples into static-shape device batches.

Equivalent of the reference ``collate_fn``
(``pasco/data/semantic_kitti/collate.py:11-107``) plus the padding step
that static TPU shapes require: points are padded to
``CapacityConfig.num_points``, panoptic targets to ``max_targets``, and the
dense target grids live on the static working box (dynamic minimum corner,
static extents), so one compiled program serves every scan.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from pasco_torch.core.config import PaSCoConfig
from pasco_torch.data.semantic_kitti.dataset import SubnetSample


class TargetBundle(NamedTuple):
    """Per-scene training targets (leading axis = subnet), host-built.

    Dense grids are in the subnet frame, indexed relative to
    ``subnet_min`` and zero-padded to the static box extent.
    """

    labels: np.ndarray          # [S, T_cap] int32 mask classes
    labels_valid: np.ndarray    # [S, T_cap] bool
    mask_id_dense: np.ndarray   # [S, X, Y, Z] int32 (T_cap = no mask)
    semantic_dense: np.ndarray  # [S, X, Y, Z] uint8 (255 unknown)
    unknown_dense: np.ndarray   # [S, X, Y, Z] bool (geo 1_1 == 255)
    sem_label_1: np.ndarray     # [S, X, Y, Z] uint8
    sem_label_2: np.ndarray     # [S, X/2, Y/2, Z/2] uint8
    sem_label_4: np.ndarray     # [S, X/4, Y/4, Z/4] uint8
    geo_label_1: np.ndarray     # [S, X, Y, Z] uint8


class CollatedScene(NamedTuple):
    """Everything one training/eval step needs for one scene."""

    # ModelInput fields (jnp-ready numpy arrays)
    point_feats: np.ndarray
    point_coords: np.ndarray
    point_mask: np.ndarray
    global_min: np.ndarray
    global_max: np.ndarray
    subnet_min: np.ndarray
    subnet_max: np.ndarray
    targets: TargetBundle
    Ts: np.ndarray              # [S, 4, 4] augmentations (for the ensembler)
    # Canonical-frame GT of item 0 (ensemble evaluation target; at val all
    # subnets view the same scan, net_panoptic_sparse.py:620-627).
    semantic_label_origin: np.ndarray
    instance_label_origin: np.ndarray


def _pad_to_box(grid: np.ndarray, extent: Sequence[int], fill) -> np.ndarray:
    """Embed a subnet-frame grid into the static box extent."""
    out = np.full(tuple(extent), fill, dtype=grid.dtype)
    sx = min(grid.shape[0], extent[0])
    sy = min(grid.shape[1], extent[1])
    sz = min(grid.shape[2], extent[2])
    out[:sx, :sy, :sz] = grid[:sx, :sy, :sz]
    return out


def collate(
    subnets: List[SubnetSample],
    cfg: PaSCoConfig,
    max_targets: int = 64,
    rng: Optional[np.random.RandomState] = None,
) -> CollatedScene:
    """Stack n_subnets samples; compute the global bbox rounded to
    ``complete_scale`` (reference ``collate.py:76-81``).

    ``rng`` seeds the over-capacity point subsampling; every other random
    draw in the pipeline threads an explicit RandomState/PRNGKey, so
    runs are bit-reproducible when one is passed.
    """
    if rng is None:
        rng = np.random.RandomState()
    S = len(subnets)
    cap = cfg.capacity
    ext = cfg.scene.box_extent
    cs = cfg.scene.complete_scale

    # --- points (all subnets concatenated, subnet id in column 0) --------
    P = cap.num_points
    feats_dim = subnets[0].in_feats.shape[1]
    point_feats = np.zeros((P, feats_dim), np.float32)
    point_coords = np.zeros((P, 4), np.int32)
    point_mask = np.zeros((P,), bool)
    cursor = 0
    budget = P // S
    for s, sub in enumerate(subnets):
        n = min(len(sub.in_coords), budget)
        sel = (
            rng.choice(len(sub.in_coords), budget, replace=False)
            if len(sub.in_coords) > budget
            else np.arange(len(sub.in_coords))
        )[:n]
        point_feats[cursor : cursor + n] = sub.in_feats[sel]
        point_coords[cursor : cursor + n, 0] = s
        point_coords[cursor : cursor + n, 1:] = sub.in_coords[sel]
        point_mask[cursor : cursor + n] = True
        cursor += n

    # --- bboxes -----------------------------------------------------------
    subnet_min = np.stack([s.min_C for s in subnets]).astype(np.int32)
    subnet_max = np.stack([s.max_C for s in subnets]).astype(np.int32)
    gmin = np.floor(subnet_min.min(0) / cs).astype(np.int32) * cs
    gmax = np.ceil(subnet_max.max(0)).astype(np.int32)

    # --- targets ----------------------------------------------------------
    t_cap = max_targets
    labels = np.zeros((S, t_cap), np.int32)
    labels_valid = np.zeros((S, t_cap), bool)
    mask_id = np.full((S, *ext), t_cap, np.int32)
    semantic = np.full((S, *ext), 255, np.uint8)
    unknown = np.ones((S, *ext), bool)
    ext2 = tuple(e // 2 for e in ext)
    ext4 = tuple(e // 4 for e in ext)
    sem1 = np.full((S, *ext), 255, np.uint8)
    sem2 = np.full((S, *ext2), 255, np.uint8)
    sem4 = np.full((S, *ext4), 255, np.uint8)
    geo1 = np.full((S, *ext), 255, np.uint8)

    for s, sub in enumerate(subnets):
        t = min(len(sub.mask_labels), t_cap)
        labels[s, :t] = sub.mask_labels[:t]
        labels_valid[s, :t] = True
        mid = sub.mask_id_dense.copy()
        mid[mid < 0] = t_cap
        mid[mid >= t_cap] = t_cap
        mask_id[s] = _pad_to_box(mid.astype(np.int32), ext, t_cap)
        semantic[s] = _pad_to_box(sub.semantic_label, ext, 255)
        geo = sub.geo_labels[1]
        geo1[s] = _pad_to_box(geo, ext, 255)
        unknown[s] = geo1[s] == 255
        sem1[s] = _pad_to_box(sub.sem_labels[1], ext, 255)
        sem2[s] = _pad_to_box(sub.sem_labels[2], ext2, 255)
        sem4[s] = _pad_to_box(sub.sem_labels[4], ext4, 255)

    targets = TargetBundle(
        labels=labels,
        labels_valid=labels_valid,
        mask_id_dense=mask_id,
        semantic_dense=semantic,
        unknown_dense=unknown,
        sem_label_1=sem1,
        sem_label_2=sem2,
        sem_label_4=sem4,
        geo_label_1=geo1,
    )
    return CollatedScene(
        point_feats=point_feats,
        point_coords=point_coords,
        point_mask=point_mask,
        global_min=gmin,
        global_max=gmax,
        subnet_min=subnet_min,
        subnet_max=subnet_max,
        targets=targets,
        Ts=np.stack([s.T for s in subnets]).astype(np.float32),
        semantic_label_origin=subnets[0].semantic_label_origin,
        instance_label_origin=subnets[0].instance_label_origin,
    )
