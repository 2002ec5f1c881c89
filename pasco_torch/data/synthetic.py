"""Synthetic SemanticKITTI-like scene generator.

Produces :class:`SceneSample`-compatible scenes (ground plane, walls,
vegetation "stuff" + box-shaped "thing" instances, and a simulated LiDAR
point cloud) so the full pipeline — augmentation, label pyramid, collate,
model, losses, metrics — can be exercised and benchmarked without the
dataset on disk.  The reference has no equivalent; its only correctness
check is re-running eval on released checkpoints (SURVEY §4).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from pasco_torch.data.semantic_kitti import params
from pasco_torch.data.semantic_kitti.dataset import SceneSample


def make_scene(
    rng: np.random.RandomState,
    scene_size: Tuple[int, int, int] = params.SCENE_SIZE,
    n_things: int = 6,
    n_points: int = 20000,
    point_feat_dim: int = 8,
    unknown_ratio: float = 0.2,
) -> SceneSample:
    """Random but structured scene in the canonical frame."""
    X, Y, Z = scene_size
    sem = np.zeros((X, Y, Z), np.uint8)
    inst = np.zeros((X, Y, Z), np.int32)

    # Ground: road (9) strip + terrain (17) + sidewalk (11).
    ground_z = max(1, Z // 16)
    sem[:, :, :ground_z] = 17
    road_w = Y // 3
    sem[:, Y // 2 - road_w // 2 : Y // 2 + road_w // 2, :ground_z] = 9
    sem[:, : Y // 8, :ground_z] = 11

    # Buildings (13) along the sides.
    for side in (0, 1):
        x0 = rng.randint(0, max(1, X // 2))
        x1 = x0 + rng.randint(max(1, X // 8), max(2, X // 3))
        y0 = (
            rng.randint(0, max(1, Y // 8))
            if side == 0
            else Y - rng.randint(1, max(2, Y // 8))
        )
        h = rng.randint(max(ground_z + 1, Z // 2), max(ground_z + 2, Z - 1))
        sem[x0:x1, max(0, y0 - 3) : y0 + 3, ground_z:h] = 13

    # Vegetation blobs (15).
    for _ in range(4):
        cx, cy = rng.randint(0, X), rng.randint(0, Y)
        r = rng.randint(2, 6)
        h = rng.randint(1, max(2, Z // 2))
        xs = slice(max(0, cx - r), min(X, cx + r))
        ys = slice(max(0, cy - r), min(Y, cy + r))
        sem[xs, ys, ground_z : ground_z + h] = 15

    # Thing instances: cars (1), trucks (4), persons (6), scaled to fit.
    inst_id = 0
    for _ in range(n_things):
        cls = int(rng.choice([1, 1, 1, 4, 6]))
        sx, sy, sz = {
            1: (10, 5, 4),
            4: (16, 6, 8),
            6: (2, 2, 5),
        }[cls]
        sx, sy, sz = min(sx, X // 2), min(sy, Y // 2), min(sz, max(1, Z - ground_z))
        x0 = rng.randint(0, max(1, X - sx))
        y0 = rng.randint(0, max(1, Y - sy))
        inst_id += 1
        sem[x0 : x0 + sx, y0 : y0 + sy, ground_z : ground_z + sz] = cls
        inst[x0 : x0 + sx, y0 : y0 + sy, ground_z : ground_z + sz] = inst_id

    # Unknown region (occlusion shadow): far end of the scene.
    n_unk = int(X * unknown_ratio)
    sem[X - n_unk :, :, :] = np.where(
        rng.rand(n_unk, Y, Z) < 0.7, 255, sem[X - n_unk :, :, :]
    ).astype(np.uint8)

    # LiDAR-ish points: sample occupied surface voxels + noise.
    occ = np.argwhere((sem > 0) & (sem != 255))
    if len(occ) == 0:
        occ = np.array([[X // 2, Y // 2, Z // 2]])
    sel = rng.randint(0, len(occ), n_points)
    voxel = occ[sel]
    jitter = rng.rand(n_points, 3)
    xyz = (voxel + jitter) * params.VOXEL_SIZE + params.VOX_ORIGIN[None, :]
    feats = rng.randn(n_points, point_feat_dim).astype(np.float32)
    # First feature mimics intensity in [0, 1].
    feats[:, 0] = rng.rand(n_points)

    return SceneSample(
        semantic_label=sem,
        instance_label=inst,
        xyz=xyz.astype(np.float64),
        point_feats=feats,
        frame_id="synthetic",
        sequence="99",
    )


class SyntheticKittiDataset:
    """Drop-in stand-in for :class:`KittiDataset` built on random scenes —
    lets the full training/eval loop run without SemanticKITTI on disk."""

    def __init__(
        self,
        n_scenes: int = 8,
        n_subnets: int = 1,
        scene_size: Tuple[int, int, int] = params.SCENE_SIZE,
        n_points: int = 20000,
        point_feat_dim: int = 8,
        n_classes: int = params.N_CLASSES,
        thing_ids=params.THING_IDS,
        data_aug: bool = False,
        split: str = "train",
        seed: int = 0,
    ):
        self.n_scenes = n_scenes
        self.n_subnets = n_subnets
        self.scene_size = scene_size
        self.n_points = n_points
        self.point_feat_dim = point_feat_dim
        self.n_classes = n_classes
        self.thing_ids = thing_ids
        self.data_aug = data_aug
        self.split = split
        self.seed = seed

    def __len__(self):
        return self.n_scenes

    def __getitem__(self, idx):
        from pasco_torch.data.semantic_kitti.dataset import process_scene
        from pasco_torch.data.transform_utils import (
            generate_random_transformation,
        )

        rng = np.random.RandomState(self.seed + int(idx))
        scene = make_scene(
            rng,
            scene_size=self.scene_size,
            n_points=self.n_points,
            point_feat_dim=self.point_feat_dim,
        )
        out = []
        for s in range(self.n_subnets):
            T = (
                generate_random_transformation(
                    rng, max_angle=10.0, scale_range=0.0,
                    max_translation=(0.2, 0.2, 0.1),
                )
                if self.data_aug
                else None
            )
            out.append(
                process_scene(
                    scene, T, rng,
                    n_classes=self.n_classes,
                    thing_ids=self.thing_ids,
                    train_crop=(self.split == "train"),
                )
            )
        return out
