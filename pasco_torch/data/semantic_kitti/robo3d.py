"""SemanticKITTI-C (Robo3D) corruption-robustness evaluation dataset (the
port's copy of ``pasco_tpu/data/semantic_kitti/robo3d.py``).

Re-implementation of ``KittiDatasetRobo3D``
(reference ``pasco/data/semantic_kitti/kitti_dataset_robo3d.py``): the
same val scans under 8 corruption conditions x 3 severity levels, with
point features read from the corruption-specific WaffleIron dumps
(``waffleiron_v2/<condition>/<level>/seg_feats_tta_robo3d``,
reference ``:339-342``).
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

from pasco_torch.data.semantic_kitti import io_data, params
from pasco_torch.data.semantic_kitti.dataset import (
    KittiDataset,
    SceneSample,
)

# Reference kitti_dataset_robo3d.py:46-58.
CONDITIONS = (
    "beam_missing",
    "cross_sensor",
    "crosstalk",
    "fog",
    "incomplete_echo",
    "motion_blur",
    "snow",
    "wet_ground",
)
LEVELS = ("light", "moderate", "heavy")


@dataclass
class KittiDatasetRobo3D(KittiDataset):
    """Val-split scans with corrupted point clouds / features."""

    condition: str = "fog"
    level: str = "light"
    # Corrupted-dump base directory; defaults to ``preprocess_root`` (the
    # reference nests the robo3d dumps under the same preprocess root,
    # ``kitti_dataset_robo3d.py:339-342``).
    robo3d_root: str = ""

    def __post_init__(self):
        assert self.condition in CONDITIONS, self.condition
        assert self.level in LEVELS, self.level
        super().__post_init__()

    def load_scene(self, seq: str, frame: str) -> SceneSample:
        """Labels come from the clean dataset; points/features from the
        corrupted dumps."""
        clean = super().load_scene(seq, frame)
        wi_pkl = os.path.join(
            self.robo3d_root or self.preprocess_root,
            "waffleiron_v2",
            self.condition,
            self.level,
            "seg_feats_tta_robo3d",
            seq,
            f"{frame}.pkl",
        )
        if not os.path.exists(wi_pkl):
            return clean
        with open(wi_pkl, "rb") as f:
            d = pickle.load(f)
        emb = d["embedding"]
        emb = emb[self.rng.randint(0, emb.shape[0])].T
        xyz_i = d["coords"]
        xyz, intensity = xyz_i[:, :3], xyz_i[:, 3:]
        vote = d["vote"]
        radius = np.linalg.norm(xyz, axis=1, keepdims=True)
        feats = np.concatenate([vote, intensity, radius, emb], axis=1)
        keep = np.all(
            (xyz >= params.VOX_ORIGIN[None]) & (xyz < params.MAX_EXTENT[None]),
            axis=1,
        )
        return SceneSample(
            semantic_label=clean.semantic_label,
            instance_label=clean.instance_label,
            xyz=xyz[keep],
            point_feats=feats[keep],
            frame_id=frame,
            sequence=seq,
        )
