"""Visualization export (the port's copy of
``pasco_tpu/utils/visualization.py``; NumPy and SciPy only).

The reference renders with Mayavi (``pasco/utils/helper_kitti_mayavi.py``,
``scripts/visualize.py``), which needs a GUI stack; here the same
voxel-scene views (semantic / panoptic / uncertainty) are exported as
colored point clouds in PLY (viewable in MeshLab/CloudCompare/Open3D) plus
a 3D median filter equivalent to the reference's numba one
(``visualize.py:20-62``, via ``scipy.ndimage``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# 20-class SemanticKITTI color map (RGB 0-255), standard palette.
SEMKITTI_COLORS = np.array(
    [
        [0, 0, 0],        # empty
        [100, 150, 245],  # car
        [100, 230, 245],  # bicycle
        [30, 60, 150],    # motorcycle
        [80, 30, 180],    # truck
        [0, 0, 255],      # other-vehicle
        [255, 30, 30],    # person
        [255, 40, 200],   # bicyclist
        [150, 30, 90],    # motorcyclist
        [255, 0, 255],    # road
        [255, 150, 255],  # parking
        [75, 0, 75],      # sidewalk
        [175, 0, 75],     # other-ground
        [255, 200, 0],    # building
        [255, 120, 50],   # fence
        [0, 175, 0],      # vegetation
        [135, 60, 0],     # trunk
        [150, 240, 80],   # terrain
        [255, 240, 150],  # pole
        [255, 0, 0],      # traffic-sign
    ],
    dtype=np.uint8,
)


def median_filter_3d(volume: np.ndarray, size: int = 3) -> np.ndarray:
    """3D median filter over a label volume (reference's numba filter)."""
    from scipy import ndimage

    return ndimage.median_filter(volume, size=size)


def write_ply(
    path: str, xyz: np.ndarray, rgb: np.ndarray
) -> None:
    """Minimal binary-less PLY writer (ascii)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(xyz)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, c in zip(xyz, rgb):
            f.write(
                f"{p[0]:.3f} {p[1]:.3f} {p[2]:.3f} "
                f"{int(c[0])} {int(c[1])} {int(c[2])}\n"
            )


def _voxel_points(volume_mask: np.ndarray, voxel_size: float) -> np.ndarray:
    coords = np.argwhere(volume_mask)
    return (coords + 0.5) * voxel_size


def export_semantic_ply(
    path: str,
    semantic: np.ndarray,
    voxel_size: float = 0.2,
    colors: np.ndarray = SEMKITTI_COLORS,
) -> None:
    mask = (semantic > 0) & (semantic != 255)
    xyz = _voxel_points(mask, voxel_size)
    rgb = colors[np.clip(semantic[mask], 0, len(colors) - 1)]
    write_ply(path, xyz, rgb)


def export_panoptic_ply(
    path: str,
    panoptic: np.ndarray,
    segments_info: List[dict],
    voxel_size: float = 0.2,
    seed: int = 0,
) -> None:
    """Random color per segment, stuff tinted by class color."""
    rng = np.random.RandomState(seed)
    id2color = {0: np.zeros(3, np.uint8)}
    for seg in segments_info:
        if seg.get("isthing", True):
            id2color[seg["id"]] = rng.randint(30, 255, 3).astype(np.uint8)
        else:
            id2color[seg["id"]] = SEMKITTI_COLORS[
                np.clip(seg["category_id"], 0, len(SEMKITTI_COLORS) - 1)
            ]
    mask = panoptic > 0
    xyz = _voxel_points(mask, voxel_size)
    ids = panoptic[mask]
    rgb = np.stack([id2color.get(int(i), np.zeros(3, np.uint8)) for i in ids])
    write_ply(path, xyz, rgb)


def export_uncertainty_ply(
    path: str,
    confidence: np.ndarray,
    occupancy: np.ndarray,
    voxel_size: float = 0.2,
) -> None:
    """Blue (confident) -> red (uncertain) heat colors."""
    mask = occupancy > 0
    xyz = _voxel_points(mask, voxel_size)
    u = 1.0 - np.clip(confidence[mask], 0, 1)
    rgb = np.stack(
        [
            (u * 255).astype(np.uint8),
            np.zeros_like(u, np.uint8),
            ((1 - u) * 255).astype(np.uint8),
        ],
        axis=1,
    )
    write_ply(path, xyz, rgb)
