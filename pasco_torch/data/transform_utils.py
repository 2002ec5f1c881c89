"""Rigid-transform voxel-grid resampling (augmentation machinery).

NumPy re-implementation of ``pasco/models/transform_utils.py``:

* :func:`generate_transformation` / :func:`generate_random_transformation`
  build the per-subnet augmentation matrices (rotation about z, y-flip,
  anisotropic scale, translation — reference ``:6-46``).
* :func:`transform` maps voxel indices through a transform in *metres*
  using the canonical SemanticKITTI volume origin (reference ``:60-75``).
* :func:`transform_scene` resamples a label grid into the transformed frame
  hole-free: enumerate the target grid, project *backwards*, nearest-sample
  the source (reference ``:120-157``).
* :func:`sample_scene` is the inverse warp used by the ensembler to bring
  per-subnet predictions back to the canonical frame (reference
  ``:160-181``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

# Canonical SemanticKITTI SSC volume bounds in metres
# (kitti_dataset.py:86-89): x [0, 51.2), y [-25.6, 25.6), z [-2, 4.4).
WORLD_MIN = np.array([0.0, -25.6, -2.0])
DEFAULT_RESOLUTION = 0.2


def rotation_z(deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def generate_transformation(
    rot: float = 0.0,
    translation: Sequence[float] = (0.0, 0.0, 0.0),
    flip_dim: Optional[int] = None,
    scale=1.0,
) -> np.ndarray:
    """T = Scale @ (Rot|trans) @ Flip, all 4x4 (reference ``:6-29``)."""
    t_flip = np.eye(4)
    if flip_dim is not None:
        t_flip[flip_dim, flip_dim] = -1.0
    t = np.eye(4)
    t[:3, :3] = rotation_z(rot)
    t[:3, 3] = translation
    t_scale = np.eye(4)
    t_scale[[0, 1, 2], [0, 1, 2]] = np.asarray(scale) * np.ones(3)
    return t_scale @ t @ t_flip


def generate_random_transformation(
    rng: np.random.RandomState,
    max_angle: float = 45.0,
    flip: bool = True,
    scale_range: float = 0.1,
    max_translation: Sequence[float] = (1.0, 1.0, 0.5),
) -> np.ndarray:
    """Reference ``generate_random_transformation`` (``:32-46``)."""
    translation = (rng.rand(3) - 0.5) * np.asarray(max_translation)
    rot = (rng.rand() - 0.5) * max_angle * 2
    flip_dim = 1 if (flip and rng.rand() > 0.5) else None
    scale = 1.0 + (rng.rand(3) - 0.5) * scale_range
    return generate_transformation(rot, translation, flip_dim, scale)


def transform(
    coords: np.ndarray, T: np.ndarray, resolution: float = DEFAULT_RESOLUTION
) -> np.ndarray:
    """Voxel indices -> world cell centers -> T -> voxel indices (rounded),
    reference ``transform`` (``:60-75``).

    Folded affine form: the naive chain (scale, +center, homogeneous
    concat, 4x4 matmul, -center, /res) built five [N, 3..4] float64
    temporaries — ~2 s/scene over the 4M-cell hole-free warp grids.  Same
    math as ``round((R(c*res + res/2 + Wmin) + t - Wmin - res/2)/res)``
    with A = res*R/res = R^T applied right, b folded once."""
    T = np.asarray(T, np.float64)
    R, t = T[:3, :3], T[:3, 3]
    center = WORLD_MIN + resolution / 2
    A = R.T  # out = c @ R^T * res ... / res == c @ R^T
    b = (R @ center + t - center) / resolution
    # f32 per-point math: coords are O(100) voxel units, so f32 keeps
    # ~1e-5 absolute precision at the rounding step (f64 folding above).
    out = coords.astype(np.float32) @ A.astype(np.float32) + b.astype(
        np.float32
    )
    return np.round(out).astype(np.int32)


def transform_xyz(points: np.ndarray, T: np.ndarray) -> np.ndarray:
    homo = np.concatenate([points, np.ones((len(points), 1))], axis=1)
    return (np.asarray(T, np.float64) @ homo.T).T[:, :3]


def grid_coords(dims: Sequence[int]) -> np.ndarray:
    """All integer coords of a grid, shape [prod(dims), 3] (x-major)."""
    n = int(np.prod(dims))
    out = np.empty((n, 3), np.int32)
    flat = np.arange(n, dtype=np.int32)
    yz = dims[1] * dims[2]
    np.floor_divide(flat, yz, out=out[:, 0])
    rem = flat % yz
    np.floor_divide(rem, dims[2], out=out[:, 1])
    np.mod(rem, dims[2], out=out[:, 2])
    return out


def sample_grid(values: np.ndarray, coords: np.ndarray, fill=0) -> np.ndarray:
    """Nearest sample ``values [C, X, Y, Z]`` at integer coords [N, 3];
    out-of-range -> fill (grid_sample nearest + zero padding equivalent)."""
    X, Y, Z = values.shape[1:]
    cx = np.clip(coords[:, 0], 0, X - 1)
    cy = np.clip(coords[:, 1], 0, Y - 1)
    cz = np.clip(coords[:, 2], 0, Z - 1)
    ok = (
        (coords[:, 0] >= 0) & (coords[:, 0] < X)
        & (coords[:, 1] >= 0) & (coords[:, 1] < Y)
        & (coords[:, 2] >= 0) & (coords[:, 2] < Z)
    )
    flat = (cx * Y + cy) * Z + cz
    out = values.reshape(values.shape[0], -1)[:, flat]
    return np.where(ok[None, :], out, fill)


def transform_scene(
    from_coords: np.ndarray,       # [N, 3] occupied coords of the source
    T: np.ndarray,
    voxel_values: np.ndarray,      # [C, X, Y, Z] source grid
    to_coords_bnd: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    resolution: float = DEFAULT_RESOLUTION,
) -> Tuple[np.ndarray, np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """Hole-free forward warp (reference ``transform_scene``, ``:120-157``):
    the output grid spans the transform of the occupied coords; every output
    cell back-projects through ``T^-1`` and nearest-samples the source.

    Returns ``(values [M, C], out_coords [M, 3], bounds)``.
    """
    if to_coords_bnd is None:
        to_c = transform(from_coords, T, resolution)
        to_coords_bnd = (to_c.min(0), to_c.max(0))
    mn, mx = to_coords_bnd
    size = mx - mn + 1
    out_coords = grid_coords(size) + mn[None, :]
    back = transform(out_coords, np.linalg.inv(T), resolution)
    vals = sample_grid(voxel_values, back)
    return vals.T, out_coords.astype(np.int32), to_coords_bnd


def sample_scene(
    subnet_min: np.ndarray,
    T: np.ndarray,
    subnet_values: np.ndarray,     # [C, X', Y', Z'] subnet-frame grid
    out_size: Sequence[int],
    resolution: float = DEFAULT_RESOLUTION,
) -> np.ndarray:
    """Inverse warp into the canonical frame (reference ``sample_scene``,
    ``:160-181``): canonical cells project *through T* into the subnet grid.
    Returns ``[C, *out_size]``."""
    canon = grid_coords(out_size)
    proj = transform(canon, T, resolution) - np.asarray(subnet_min, np.int64)
    vals = sample_grid(subnet_values, proj)
    return vals.reshape(subnet_values.shape[0], *out_size)
