"""The benchmark's traffic generator: synthetic SemanticKITTI-sized scans,
made from a seed on the host with NumPy alone.

A frozen copy of the program's scan recipe, so that a change to the
program's ``data/`` code leaves the traffic as it is:

* :func:`make_scene` is ``pasco_torch/data/synthetic.py:make_scene`` (ground,
  buildings, vegetation, box-shaped things, an unknown far end, LiDAR-like
  points on the occupied voxels);
* :func:`eval_view` is the eval branch of
  ``pasco_torch/data/semantic_kitti/dataset.py:process_scene`` as far as the
  model's input needs it: the points voxelised and moved through the view's
  rigid transform, and the view's bounding box from the hole-free warp of
  the label grid (``transform_utils.transform_scene``);
* :func:`collate_points` is the input half of
  ``semantic_kitti/collate.py:collate``: every view's points in one padded
  array (subnet id in column 0), subsampled to ``num_points // S`` a view,
  and the global box rounded to ``complete_scale``.

A traffic file (``benchmark/traffic/<name>.json``) gives the parameters.
The augmentation's rotations and flips are a fixed table and only the
scenes, the translations, the points and the pool's order come from the
seed, so that every seed gives the same working boxes (the same work) in
another order.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Sequence

import numpy as np

VOXEL_SIZE = 0.2
VOX_ORIGIN = np.array([0.0, -25.6, -2.0])
WORLD_MIN = np.array([0.0, -25.6, -2.0])


def seeded_rng(seed: int, *stream: int) -> np.random.RandomState:
    """A RandomState for (seed, stream...); any seed of up to 64 bits."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), *stream]).generate_state(1)[0]
    return np.random.RandomState(int(state))


def make_scene(rng: np.random.RandomState, scene_size: Sequence[int], n_points: int,
               point_feat_dim: int, n_things: int = 6, unknown_ratio: float = 0.2):
    """``(semantic_label [X, Y, Z] uint8, xyz [P, 3], point_feats [P, F])``."""
    X, Y, Z = scene_size
    sem = np.zeros((X, Y, Z), np.uint8)

    ground_z = max(1, Z // 16)
    sem[:, :, :ground_z] = 17
    road_w = Y // 3
    sem[:, Y // 2 - road_w // 2: Y // 2 + road_w // 2, :ground_z] = 9
    sem[:, : Y // 8, :ground_z] = 11

    for side in (0, 1):
        x0 = rng.randint(0, max(1, X // 2))
        x1 = x0 + rng.randint(max(1, X // 8), max(2, X // 3))
        y0 = (rng.randint(0, max(1, Y // 8)) if side == 0
              else Y - rng.randint(1, max(2, Y // 8)))
        h = rng.randint(max(ground_z + 1, Z // 2), max(ground_z + 2, Z - 1))
        sem[x0:x1, max(0, y0 - 3): y0 + 3, ground_z:h] = 13

    for _ in range(4):
        cx, cy = rng.randint(0, X), rng.randint(0, Y)
        r = rng.randint(2, 6)
        h = rng.randint(1, max(2, Z // 2))
        sem[max(0, cx - r): min(X, cx + r), max(0, cy - r): min(Y, cy + r),
            ground_z: ground_z + h] = 15

    for _ in range(n_things):
        cls = int(rng.choice([1, 1, 1, 4, 6]))
        sx, sy, sz = {1: (10, 5, 4), 4: (16, 6, 8), 6: (2, 2, 5)}[cls]
        sx, sy, sz = min(sx, X // 2), min(sy, Y // 2), min(sz, max(1, Z - ground_z))
        x0 = rng.randint(0, max(1, X - sx))
        y0 = rng.randint(0, max(1, Y - sy))
        sem[x0: x0 + sx, y0: y0 + sy, ground_z: ground_z + sz] = cls

    n_unk = int(X * unknown_ratio)
    sem[X - n_unk:, :, :] = np.where(rng.rand(n_unk, Y, Z) < 0.7, 255,
                                     sem[X - n_unk:, :, :]).astype(np.uint8)

    occ = np.argwhere((sem > 0) & (sem != 255))
    if len(occ) == 0:
        occ = np.array([[X // 2, Y // 2, Z // 2]])
    voxel = occ[rng.randint(0, len(occ), n_points)]
    xyz = (voxel + rng.rand(n_points, 3)) * VOXEL_SIZE + VOX_ORIGIN[None, :]
    feats = rng.randn(n_points, point_feat_dim).astype(np.float32)
    feats[:, 0] = rng.rand(n_points)
    return sem, xyz.astype(np.float64), feats


def view_transform(rng: np.random.RandomState, angle_deg: float, flip: bool,
                   max_translation: Sequence[float]) -> np.ndarray:
    """The eval augmentation with a given rotation and y-flip, a random
    translation and no scaling (``transform_utils.
    generate_transformation``'s ``Scale @ (Rot|t) @ Flip``)."""
    translation = (rng.rand(3) - 0.5) * np.asarray(max_translation)
    rot = np.deg2rad(angle_deg)
    t = np.eye(4)
    c, s = np.cos(rot), np.sin(rot)
    t[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
    t[:3, 3] = translation
    t_flip = np.eye(4)
    if flip:
        t_flip[1, 1] = -1.0
    return t @ t_flip


def transform(coords: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Voxel indices through ``T`` (in metres about the canonical origin),
    rounded (``transform_utils.transform``)."""
    T = np.asarray(T, np.float64)
    R, t = T[:3, :3], T[:3, 3]
    center = WORLD_MIN + VOXEL_SIZE / 2
    b = (R @ center + t - center) / VOXEL_SIZE
    out = coords.astype(np.float32) @ R.T.astype(np.float32) + b.astype(np.float32)
    return np.round(out).astype(np.int32)


def grid_coords(dims: Sequence[int]) -> np.ndarray:
    n = int(np.prod(dims))
    flat = np.arange(n, dtype=np.int32)
    yz = dims[1] * dims[2]
    rem = flat % yz
    return np.stack([flat // yz, rem // dims[2], rem % dims[2]], axis=1).astype(np.int32)


def warped_bounds(sem: np.ndarray, T: np.ndarray):
    """Bounds of the cells of the hole-free warp of ``sem`` through ``T``
    whose back-projection lands inside the grid (``process_scene``'s
    ``sem_coords_t``: every sampled cell, unknown ones included)."""
    to_c = transform(np.argwhere(sem != 255), T)
    mn, mx = to_c.min(0), to_c.max(0)
    out = grid_coords(mx - mn + 1) + mn[None, :]
    back = transform(out, np.linalg.inv(T))
    ok = np.all((back >= 0) & (back < np.asarray(sem.shape)), axis=1)
    return out[ok].min(0), out[ok].max(0)


def eval_view(sem, xyz, T, complete_scale: int) -> Dict[str, np.ndarray]:
    """One subnet's view: its points' voxel coords through ``T``, their 6
    offset and position channels (``voxelize_points``) and its box
    ``[min_C, max_C]``.  The point features are shared by the views and
    gathered by :func:`collate_points`."""
    mn, mx = warped_bounds(sem, T)
    coords = np.floor((xyz - VOX_ORIGIN[None]) / VOXEL_SIZE).astype(np.int64)
    centers = (coords.astype(np.float32) + 0.5) * VOXEL_SIZE + VOX_ORIGIN[None]
    off = (xyz - centers).astype(np.float32)
    return dict(
        in_coords=transform(coords, T),
        off_feats=np.concatenate([off, xyz.astype(np.float32)], axis=1),
        min_C=(np.floor(mn / complete_scale) * complete_scale).astype(np.int32),
        max_C=np.ceil(mx).astype(np.int32),
    )


def collate_points(views: List[Dict[str, np.ndarray]], feats: np.ndarray, num_points: int,
                   complete_scale: int, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    """The model input's arrays (``collate``'s input half); a view's point
    features are ``feats`` then its offset channels."""
    S = len(views)
    P = num_points
    nf = feats.shape[1]
    point_feats = np.zeros((P, nf + views[0]["off_feats"].shape[1]), np.float32)
    point_coords = np.zeros((P, 4), np.int32)
    point_mask = np.zeros((P,), bool)
    cursor, budget = 0, P // S
    for s, v in enumerate(views):
        m = len(v["in_coords"])
        n = min(m, budget)
        sel = (rng.choice(m, budget, replace=False) if m > budget else np.arange(m))[:n]
        point_feats[cursor: cursor + n, :nf] = feats[sel]
        point_feats[cursor: cursor + n, nf:] = v["off_feats"][sel]
        point_coords[cursor: cursor + n, 0] = s
        point_coords[cursor: cursor + n, 1:] = v["in_coords"][sel]
        point_mask[cursor: cursor + n] = True
        cursor += n
    subnet_min = np.stack([v["min_C"] for v in views]).astype(np.int32)
    subnet_max = np.stack([v["max_C"] for v in views]).astype(np.int32)
    cs = complete_scale
    return dict(
        point_feats=point_feats, point_coords=point_coords, point_mask=point_mask,
        global_min=(np.floor(subnet_min.min(0) / cs).astype(np.int32) * cs),
        global_max=np.ceil(subnet_max.max(0)).astype(np.int32),
        subnet_min=subnet_min, subnet_max=subnet_max,
    )


def make_scan(traffic: dict, model: dict, scene: dict, num_points: int, seed: int,
              slot: int) -> Dict[str, np.ndarray]:
    """Scan ``slot`` of the pool of ``seed``: one scene, ``n_infers`` views
    of it, collated.  View ``v`` of slot ``i`` turns by
    ``angles_deg[(i + v) % len(angles_deg)]``, to the left where ``i + v``
    is even and to the right where it is odd, and odd views are flipped:
    the views' union, and so the working box and the work, is the same for
    every seed."""
    rng = seeded_rng(seed, slot)
    sem, xyz, feats = make_scene(rng, scene["scene_size"], traffic["points"],
                                 model["in_channels"] - 6)
    angles = traffic["angles_deg"]
    views = [eval_view(sem, xyz,
                       view_transform(rng, angles[(slot + v) % len(angles)] * (-1) ** (slot + v),
                                      v % 2 == 1, traffic["max_translation"]),
                       scene["complete_scale"])
             for v in range(model["n_infers"])]
    return collate_points(views, feats, num_points, scene["complete_scale"], rng)


def make_pool(traffic: dict, config: dict, seed: int, workers: int) -> List[Dict[str, np.ndarray]]:
    """The ``traffic["pool"]`` distinct scans of ``seed``, in an order drawn
    from the seed, made in ``workers`` spawned processes (one where
    ``workers <= 1``)."""
    order = seeded_rng(seed, 1 << 30).permutation(traffic["pool"])
    args = [(traffic, config["model"], config["scene"], config["capacity"]["num_points"],
             seed, int(slot)) for slot in order]
    if workers <= 1:
        return [make_scan(*a) for a in args]
    # an executor raises where a worker dies, where a pool would wait on
    with ProcessPoolExecutor(min(workers, len(args)),
                             mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(make_scan, *zip(*args)))
