"""SemanticKITTI SSC dataset: scene loading, augmentation, label pyramids.

NumPy re-implementation of ``KittiDataset``
(reference ``pasco/data/semantic_kitti/kitti_dataset.py``).  The pipeline is
split into pure functions so the synthetic test generator and the KITTI-360
variant reuse them:

* :func:`process_scene` == ``get_individual`` (``:142-288``): apply one
  subnet's augmentation by hole-free resampling, voxelize the points, build
  the multiscale semantic/geometric label pyramid and the panoptic mask
  targets.
* :class:`KittiDataset` == the on-disk dataset (``:103-140, :329-461``):
  every 5th frame, per-subnet random scan pairing at train, WaffleIron
  feature pickles, FOV crop, train-time random 0.8 crop.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from pasco_torch.data.semantic_kitti import io_data, params
from pasco_torch.data.transform_utils import (
    generate_random_transformation,
    transform,
    transform_scene,
)


class SceneSample(NamedTuple):
    """One raw scan before augmentation (canonical frame)."""

    semantic_label: np.ndarray   # [256, 256, 32] uint8, 255 = invalid
    instance_label: np.ndarray   # [256, 256, 32] int32, 0 = none
    xyz: np.ndarray              # [P, 3] float world metres
    point_feats: np.ndarray      # [P, F] per-point features
    frame_id: str = ""
    sequence: str = ""


class SubnetSample(NamedTuple):
    """One subnet's processed view of a scene (its own augmented frame)."""

    T: np.ndarray                      # [4, 4] augmentation
    min_C: np.ndarray                  # [3] bbox min (multiple of 8)
    max_C: np.ndarray                  # [3] bbox max
    in_coords: np.ndarray              # [P', 3] voxel coords of input points
    in_feats: np.ndarray               # [P', F + 6]
    semantic_label: np.ndarray         # subnet-frame dense labels (rel. min_C)
    instance_label: np.ndarray
    sem_labels: Dict[int, np.ndarray]  # scale -> dense label grid
    geo_labels: Dict[int, np.ndarray]
    mask_labels: np.ndarray            # [T] class per mask
    mask_id_dense: np.ndarray          # [X, Y, Z] int32 mask index, -1 none
    semantic_label_origin: np.ndarray  # canonical-frame labels (for ensemble)
    instance_label_origin: np.ndarray


def parse_calibration(path: str) -> Dict[str, np.ndarray]:
    """KITTI ``calib.txt`` -> dict of 4x4 matrices (reference
    ``kitti_dataset.py:528-553``)."""
    calib: Dict[str, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, content = line.strip().split(":", 1)
            values = [float(v) for v in content.strip().split()]
            pose = np.zeros((4, 4))
            pose[0, :4] = values[0:4]
            pose[1, :4] = values[4:8]
            pose[2, :4] = values[8:12]
            pose[3, 3] = 1.0
            calib[key] = pose
    return calib


def parse_poses(path: str, calibration: Dict[str, np.ndarray]) -> List[np.ndarray]:
    """KITTI ``poses.txt`` (camera frame) -> per-scan LiDAR-frame poses
    ``Tr^-1 @ pose @ Tr`` (reference ``kitti_dataset.py:555-580``)."""
    Tr = calibration["Tr"]
    Tr_inv = np.linalg.inv(Tr)
    poses: List[np.ndarray] = []
    with open(path) as f:
        for line in f:
            values = [float(v) for v in line.strip().split()]
            if len(values) < 12:
                continue
            pose = np.zeros((4, 4))
            pose[0, :4] = values[0:4]
            pose[1, :4] = values[4:8]
            pose[2, :4] = values[8:12]
            pose[3, 3] = 1.0
            poses.append((Tr_inv @ pose @ Tr).astype(np.float32))
    return poses


def fuse_multi_scan(
    points: np.ndarray, pose0: np.ndarray, pose: np.ndarray
) -> np.ndarray:
    """Re-express ``points`` of a later scan in scan 0's LiDAR frame
    (reference ``kitti_dataset.py:582-591``): lift to scan-k world
    coordinates via ``pose``, then apply the rigid inverse of ``pose0``
    (``R0^T (x - t0)``).  Extra feature columns pass through unchanged."""
    h = np.hstack([points[:, :3], np.ones_like(points[:, :1])])
    world = h @ pose.T
    rel = world[:, :3] - pose0[:3, 3]
    frame0 = rel @ pose0[:3, :3]      # == R0^T applied from the left
    return np.hstack([frame0, points[:, 3:]]).astype(points.dtype)


def voxelize_points(
    xyz: np.ndarray, voxel_size: float = params.VOXEL_SIZE
) -> Tuple[np.ndarray, np.ndarray]:
    """Points -> voxel coords + offset features (reference ``voxelize``,
    ``kitti_dataset.py:305-314``).  Returns (coords [P,3] int, offsets+xyz
    [P,6])."""
    origin = params.VOX_ORIGIN.reshape(1, 3)
    coords = np.floor((xyz - origin) / voxel_size).astype(np.int64)
    centers = (coords.astype(np.float32) + 0.5) * voxel_size + origin
    off = (xyz - centers).astype(np.float32)
    return coords, np.concatenate([off, xyz.astype(np.float32)], axis=1)


def downscale_labels(
    semantic_label: np.ndarray, n_classes: int, scales: Sequence[int] = (1, 2, 4)
) -> Tuple[Dict[int, np.ndarray], Dict[int, np.ndarray]]:
    """Multiscale sem/geo label pyramid with the reference's empty/unknown
    tie rules (``kitti_dataset.py:210-266``):

    * geo: max-pool of the binary occupancy (255 voxels excluded), except a
      cell whose children are ALL 255 becomes 255.
    * sem: majority vote (avg-pool argmax) over occupied classes; cells with
      no occupied child become 0 if any child is known-empty else 255.
    """
    sem_labels, geo_labels = {}, {}
    occ = ((semantic_label > 0) & (semantic_label != 255)).astype(np.float32)
    known = semantic_label != 255
    lbl = semantic_label.astype(np.int64)

    for scale in scales:
        if scale == 1:
            geo = occ.copy().astype(np.float32)
            geo[~known] = 255
            sem_labels[1] = semantic_label.astype(np.uint8)
            geo_labels[1] = geo.astype(np.uint8)
            continue

        X, Y, Z = semantic_label.shape
        xs, ys, zs = X // scale, Y // scale, Z // scale
        view = lambda a: a[: xs * scale, : ys * scale, : zs * scale].reshape(
            xs, scale, ys, scale, zs, scale
        )

        occ_v = view(occ)
        geo = occ_v.max(axis=(1, 3, 5))
        all_unknown = (~view(known)).all(axis=(1, 3, 5))
        geo = geo.astype(np.float32)
        geo[all_unknown] = 255

        # Majority class over occupied children (one-hot avg-pool argmax),
        # as ONE bincount over cell*C + class instead of n_classes full-grid
        # comparison passes (the loop was ~1.5 s/scene at scale 2).
        lv = view(lbl).transpose(0, 2, 4, 1, 3, 5).reshape(xs, ys, zs, -1)
        valid = (lv >= 1) & (lv < n_classes)
        cell = np.arange(xs * ys * zs, dtype=np.int64).reshape(xs, ys, zs, 1)
        idx = (cell * n_classes + lv)[valid]
        counts = np.bincount(
            idx, minlength=xs * ys * zs * n_classes
        ).reshape(xs, ys, zs, n_classes).astype(np.int32)
        sem = counts.argmax(-1)
        no_occ = counts.sum(-1) == 0
        sem = np.where(no_occ & all_unknown, 255, sem)
        sem = np.where(no_occ & ~all_unknown, 0, sem)

        sem_labels[scale] = sem.astype(np.uint8)
        geo_labels[scale] = geo.astype(np.uint8)
    return sem_labels, geo_labels


def prepare_mask_targets(
    semantic_label: np.ndarray,
    instance_label: np.ndarray,
    thing_ids: Sequence[int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Panoptic mask targets (reference ``prepare_mask_label``,
    ``kitti_dataset.py:609-664``): stuff = one mask per non-thing class
    present (excluding 0/255), things = one mask per instance id.

    Masks are disjoint, so they are encoded as one dense index grid:
    returns ``(labels [T], mask_id_dense [X,Y,Z] int32 with -1 = none)``.
    """
    labels: List[int] = []
    mask_id = np.full(semantic_label.shape, -1, np.int32)

    stuff_classes = np.unique(semantic_label)
    for c in stuff_classes:
        c = int(c)
        if c in (0, 255) or c in thing_ids:
            continue
        mask_id[semantic_label == c] = len(labels)
        labels.append(c)

    inst_ids = np.unique(instance_label)
    for iid in inst_ids:
        if iid == 0:
            continue
        m = instance_label == iid
        sem = semantic_label[m]
        labels.append(int(sem[0]))
        mask_id[m] = len(labels) - 1

    return np.asarray(labels, np.int32), mask_id


def process_scene(
    sample: SceneSample,
    T: Optional[np.ndarray],
    rng: np.random.RandomState,
    n_classes: int = params.N_CLASSES,
    thing_ids: Sequence[int] = params.THING_IDS,
    complete_scale: int = 8,
    train_crop: bool = False,
) -> SubnetSample:
    """One subnet's full processing (reference ``get_individual`` +
    ``load_data_v3``, ``kitti_dataset.py:142-461``)."""
    if T is None:
        T = np.eye(4)

    sem = sample.semantic_label.astype(np.int64)
    inst = sample.instance_label.astype(np.int64)

    # --- hole-free resample of the label grids through T -----------------
    # sem and inst ride ONE back-projection: the instance warp uses the
    # sem bounds (reference semantics), so its grid/backproject pass is
    # identical — stacking the value channels halves the warp cost.
    sem_coords = np.argwhere(sem != 255)
    both = np.stack([sem + 1, inst]).astype(np.float32)
    vals2, new_coords, bnd = transform_scene(sem_coords, T, both)
    nz = vals2[:, 0] != 0
    sem_vals = vals2[nz, 0].astype(np.int64) - 1
    sem_coords_t = new_coords[nz]
    inz = vals2[:, 1] != 0
    inst_vals = vals2[inz, 1].astype(np.int64)
    inst_coords_t = new_coords[inz]

    # --- input points: voxelize then transform coords --------------------
    coords, off_feats = voxelize_points(sample.xyz)
    in_feats = np.concatenate(
        [sample.point_feats.astype(np.float32), off_feats], axis=1
    )
    in_coords = transform(coords, T)

    # --- train-time random 0.8 crop (kitti_dataset.py:463-490) -----------
    if train_crop and len(sem_coords_t):
        mn = sem_coords_t.min(0)
        mx = sem_coords_t.max(0)
        size = (mx - mn) * 0.8
        new_mn = mn + (mx - mn - size) * rng.rand(3)
        new_mx = new_mn + size

        def crop2d(c):
            return (
                (c[:, 0] >= new_mn[0]) & (c[:, 0] < new_mx[0])
                & (c[:, 1] >= new_mn[1]) & (c[:, 1] < new_mx[1])
            )

        keep_in = crop2d(in_coords)
        keep_sem = crop2d(sem_coords_t)
        keep_inst = crop2d(inst_coords_t) if len(inst_coords_t) else np.zeros(0, bool)
        in_coords, in_feats = in_coords[keep_in], in_feats[keep_in]
        sem_coords_t, sem_vals = sem_coords_t[keep_sem], sem_vals[keep_sem]
        inst_coords_t, inst_vals = inst_coords_t[keep_inst], inst_vals[keep_inst]

    # --- bbox rounded to complete_scale (kitti_dataset.py:162-177) -------
    mn = sem_coords_t.min(0) if len(sem_coords_t) else np.zeros(3, np.int64)
    mx = sem_coords_t.max(0) if len(sem_coords_t) else np.zeros(3, np.int64)
    if len(inst_coords_t):
        mn = np.minimum(mn, inst_coords_t.min(0))
        mx = np.maximum(mx, inst_coords_t.max(0))
    min_C = (np.floor(mn / complete_scale) * complete_scale).astype(np.int32)
    max_C = np.ceil(mx).astype(np.int32)
    size = (
        np.ceil((max_C - min_C + 1) / complete_scale) * complete_scale
    ).astype(np.int32)

    # --- dense subnet-frame label grids ----------------------------------
    sem_dense = np.full(tuple(size), 255, np.uint8)
    rel = sem_coords_t - min_C
    sem_dense[rel[:, 0], rel[:, 1], rel[:, 2]] = sem_vals.astype(np.uint8)
    inst_dense = np.zeros(tuple(size), np.int32)
    if len(inst_coords_t):
        rel = inst_coords_t - min_C
        inst_dense[rel[:, 0], rel[:, 1], rel[:, 2]] = inst_vals

    sem_labels, geo_labels = downscale_labels(sem_dense, n_classes)
    mask_labels, mask_id_dense = prepare_mask_targets(
        sem_dense, inst_dense, thing_ids
    )

    return SubnetSample(
        T=np.asarray(T, np.float32),
        min_C=min_C,
        max_C=max_C,
        in_coords=in_coords.astype(np.int32),
        in_feats=in_feats.astype(np.float32),
        semantic_label=sem_dense,
        instance_label=inst_dense,
        sem_labels=sem_labels,
        geo_labels=geo_labels,
        mask_labels=mask_labels,
        mask_id_dense=mask_id_dense,
        semantic_label_origin=sample.semantic_label.astype(np.uint8),
        instance_label_origin=sample.instance_label.astype(np.int32),
    )


@dataclass
class KittiDataset:
    """On-disk SemanticKITTI SSC dataset (reference ``KittiDataset``).

    Expects the reference's preprocessed layout:
    ``<root>/dataset/sequences/<seq>/{velodyne,labels,voxels}``,
    ``<instance_label_root>/<seq>/<frame>_1_1.pkl`` (offline instance
    labels, see :mod:`pasco_tpu.data.label_gen`), and optionally
    ``<preprocess_root>/waffleiron_v2/sequences/<seq>/seg_feats_tta/*.pkl``.
    """

    root: str
    preprocess_root: str = ""
    instance_label_root: str = ""
    split: str = "train"
    n_subnets: int = 1
    data_aug: bool = True
    frame_interval: int = 5
    max_angle: float = 30.0
    scale_range: float = 0.0
    max_translation: Sequence[float] = (0.0, 0.0, 0.0)
    use_waffleiron_feats: bool = True
    # Fuse this many consecutive (every-5th-frame) scans into one input
    # cloud by pose (reference ``load_data_v3``, ``kitti_dataset.py:341-367``
    # with calib/pose parsing ``:492-580``).  1 = no fusion (the released
    # recipe).
    n_fuse_scans: int = 1
    seed: int = 0

    def __post_init__(self):
        self._pose_cache: Dict[str, List[np.ndarray]] = {}
        self.sequences = params.SPLIT_SEQUENCES[self.split]
        self.scans: List[Tuple[str, str]] = []
        for seq in self.sequences:
            vox_dir = os.path.join(self.root, "dataset", "sequences", seq, "voxels")
            if not os.path.isdir(vox_dir):
                continue
            frames = sorted(
                f[:-4] for f in os.listdir(vox_dir) if f.endswith(".bin")
            )
            self.scans += [(seq, f) for f in frames[:: self.frame_interval]]
        self.remap_lut = io_data.get_remap_lut()
        self.rng = np.random.RandomState(self.seed)

    def __len__(self) -> int:
        return len(self.scans)

    def _seq_poses(self, seq: str) -> List[np.ndarray]:
        """Per-scan LiDAR-frame poses of a sequence (lazy, cached; the
        reference eagerly parses all 11 sequences up front,
        ``load_calib_poses``, ``kitti_dataset.py:492-526``)."""
        if seq not in self._pose_cache:
            base = os.path.join(self.root, "dataset", "sequences", seq)
            calib = parse_calibration(os.path.join(base, "calib.txt"))
            self._pose_cache[seq] = parse_poses(
                os.path.join(base, "poses.txt"), calib
            )
        return self._pose_cache[seq]

    def _load_points(self, seq: str, frame: str):
        """(xyz, feats) of one scan in its own LiDAR frame, or None if the
        scan's files are absent."""
        base = os.path.join(self.root, "dataset", "sequences", seq)
        wi_pkl = os.path.join(
            self.preprocess_root,
            "waffleiron_v2/sequences", seq, "seg_feats_tta", f"{frame}.pkl",
        )
        if self.use_waffleiron_feats and os.path.exists(wi_pkl):
            with open(wi_pkl, "rb") as f:
                d = pickle.load(f)
            emb = d["embedding"]
            emb = emb[self.rng.randint(0, emb.shape[0])].T   # [N, 256]
            xyz_i = d["coords"]
            xyz, intensity = xyz_i[:, :3], xyz_i[:, 3:]
            vote = d["vote"]
            radius = np.linalg.norm(xyz, axis=1, keepdims=True)
            return xyz, np.concatenate([vote, intensity, radius, emb], axis=1)
        vel = os.path.join(base, "velodyne", f"{frame}.bin")
        if not os.path.exists(vel):
            return None
        pc = io_data.read_pointcloud(vel)
        xyz, intensity = pc[:, :3], pc[:, 3:4]
        radius = np.linalg.norm(xyz, axis=1, keepdims=True)
        return xyz, np.concatenate([intensity, radius], axis=1)

    def load_scene(self, seq: str, frame: str) -> SceneSample:
        base = os.path.join(self.root, "dataset", "sequences", seq)
        label_pkl = os.path.join(self.instance_label_root, seq, f"{frame}_1_1.pkl")
        if os.path.exists(label_pkl):
            with open(label_pkl, "rb") as f:
                d = pickle.load(f)
            sem = d["semantic_labels"].astype(np.uint8)
            inst = d["instance_labels"].astype(np.int32)
        else:
            sem = io_data.get_label_volume(
                os.path.join(base, "voxels", f"{frame}.label"),
                os.path.join(base, "voxels", f"{frame}.invalid"),
                self.remap_lut,
            )
            inst = np.zeros_like(sem, np.int32)

        loaded = self._load_points(seq, frame)
        if loaded is None:
            raise FileNotFoundError(
                f"no point data for sequence {seq} frame {frame}"
            )
        xyz, feats = loaded

        # Multi-scan fusion by pose (reference ``kitti_dataset.py:341-367``):
        # later scans are re-expressed in scan 0's LiDAR frame and their
        # points concatenated.  Each fused scan contributes its own full
        # feature set (the reference concatenates only xyz/vote and then
        # indexes the un-extended feature arrays — which cannot run; this
        # formulation keeps the fused cloud self-consistent).
        if self.n_fuse_scans > 1:
            poses = self._seq_poses(seq)
            pose0 = poses[int(frame)]
            for fuse_idx in range(1, self.n_fuse_scans):
                number_idx = int(frame) + fuse_idx * 5
                if number_idx >= len(poses):
                    break
                loaded = self._load_points(seq, f"{number_idx:06d}")
                if loaded is None:
                    continue
                add_xyz, add_feats = loaded
                add_xyz = fuse_multi_scan(add_xyz, pose0, poses[number_idx])
                xyz = np.concatenate([xyz, add_xyz], axis=0)
                feats = np.concatenate([feats, add_feats], axis=0)

        keep = np.all(
            (xyz >= params.VOX_ORIGIN[None]) & (xyz < params.MAX_EXTENT[None]),
            axis=1,
        )
        return SceneSample(
            semantic_label=sem,
            instance_label=inst,
            xyz=xyz[keep],
            point_feats=feats[keep],
            frame_id=frame,
            sequence=seq,
        )

    def __getitem__(self, idx: int) -> List[SubnetSample]:
        """n_subnets processed views: distinct random scans at train, the
        same scan with distinct augmentations otherwise
        (``kitti_dataset.py:126-140``)."""
        out = []
        for s in range(self.n_subnets):
            i = idx
            if self.split == "train" and s > 0:
                i = int(self.rng.randint(0, len(self.scans)))
            seq, frame = self.scans[i]
            scene = self.load_scene(seq, frame)
            T = (
                generate_random_transformation(
                    self.rng,
                    max_angle=self.max_angle,
                    scale_range=self.scale_range,
                    max_translation=self.max_translation,
                )
                if self.data_aug
                else None
            )
            out.append(
                process_scene(
                    scene, T, self.rng, train_crop=(self.split == "train")
                )
            )
        return out
