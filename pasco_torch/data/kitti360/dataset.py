"""SSCBench-KITTI360 dataset.

Config-driven variant of the SemanticKITTI pipeline (the reference clones
the whole dataset class, ``pasco/data/kitti360/kitti360_dataset.py``; here
the shared processing lives in
:mod:`pasco_torch.data.semantic_kitti.dataset` and only the on-disk layout
and raw 8-channel point features differ: intensity + radius + voxel-offset
xyz + xyz, no WaffleIron embedding — reference
``kitti360_dataset.py:296-356``, ``net_panoptic_sparse_kitti360.py:27-90``).

On-disk layout (matching the SSCBench-KITTI360 release the reference
consumes, ``kitti360_dataset.py:80-103,287-297``):

* SSC labels:  ``<label_root>/<drive>/<frame>_1_1.npy`` (6-digit SSCBench
  frame ids, train-id label volumes) — these files enumerate the scans.
* instances:   ``<instance_label_root>/<drive>/<frame>_1_1.pkl`` (offline
  floodfill output, :mod:`pasco_torch.data.label_gen`).
* raw points:  ``<root>/data_3d_raw/<drive>/velodyne_points/data/
  <original_id>.bin`` where the 10-digit raw-drive ``original_id`` comes
  from the ``kitti_360_match.txt`` table shipped with the reference /
  SSCBench release (``get_match_id``, ``kitti360_dataset.py:585-615``) —
  SSCBench renumbers frames, so the raw scan CANNOT be read by the label's
  frame id.
"""

from __future__ import annotations

import glob
import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from pasco_torch.data.kitti360 import params
from pasco_torch.data.semantic_kitti import io_data
from pasco_torch.data.semantic_kitti import params as sk_params
from pasco_torch.data.semantic_kitti.dataset import (
    SceneSample,
    SubnetSample,
    process_scene,
)
from pasco_torch.data.transform_utils import generate_random_transformation


def parse_match_file(path: str) -> Dict[str, Dict[str, str]]:
    """``kitti_360_match.txt`` -> {drive: {sscbench_frame: raw_frame}}.

    Line format ``<drive> <raw_id>.png <sscbench_id>.png`` (reference
    ``get_match_id``, ``kitti360_dataset.py:585-615``).
    """
    table: Dict[str, Dict[str, str]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 3:
                continue
            drive, raw_id, ssc_id = parts
            raw_id = raw_id.rsplit(".", 1)[0]
            ssc_id = ssc_id.rsplit(".", 1)[0]
            table.setdefault(drive, {})[ssc_id] = raw_id
    return table


@dataclass
class Kitti360Dataset:
    """SSCBench-KITTI360: drives as splits, raw velodyne input."""

    root: str
    label_root: str = ""             # SSCBench *_1_1.npy volumes
    instance_label_root: str = ""
    match_file: str = ""             # kitti_360_match.txt (raw-id mapping)
    split: str = "train"
    n_subnets: int = 1
    data_aug: bool = True
    frame_interval: int = 5
    max_angle: float = 30.0
    scale_range: float = 0.0
    max_translation: Sequence[float] = (0.0, 0.0, 0.0)
    seed: int = 0

    def __post_init__(self):
        self.drives = params.SPLIT_DRIVES[self.split]
        self._match: Dict[str, Dict[str, str]] = {}
        match_path = self.match_file
        if not match_path:
            for cand_root in (self.label_root, self.root):
                cand = os.path.join(cand_root, "kitti_360_match.txt")
                if cand_root and os.path.exists(cand):
                    match_path = cand
                    break
        if match_path and os.path.exists(match_path):
            self._match = parse_match_file(match_path)

        # Scans enumerate from the SSCBench label volumes when a label root
        # is given (reference ``kitti360_dataset.py:80-103``); otherwise
        # fall back to a SemanticKITTI-style voxels directory.
        self.scans: List[Tuple[str, str, str]] = []  # (drive, frame, raw_id)
        for drive in self.drives:
            if self.label_root:
                pat = os.path.join(self.label_root, drive, "*_1_1.npy")
                frames = sorted(
                    os.path.basename(p)[:6] for p in glob.glob(pat)
                )
                self.scans += [
                    (drive, f, self._match.get(drive, {}).get(f, f))
                    for f in frames[:: self.frame_interval]
                ]
                continue
            vox_dir = os.path.join(self.root, "data_2d_raw", drive, "voxels")
            if not os.path.isdir(vox_dir):
                continue
            frames = sorted(
                f[:-4] for f in os.listdir(vox_dir) if f.endswith(".bin")
            )
            self.scans += [
                (drive, f, self._match.get(drive, {}).get(f, f))
                for f in frames[:: self.frame_interval]
            ]
        self.rng = np.random.RandomState(self.seed)

    def __len__(self) -> int:
        return len(self.scans)

    def load_scene(self, drive: str, frame: str, raw_id: str = "") -> SceneSample:
        raw_id = raw_id or self._match.get(drive, {}).get(frame, frame)
        label_pkl = os.path.join(
            self.instance_label_root, drive, f"{frame}_1_1.pkl"
        )
        label_npy = (
            os.path.join(self.label_root, drive, f"{frame}_1_1.npy")
            if self.label_root
            else ""
        )
        if os.path.exists(label_pkl):
            with open(label_pkl, "rb") as f:
                d = pickle.load(f)
            sem = d["semantic_labels"].astype(np.uint8)
            inst = d["instance_labels"].astype(np.int32)
        elif label_npy and os.path.exists(label_npy):
            sem = np.load(label_npy).astype(np.uint8).reshape(256, 256, 32)
            inst = np.zeros_like(sem, np.int32)
        else:
            base = os.path.join(self.root, "data_2d_raw", drive)
            sem = io_data.get_label_volume(
                os.path.join(base, "voxels", f"{frame}.label"),
                os.path.join(base, "voxels", f"{frame}.invalid"),
                np.arange(2**16, dtype=np.int32),  # labels already train ids
            )
            inst = np.zeros_like(sem, np.int32)

        # Raw scan by ORIGINAL id (SSCBench renumbers frames; reference
        # ``kitti360_dataset.py:296``).
        pc_path = os.path.join(
            self.root, "data_3d_raw", drive, "velodyne_points", "data",
            f"{int(raw_id):010d}.bin",
        )
        if not os.path.exists(pc_path):
            # legacy/synthetic layout fallback
            pc_path = os.path.join(
                self.root, "data_2d_raw", drive, "velodyne_points", "data",
                f"{frame}.bin",
            )
        pc = io_data.read_pointcloud(pc_path)
        xyz, intensity = pc[:, :3], pc[:, 3:4]
        radius = np.linalg.norm(xyz, axis=1, keepdims=True)
        feats = np.concatenate([intensity, radius], axis=1)
        keep = np.all(
            (xyz >= sk_params.VOX_ORIGIN[None]) & (xyz < sk_params.MAX_EXTENT[None]),
            axis=1,
        )
        return SceneSample(
            semantic_label=sem,
            instance_label=inst,
            xyz=xyz[keep],
            point_feats=feats[keep],
            frame_id=frame,
            sequence=drive,
        )

    def __getitem__(self, idx: int) -> List[SubnetSample]:
        out = []
        for s in range(self.n_subnets):
            i = idx
            if self.split == "train" and s > 0:
                i = int(self.rng.randint(0, len(self.scans)))
            drive, frame, raw_id = self.scans[i]
            scene = self.load_scene(drive, frame, raw_id)
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
                    scene,
                    T,
                    self.rng,
                    n_classes=params.N_CLASSES,
                    thing_ids=params.THING_IDS,
                    train_crop=(self.split == "train"),
                )
            )
        return out
