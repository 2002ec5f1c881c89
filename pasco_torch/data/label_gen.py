"""Offline instance-label generation (26-connected floodfill per class);
the port's copy of ``pasco_tpu/data/label_gen.py``.

Native-accelerated re-implementation of the reference label generator
(``label_gen/gen_instance_labels.py:44-149``): for every thing class, run
26-connected components over its voxels; instances smaller than
``min_instance_size`` (8) voxels are removed and their voxels marked
unknown (255).  The reference's pure-Python BFS takes ~10 h for
SemanticKITTI on 10 processes (README.md:206); the C++ kernel in
``pasco_torch/native/floodfill.cpp`` does a scan in well under a millisecond,
so a plain multiprocessing pool covers both datasets in minutes.
"""

from __future__ import annotations

import os
import pickle
from multiprocessing import Pool
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from pasco_torch import native
from pasco_torch.data.semantic_kitti import io_data, params


def generate_instance_labels(
    semantic_label: np.ndarray,
    thing_ids: Sequence[int] = params.THING_IDS,
    min_instance_size: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """(instance_labels int32, cleaned semantic labels uint8).

    Instance ids are global (unique across classes), starting at 1.
    """
    sem = semantic_label.copy()
    inst = np.zeros(sem.shape, np.int32)
    next_id = 0
    for cls in thing_ids:
        mask = sem == cls
        if not mask.any():
            continue
        labels, n = native.connected_components_26(mask)
        if n == 0:
            continue
        sizes = np.bincount(labels.reshape(-1), minlength=n + 1)
        for comp in range(1, n + 1):
            comp_mask = labels == comp
            if sizes[comp] < min_instance_size:
                sem[comp_mask] = 255
                continue
            next_id += 1
            inst[comp_mask] = next_id
    return inst, sem.astype(np.uint8)


def _process_one(args) -> str:
    label_path, invalid_path, out_path, remap = args
    sem = io_data.get_label_volume(label_path, invalid_path, remap)
    inst, sem_clean = generate_instance_labels(sem)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(
            {"semantic_labels": sem_clean, "instance_labels": inst}, f
        )
    return out_path


def generate_all(
    root: str,
    out_root: str,
    sequences: Iterable[str],
    n_processes: int = 8,
    frame_interval: int = 5,
) -> List[str]:
    """Batch generation over a SemanticKITTI layout (the reference drives
    this through DataLoader workers; a Pool is the honest version)."""
    remap = io_data.get_remap_lut()
    jobs = []
    for seq in sequences:
        vox = os.path.join(root, "dataset", "sequences", seq, "voxels")
        if not os.path.isdir(vox):
            continue
        frames = sorted(f[:-6] for f in os.listdir(vox) if f.endswith(".label"))
        for frame in frames[::frame_interval]:
            jobs.append(
                (
                    os.path.join(vox, f"{frame}.label"),
                    os.path.join(vox, f"{frame}.invalid"),
                    os.path.join(out_root, seq, f"{frame}_1_1.pkl"),
                    remap,
                )
            )
    if n_processes <= 1:
        return [_process_one(j) for j in jobs]
    with Pool(n_processes) as pool:
        return pool.map(_process_one, jobs)
