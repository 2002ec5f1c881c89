"""SemanticKITTI on-disk format helpers.

NumPy re-implementation of the reference IO layer
(``pasco/data/semantic_kitti/io_data.py``): bit-packed ``.bin``/``.invalid``
voxel volumes, ``.label`` files, and the class remap LUT derived from
``semantic-kitti.yaml``'s ``learning_map`` (0 stays empty, unlabeled/missing
classes map to 255 = invalid).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

try:
    import yaml
except Exception:  # pragma: no cover
    yaml = None

# semantic-kitti.yaml learning_map, inlined so the pipeline works without
# the YAML file (values are the public SemanticKITTI mapping).
LEARNING_MAP: Dict[int, int] = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}

LEARNING_MAP_INV: Dict[int, int] = {
    0: 0, 1: 10, 2: 11, 3: 15, 4: 18, 5: 20, 6: 30, 7: 31, 8: 32, 9: 40,
    10: 44, 11: 48, 12: 49, 13: 50, 14: 51, 15: 70, 16: 71, 17: 72,
    18: 80, 19: 81,
}


def unpack(compressed: np.ndarray) -> np.ndarray:
    """Bit-packed voxel grid -> uint8 {0,1} array (reference ``:11-24``)."""
    compressed = np.asarray(compressed, np.uint8)
    bits = np.unpackbits(compressed)
    return bits.astype(np.uint8)


def pack(array: np.ndarray) -> np.ndarray:
    """{0,1} array -> bit-packed uint8 (reference ``:34-44``)."""
    return np.packbits(np.asarray(array).reshape(-1).astype(np.uint8))


def get_remap_lut(config_path: Optional[str] = None) -> np.ndarray:
    """Class remap LUT (reference ``_get_remap_lut``, ``:80-99``): raw label
    -> train id; raw 0 stays 0 (empty); classes mapping to 0 become 255."""
    mapping = LEARNING_MAP
    if config_path and yaml is not None and os.path.exists(config_path):
        cfg = yaml.safe_load(open(config_path))
        mapping = cfg["learning_map"]
    maxkey = max(mapping.keys())
    lut = np.zeros((maxkey + 100,), dtype=np.int32)
    lut[list(mapping.keys())] = list(mapping.values())
    lut[lut == 0] = 255
    lut[0] = 0
    return lut


def get_inv_map() -> np.ndarray:
    inv = np.zeros(20, dtype=np.int32)
    inv[list(LEARNING_MAP_INV.keys())] = list(LEARNING_MAP_INV.values())
    return inv


def read_label(path: str) -> np.ndarray:
    """Voxel label volume: uint16 per voxel (reference
    ``_read_label_SemKITTI``)."""
    return np.fromfile(path, dtype=np.uint16).astype(np.float32)


def read_invalid(path: str) -> np.ndarray:
    """Bit-packed invalid mask (reference ``_read_invalid_SemKITTI``)."""
    return unpack(np.fromfile(path, dtype=np.uint8))


def read_occupancy(path: str) -> np.ndarray:
    return unpack(np.fromfile(path, dtype=np.uint8)).astype(np.float32)


def read_pointcloud(path: str) -> np.ndarray:
    """Velodyne scan: [N, 4] float32 (x, y, z, intensity)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def read_point_label(path: str) -> np.ndarray:
    """Per-point .label file; lower 16 bits = semantic, upper = instance."""
    return np.fromfile(path, dtype=np.int32).reshape(-1)


def get_label_volume(
    label_path: str, invalid_path: str, remap_lut: np.ndarray,
    scene_size=(256, 256, 32),
) -> np.ndarray:
    """Voxel GT volume remapped to train ids; invalid voxels -> 255
    (reference ``get_label``, ``kitti_dataset.py:669-705``)."""
    label = read_label(label_path)
    invalid = read_invalid(invalid_path)
    label = remap_lut[label.astype(np.uint16)].astype(np.float32)
    label[np.isclose(invalid, 1)] = 255
    return label.reshape(scene_size).astype(np.uint8)
