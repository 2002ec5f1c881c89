"""Output converters (reference ``pasco/utils/converter.py``): split a
panoptic id volume into semantic / instance volumes and back; the port's
copy of ``pasco_tpu/utils/converter.py``."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def panoptic_to_semantic_instance(
    panoptic_seg: np.ndarray,
    segments_info: List[dict],
    thing_ids: Sequence[int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (semantic [X,Y,Z], instance [X,Y,Z]); stuff voxels get
    instance 0."""
    semantic = np.zeros_like(panoptic_seg, dtype=np.int32)
    instance = np.zeros_like(panoptic_seg, dtype=np.int32)
    next_instance = 0
    for seg in segments_info:
        m = panoptic_seg == seg["id"]
        semantic[m] = seg["category_id"]
        if seg["category_id"] in thing_ids:
            next_instance += 1
            instance[m] = next_instance
    return semantic, instance


def semantic_instance_to_panoptic(
    semantic: np.ndarray,
    instance: np.ndarray,
    thing_ids: Sequence[int],
) -> Tuple[np.ndarray, List[dict]]:
    """Inverse: build panoptic ids (stuff merged per class)."""
    pan = np.zeros_like(semantic, dtype=np.int32)
    segments: List[dict] = []
    current = 0
    for cls in np.unique(semantic):
        cls = int(cls)
        if cls in (0, 255):
            continue
        cls_mask = semantic == cls
        if cls in thing_ids:
            for iid in np.unique(instance[cls_mask]):
                if iid == 0:
                    continue
                current += 1
                m = cls_mask & (instance == iid)
                pan[m] = current
                segments.append(
                    {
                        "id": current,
                        "isthing": True,
                        "category_id": cls,
                        "area": int(m.sum()),
                    }
                )
        else:
            current += 1
            pan[cls_mask] = current
            segments.append(
                {
                    "id": current,
                    "isthing": False,
                    "category_id": cls,
                    "area": int(cls_mask.sum()),
                }
            )
    return pan, segments
