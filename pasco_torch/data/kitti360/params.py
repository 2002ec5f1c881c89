"""SSCBench-KITTI360 dataset constants (reference
``pasco/data/kitti360/params.py``): 19 classes (0 = empty), thing classes
1..6, per-scale voxel class frequencies."""

import numpy as np

THING_IDS = (1, 2, 3, 4, 5, 6)
N_CLASSES = 19

CLASS_NAMES = [
    "empty",
    "car",
    "bicycle",
    "motorcycle",
    "truck",
    "other-vehicle",
    "person",
    "road",
    "parking",
    "sidewalk",
    "other-ground",
    "building",
    "fence",
    "vegetation",
    "terrain",
    "pole",
    "traffic-sign",
    "other-structure",
    "other-object",
]

CLASS_FREQUENCIES = {
    1: np.array([
        2264087502, 20098728, 104972, 96297, 1149426, 4051087, 125103,
        105540713, 16292249, 45297267, 14454132, 110397082, 6766219,
        295883213, 50037503, 1561069, 406330, 30516166, 1950115,
    ]),
    2: np.array([
        1648700309, 4738149, 25988, 24313, 280462, 984297, 33727, 24807231,
        4309489, 10693629, 4025486, 29825455, 1648037, 77637495, 12865639,
        443676, 116094, 7184544, 481844,
    ]),
    4: np.array([
        180561625, 1095918, 6042, 6084, 66599, 238732, 9490, 5895526,
        1105257, 2618018, 1076064, 7925164, 397552, 18942509, 3306364,
        135436, 39270, 1804354, 131580,
    ]),
}

# Train/val/test drives (kitti360_dataset.py:62-68).
SPLIT_DRIVES = {
    "train": [
        "2013_05_28_drive_0004_sync", "2013_05_28_drive_0000_sync",
        "2013_05_28_drive_0010_sync", "2013_05_28_drive_0002_sync",
        "2013_05_28_drive_0003_sync", "2013_05_28_drive_0005_sync",
        "2013_05_28_drive_0007_sync",
    ],
    "val": ["2013_05_28_drive_0006_sync"],
    "test": ["2013_05_28_drive_0009_sync"],
}
