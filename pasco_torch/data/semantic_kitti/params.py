"""SemanticKITTI SSC dataset constants.

Numeric tables from the reference (``pasco/data/semantic_kitti/params.py``):
20 classes (0 = empty), thing classes 1..8, and per-scale voxel class
frequencies used for completion loss weights and the training-time
occupancy sampling.
"""

import numpy as np

THING_IDS = (1, 2, 3, 4, 5, 6, 7, 8)

CLASS_NAMES = [
    "empty",
    "car",
    "bicycle",
    "motorcycle",
    "truck",
    "other-vehicle",
    "person",
    "bicyclist",
    "motorcyclist",
    "road",
    "parking",
    "sidewalk",
    "other-ground",
    "building",
    "fence",
    "vegetation",
    "trunk",
    "terrain",
    "pole",
    "traffic-sign",
]

CLASS_FREQUENCIES = {
    1: np.array([
        5.4226e09, 1.5640e07, 1.1710e05, 1.1879e05, 6.0278e05, 8.3570e05,
        2.6682e05, 2.6566e05, 1.6459e05, 6.1145e07, 4.2558e06, 4.4079e07,
        2.5098e06, 5.6889e07, 1.5568e07, 1.5888e08, 2.0582e06, 3.7056e07,
        1.1631e06, 3.3958e05,
    ]),
    2: np.array([
        2.2871e08, 3.8447e06, 2.7456e04, 2.7629e04, 1.3372e05, 2.0355e05,
        6.0825e04, 6.4621e04, 4.5209e04, 1.3355e07, 9.3588e05, 1.0121e07,
        6.4508e05, 1.4682e07, 3.4279e06, 3.7339e07, 4.9653e05, 8.3823e06,
        3.1972e05, 9.3521e04,
    ]),
    4: np.array([
        2.1103e07, 8.5094e05, 5.5210e03, 6.3270e03, 2.8673e04, 4.5410e04,
        1.4061e04, 1.4023e04, 1.0599e04, 2.8025e06, 2.0268e05, 2.2306e06,
        1.6008e05, 3.9068e06, 7.5475e05, 8.5634e06, 1.2573e05, 1.9244e06,
        9.7388e04, 3.0642e04,
    ]),
}

N_CLASSES = 20

# Canonical SSC volume (kitti_dataset.py:86-89).
SCENE_SIZE = (256, 256, 32)
VOXEL_SIZE = 0.2
VOX_ORIGIN = np.array([0.0, -25.6, -2.0])
MAX_EXTENT = np.array([51.2, 25.6, 4.4])

# Train/val split sequences (kitti_dataset.py:65-82).
SPLIT_SEQUENCES = {
    "train": ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"],
    "val": ["08"],
    "test": ["11", "12", "13", "14", "15", "16", "17", "18", "19", "20", "21"],
}
