"""Model input/output containers and the network factory (counterpart of
``pasco_tpu/models/unet.py:30-52, 155-162`` and
``pasco_tpu/training/step.py:62-71``)."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from pasco_torch.core.config import PaSCoConfig
from pasco_torch.data.semantic_kitti.collate import CollatedScene
from pasco_torch.core.sparse import SparseGrid


class ModelInput(NamedTuple):
    """One scene, voxelised on the host.  Shapes are static."""

    point_feats: torch.Tensor      # [P, in_ch] f32
    point_coords: torch.Tensor     # [P, 4] int32 (subnet, x, y, z)
    point_mask: torch.Tensor       # [P] bool
    global_min: torch.Tensor       # [3] int32 global bbox (stride-1 units)
    global_max: torch.Tensor       # [3] int32
    subnet_min: torch.Tensor       # [S, 3] int32 per-subnet bboxes
    subnet_max: torch.Tensor       # [S, 3] int32


class ModelOutput(NamedTuple):
    sem_grids: Dict[int, SparseGrid]          # scale -> voxel grid
    sem_logits: Dict[int, torch.Tensor]       # scale -> [cap, S, n_classes]
    panop_grids: Dict[int, SparseGrid]        # scale -> per-subnet [S, cap, ...]
    sem_logits_pruned: torch.Tensor           # [S, cap1, n_classes]
    predictor: Optional[object]               # transformer.PredictorOutput


def scene_to_model_input(scene: CollatedScene, device) -> ModelInput:
    """A host ``CollatedScene`` as tensors on ``device``."""

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype).to(device)

    return ModelInput(
        point_feats=t(scene.point_feats, torch.float32),
        point_coords=t(scene.point_coords, torch.int32),
        point_mask=t(scene.point_mask, torch.bool),
        global_min=t(scene.global_min, torch.int32),
        global_max=t(scene.global_max, torch.int32),
        subnet_min=t(scene.subnet_min, torch.int32),
        subnet_max=t(scene.subnet_max, torch.int32),
    )


def build_net(cfg: PaSCoConfig, device="cuda", process_group=None):
    """The dense-substrate network (the only substrate ported), on
    ``device``: the card unless the caller asks for the CPU
    (``device="cpu"``); without a card the default raises.  With a
    ``torch.distributed`` ``process_group`` its training-mode BatchNorms
    reduce their statistics over the group's ranks (SyncBN, the
    reference's ``build_net(cfg, axis_name=)``); off by default."""
    if cfg.model.substrate != "dense":
        raise NotImplementedError(
            "the sparse substrate is not ported (ROADMAP.md, queue 1)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_net: no CUDA device; pass device='cpu' for the CPU")
    from pasco_torch.models.dense_unet import DensePaSCoNet
    from pasco_torch.models.norm import set_process_group

    net = DensePaSCoNet(cfg).to(device)
    set_process_group(net, process_group)
    return net
