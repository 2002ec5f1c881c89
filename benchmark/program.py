"""The benchmark's one boundary with the program under test, the PyTorch
port ``pasco_torch``: its configuration built from a configuration file,
its network with the benchmark's weights, its entry for a scan
(``AdaptiveForward`` at ``pick_box``'s box), the copy of a scan's
outputs to the host, and the attention masks the judged scans add."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


def program_config(cfg: dict):
    """``pasco_torch.core.config.PaSCoConfig`` of a configuration file
    (lists become tuples; keys that are no field, such as ``assumed``,
    are left out)."""
    from pasco_torch.core import config as C

    def build(cls, d):
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            sub = {"transformer": C.TransformerConfig, "model": C.ModelConfig,
                   "scene": C.SceneConfig, "capacity": C.CapacityConfig,
                   "loss": C.LossConfig, "optim": C.OptimConfig,
                   "inference": C.InferenceConfig}.get(f.name)
            if sub is not None:
                v = build(sub, v)
            elif isinstance(v, list):
                v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
            kw[f.name] = v
        return cls(**kw)

    return build(C.PaSCoConfig, cfg)


def parameter_shapes(cfg: dict) -> Dict[str, tuple]:
    """Name -> shape of every parameter of the network, without building
    it anywhere but on the meta device."""
    from pasco_torch.models.dense_unet import DensePaSCoNet

    with torch.device("meta"):
        net = DensePaSCoNet(program_config(cfg))
    return {n: tuple(p.shape) for n, p in net.named_parameters()}


def build_forward(cfg: dict, weights: Dict[str, torch.Tensor], device):
    """The program's network (``models/unet.py:build_net``) built on
    ``device`` in inference mode, with ``weights`` copied in, behind
    ``inference/dispatch.py:AdaptiveForward``."""
    from pasco_torch.inference.dispatch import AdaptiveForward
    from pasco_torch.models.unet import build_net

    from benchmark.weights import load_into

    with torch.device(device):
        net = build_net(program_config(cfg), device)
    load_into(net, weights)
    net.eval()
    return AdaptiveForward(net)


def pick_box(fwd, scan: Dict[str, np.ndarray]):
    """The program's box for a host scan (``dispatch.pick_box``)."""
    from pasco_torch.inference.dispatch import pick_box as pick

    return pick(fwd.cands, scan["global_min"], scan["global_max"])


def model_input(scan: Dict[str, np.ndarray], device):
    """A host scan as the program's ``ModelInput`` on ``device``."""
    from pasco_torch.models.unet import ModelInput

    dtypes = dict(point_feats=torch.float32, point_mask=torch.bool)
    return ModelInput(**{k: torch.as_tensor(scan[k], dtype=dtypes.get(k, torch.int32)).to(device)
                         for k in ModelInput._fields})


def host_outputs(out) -> Dict[str, torch.Tensor]:
    """What the host stages read of one scan's ``ModelOutput`` (still on
    the device): the kept cells and their validity at every scale, the
    scale-1 semantic logits, the panoptic cells of every scale and subnet,
    the query class logits and the voxel mask logits."""
    host = {}
    for s, g in out.sem_grids.items():
        host[f"sem{s}.coords"] = g.coords
        host[f"sem{s}.mask"] = g.mask
    host["sem1.logits"] = out.sem_logits[1]
    for s, g in out.panop_grids.items():
        host[f"panop{s}.coords"] = g.coords
        host[f"panop{s}.mask"] = g.mask
    host["query_logits"] = out.predictor.query_logits
    host["mask_logits"] = out.predictor.voxel_logits
    return host


def attention_masks(out) -> Dict[str, torch.Tensor]:
    """The attention decisions of one scan's transformer (still on the
    device), for the reference to follow: ``attn [rounds, S, cap1, Q]``,
    where scale-1 cell n let query q attend in each round, before the
    round's downscale, as ``models/transformer.py:downscale_attn_allowed``
    decides it from the round's mask logits (``predictor.aux``)."""
    return {"attn": torch.stack([torch.sigmoid(m) > 0.5 for _, m in out.predictor.aux])}
