"""What the port's evaluation CLIs share (``scripts_torch/{eval,eval_robo3d,
save_outputs_panoptic}.py``, counterparts of the ``scripts_tpu`` scripts of
the same names): the config presets, the weights (a released reference
``.ckpt`` or a :class:`~pasco_torch.training.checkpoint.CheckpointManager`
directory), and the loop that runs each scan of a dataset through
:class:`~pasco_torch.inference.dispatch.AdaptiveForward`,
``run_scene_inference`` and the ``Evaluator``."""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from pasco_torch.core.config import PaSCoConfig, flagship_narrow_config, tiny_config
from pasco_torch.data.semantic_kitti.collate import collate
from pasco_torch.data.semantic_kitti.params import CLASS_FREQUENCIES
from pasco_torch.inference.dispatch import AdaptiveForward, pick_box
from pasco_torch.inference.pipeline import Evaluator, run_scene_inference
from pasco_torch.models.unet import build_net, scene_to_model_input
from pasco_torch.training import step as tstep

PRESETS = ("flagship", "flagship_narrow", "tiny")


def eval_config(preset: str, n_infers: int) -> PaSCoConfig:
    """The preset at ``n_infers``.  The smoke presets keep their small
    working boxes but take the canonical (256, 256, 32) scene size: the
    on-disk labels live in that frame (reference ``kitti_dataset.py:86-89``),
    and another size would mis-frame the ensembling warp and the
    ``Evaluator``'s comparison."""
    if preset == "flagship":
        base = PaSCoConfig()
    else:
        base = (flagship_narrow_config if preset == "flagship_narrow" else tiny_config)(
            n_infers=n_infers)
        base = base.replace(scene=dataclasses.replace(base.scene, scene_size=(256, 256, 32)))
    return base.replace(model=dataclasses.replace(base.model, n_infers=n_infers))


def fit_in_channels(cfg: PaSCoConfig, preset: str, feat_dim: int) -> PaSCoConfig:
    """Smoke presets take the on-disk feature width (raw velodyne 8,
    WaffleIron 283); the flagship must match its checkpoint instead."""
    if feat_dim != cfg.model.in_channels and preset != "flagship":
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, in_channels=feat_dim))
    return cfg


def load_net(cfg: PaSCoConfig, device, torch_ckpt: str = "",
             model_path: str = "") -> torch.nn.Module:
    """The net on ``device`` with the weights of ``torch_ckpt`` (a released
    reference ``.ckpt``, converted on the fly) or of the latest checkpoint
    in ``model_path``; a directory without one leaves the seeded random
    init (seed 0), as the reference CLI does."""
    from pasco_torch.training.checkpoint import CheckpointManager
    from pasco_torch.training.convert_torch import load_reference_ckpt, load_reference_into

    net = build_net(cfg, device)
    net.reset_parameters(torch.Generator().manual_seed(0))
    if torch_ckpt:
        unmatched = load_reference_into(net, load_reference_ckpt(torch_ckpt))
        if unmatched:
            print(f"warning: {len(unmatched)} unconverted reference keys "
                  f"(first 5: {unmatched[:5]})", file=sys.stderr)
    elif model_path:
        CheckpointManager(model_path).restore(tstep.create_train_state(net, cfg))
    net.eval()
    return net


def adaptive_forward(cfg: PaSCoConfig, net, class_frequencies=None) -> AdaptiveForward:
    """The net behind the box ladder, with the label weights of
    ``class_frequencies`` (SemanticKITTI's by default)."""
    dev = next(net.parameters()).device
    lw = {s: torch.as_tensor(v, device=dev) for s, v in tstep.labelweights_for(
        cfg, CLASS_FREQUENCIES if class_frequencies is None else class_frequencies).items()}
    return AdaptiveForward(net, lw)


def scene_results(fwd: AdaptiveForward, scene, cfg: PaSCoConfig) -> Dict[str, object]:
    """One collated scene through the forward at its box (taken from the
    host scene, so no call waits for the card) and the host pipeline."""
    dev = next(fwd.net.parameters()).device
    box = pick_box(fwd.cands, scene.global_min, scene.global_max)
    return run_scene_inference(lambda inp: fwd(inp, box), scene_to_model_input(scene, dev),
                               scene, cfg)


def evaluate(ds, cfg: PaSCoConfig, fwd: AdaptiveForward, limit: Optional[int] = None,
             progress: Optional[Callable[[int, int], None]] = None):
    """Every scan of ``ds`` (the first ``limit``) scored by the
    ``Evaluator``; returns (summary, forward seconds per scan, ensembling
    seconds per scan)."""
    evaluator = Evaluator(cfg)
    inf_times: List[float] = []
    ens_times: List[float] = []
    n = len(ds) if not limit else min(len(ds), limit)
    for i in range(n):
        scene = collate(ds[i], cfg)
        results = scene_results(fwd, scene, cfg)
        inf_times.append(results["inference_time"])
        ens_times.append(results["ensemble_time"])
        evaluator.add_scene(results, scene.semantic_label_origin, scene.instance_label_origin)
        if progress is not None:
            progress(i + 1, n)
    return evaluator.summary(), inf_times, ens_times


def mean_after_first(xs: List[float]) -> float:
    """Mean time per scan without the first (warm-up) scan."""
    return float(np.mean(xs[1:])) if len(xs) > 1 else 0.0
