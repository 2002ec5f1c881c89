"""Checkpoint save and restore with a config snapshot (counterpart of
``pasco_tpu/training/checkpoint.py:32-98``, with ``torch.save`` in place of
Orbax).

A checkpoint ``ckpt_<step>.pt`` holds the net's ``state_dict``, the
optimizer's state (update count and both moments), the state's step, the
config as JSON and the monitored metrics.  The manager keeps the ``max_to_keep`` best
by ``metrics["monitor"]`` (greater is better, like the reference's
``pq_dagger_all``, ``scripts/train.py:180-189``) and always the latest.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

import torch

from pasco_torch.core.config import PaSCoConfig
from pasco_torch.training.step import TrainState

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _config_json(cfg: PaSCoConfig) -> str:
    return json.dumps(cfg.to_dict(), indent=2, default=str)


class CheckpointManager:
    """Top-k + last checkpoint manager over one directory."""

    def __init__(self, directory: str, cfg: Optional[PaSCoConfig] = None,
                 max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        if cfg is not None:
            with open(os.path.join(self.directory, "config.json"), "w") as f:
                f.write(_config_json(cfg))

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, metrics: Optional[Dict] = None) -> None:
        opt = state.opt
        blob = {
            "step": int(state.step),
            "net": state.net.state_dict(),
            "opt": {"count": opt.count, "mu": opt.mu, "nu": opt.nu},
            "config": _config_json(state.net.cfg),
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        }
        tmp = self._path(step) + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, self._path(step))
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        if len(steps) <= self.max_to_keep:
            return
        # mmap: only the small metrics entry is read, not the tensors
        monitor = {s: torch.load(self._path(s), map_location="cpu", weights_only=False,
                                 mmap=True)["metrics"].get("monitor", 0.0) for s in steps}
        best = sorted(steps, key=lambda s: (monitor[s], s), reverse=True)[: self.max_to_keep]
        for s in steps:
            if s not in best and s != steps[-1]:
                os.remove(self._path(s))

    def wait(self) -> None:
        """Saves are synchronous; kept for the reference's interface."""

    def restore(self, state_like: TrainState, step: Optional[int] = None) -> Optional[TrainState]:
        """Load checkpoint ``step`` (the latest by default) into
        ``state_like`` (net with ``strict=True``, optimizer, step) and
        return it; ``None`` where the directory holds no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        dev = next(state_like.net.parameters()).device
        blob = torch.load(self._path(step), map_location=dev, weights_only=False)
        state_like.net.load_state_dict(blob["net"], strict=True)
        opt = state_like.opt
        opt.count = blob["opt"]["count"]
        for name in ("mu", "nu"):
            have, got = getattr(opt, name), blob["opt"][name]
            if set(have) != set(got):
                raise KeyError(f"checkpoint {step}: optimizer {name} keys differ")
            for k in have:
                have[k] = got[k].to(dev)
        state_like.step = blob["step"]
        return state_like


def load_config(directory: str) -> Dict[str, Any]:
    with open(os.path.join(directory, "config.json")) as f:
        return json.load(f)
