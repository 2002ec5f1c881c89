"""Timing and profiling helpers (counterpart of
``pasco_tpu/utils/timing.py``): wall-clock timers that synchronise the
card before they read the clock, as the reference's manual
``torch.cuda.synchronize`` timing does (``net_panoptic_sparse.py:228-250``),
``torch.profiler`` traces, and the card's live memory."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def _sync(result) -> None:
    """Wait for the card that holds any tensor of ``result`` (a tensor, or
    a list, tuple or dict of them)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _sync(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _sync(v)


class Timer:
    """Accumulates wall-clock timings per named region."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def time(self, name: str, result=None):
        """Time the block; ``result`` (tensors, or a list or dict the block
        fills) is synchronised before the clock is read."""
        t0 = time.perf_counter()
        yield
        _sync(result)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self.times.setdefault(name, []).append(seconds)

    def mean(self, name: str, skip_first: bool = True) -> float:
        xs = self.times.get(name, [])
        if skip_first and len(xs) > 1:
            xs = xs[1:]
        return sum(xs) / len(xs) if xs else 0.0

    def summary(self) -> Dict[str, float]:
        return {k: self.mean(k) for k in self.times}


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block (host and, where there is a card,
    device activity); writes a Chrome trace to ``log_dir/trace.json``."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats() -> Dict[str, float]:
    """Live memory of the caching allocator per card, in MiB (none without
    a card)."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_allocated(i) / (1024 * 1024)
            for i in range(torch.cuda.device_count())}


def set_random_seed(seed: int) -> torch.Generator:
    """Seed NumPy and torch (reference ``torch_util.py:19-32``); returns a
    CPU generator seeded with ``seed`` for explicit draws."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
