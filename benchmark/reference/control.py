"""The control of the comparison: the reference computed in the nearest
precision below the configuration's bfloat16, float8 (e4m3) with one scale
per tensor, wherever the program rounds to bfloat16.  Put in the
program's place, it has to come out as not correct."""

from __future__ import annotations

import torch

FP8_MAX = 448.0   # the largest finite float8_e4m3fn


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to the format's largest, back in float32."""
    amax = x.detach().abs().max()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale
