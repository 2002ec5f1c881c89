"""Seeded random weights, made on the card in one draw.

The families follow the flax initialisers the model was written for, with
a uniform draw of the same variance in place of each normal one, so that
one ``torch.rand`` call on the card fills every random leaf:

* 3-D conv kernels ``[..., taps, Ci, Co]``: uniform(+-sqrt(1 / (taps * Ci)));
* the bottleneck's 5-D kernels ``[kx, ky, kz, Ci, Co]``: variance scaling
  (2, fan_in, uniform), +-sqrt(6 / (kx * ky * kz * Ci));
* dense layers ``[out, in]``: lecun normal's variance 1 / in;
* the semantic heads ``[S, ch, K]``: variance 1 / (S * ch), but class 0
  ("empty") reads nothing: its column is 0, as is every bias, so its logit
  is 0.  The head reads relu'd features, so a cell is dropped only where
  every other class's logit is at most 0 (about 2^-(K-1) of cells with any
  feature): the decoder keeps every cell its masks and caps allow, on every
  seed.  Where "empty" read a random column, the seed decided how many cells
  were kept and so how much work a scan is;
* the queries: variance 1;
* every bias 0, BatchNorm and LayerNorm scales 1 (BatchNorm's running
  statistics stay at mean 0 and variance 1, as built).
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _bound(name: str, shape) -> float:
    """Half-width of the uniform draw of a random leaf."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "kernel" and len(shape) == 5:
        kx, ky, kz, ci, _ = shape
        return math.sqrt(6.0 / (kx * ky * kz * ci))
    if leaf in ("kernel", "up_kernel"):
        return math.sqrt(1.0 / (shape[-3] * shape[-2]))
    if leaf == "weight" and len(shape) == 2:
        return math.sqrt(3.0 / shape[1])
    if leaf == "head_kernel":
        return math.sqrt(3.0 / (shape[0] * shape[1]))
    if leaf in ("query_feat", "query_embed"):
        return math.sqrt(3.0)
    raise ValueError(f"no initialiser for parameter {name} {tuple(shape)}")


def _constant(name: str, shape):
    """The value of a constant leaf, or None for a random one."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("bias", "up_bias", "head_bias"):
        return 0.0
    if leaf == "scale" or (leaf == "weight" and len(shape) == 1):
        return 1.0
    return None


@torch.no_grad()
def make_weights(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of ``shapes`` (name -> shape) as an f32 tensor on
    ``device``, drawn from ``seed``: one uniform draw for all random leaves,
    then a scale per leaf."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    random = [(n, s) for n, s in shapes.items() if _constant(n, s) is None]
    total = sum(math.prod(s) for _, s in random)
    draw = torch.rand(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in random:
        n = math.prod(shape)
        out[name] = (draw[off: off + n].view(shape) * 2.0 - 1.0) * _bound(name, shape)
        off += n
    for name, shape in shapes.items():
        if name not in out:
            out[name] = torch.full(shape, _constant(name, shape), device=device)
        elif name.endswith("head_kernel"):
            out[name][..., 0] = 0.0
    return out


def load_into(net: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``net``'s parameters (every one, by name)."""
    params = dict(net.named_parameters())
    missing = set(params) ^ set(weights)
    if missing:
        raise KeyError(f"weights and network differ in {sorted(missing)[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
