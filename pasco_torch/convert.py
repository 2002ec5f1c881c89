"""Weight bridge between flax variables and the port's ``state_dict``, both
ways (:func:`flax_to_torch`, :func:`torch_to_flax`).

``flat`` holds the reference's variables flattened to ``params/a/b/c`` and
``batch_stats/a/b/c`` keys, the key form of ``bench.py:_load_bench_ckpt``.
Submodule names in the port equal the flax names, so the mapping is
mechanical:

* ``nn.Dense`` ``kernel [in, out]`` (every 2-D kernel) becomes
  ``nn.Linear.weight [out, in]``;
* ``nn.LayerNorm`` ``scale`` (modules named ``norm``/``decoder_norm``)
  becomes ``weight``;
* everything else keeps its name and shape: conv kernels
  ``[taps, Ci, Co]``, BatchNorm ``scale``/``bias``/``mean``/``var``, the
  vmapped refiners' leading subnet axis, the queries ``[S, Q, H]``.

The same rules carry the sparse substrate's tree (``PaSCoNet``): its
submodules keep flax's names, auto-names such as
``encoder/s1s2_down/SparseDownConv_0`` included, every conv kernel is 3-D
or more (the refiners' ``[S, 27, C, C]``, the bottleneck's ``[kx, ky, kz,
C, C]``), and only the ``nn.Dense`` kernels (``cylinder_feat/fc*``, the
transformer's) are transposed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

LAYERNORMS = ("norm", "decoder_norm")
BATCH_STATS = ("mean", "var")


def flax_to_torch(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        coll, *path, leaf = key.split("/")
        if coll not in ("params", "batch_stats"):
            raise KeyError(f"unknown variable collection in {key!r}")
        arr = np.array(value, dtype=np.float32)
        if coll == "params" and leaf == "kernel" and arr.ndim == 2:
            leaf, arr = "weight", arr.T
        elif coll == "params" and path and path[-1] in LAYERNORMS and leaf == "scale":
            leaf = "weight"
        out[".".join([*path, leaf])] = torch.from_numpy(arr.copy())
    return out


def torch_to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`flax_to_torch`: a port ``state_dict`` as f32
    ``params/...`` / ``batch_stats/...`` arrays, the layout that
    ``bench.py`` and ``scripts_torch/bench.py`` load (``BENCH_TRAINED_CKPT``)."""
    out: Dict[str, np.ndarray] = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        arr = value.detach().float().cpu().numpy()
        coll = "batch_stats" if leaf in BATCH_STATS else "params"
        if leaf == "weight" and path and path[-1] in LAYERNORMS:
            leaf = "scale"
        elif leaf == "weight":
            leaf, arr = "kernel", arr.T
        out["/".join([coll, *path, leaf])] = np.ascontiguousarray(arr)
    return out
