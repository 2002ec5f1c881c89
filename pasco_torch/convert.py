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

The WaffleIron Segmenter has its own pair (:func:`waffleiron_flax_to_torch`,
:func:`load_waffleiron_state_dict`): its BatchNorms are named ``norm`` too,
so the LayerNorm rule above does not apply, and its depthwise kernels
change layout.
"""

from __future__ import annotations

import pickle
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


# ---------------------------------------------------------------------------
# WaffleIron (pasco_torch/models/waffleiron.py)
# ---------------------------------------------------------------------------

WAFFLE_DEPTHWISE = ("dw1", "dw2")


def _unwrap(obj):
    """A dict saved into an ``.npz`` comes back as a 0-d object array."""
    if isinstance(obj, np.ndarray) and obj.dtype == object and obj.shape == ():
        return obj.item()
    return obj


def _flatten(tree, prefix: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out.update(_flatten(value, f"{prefix}/{key}"))
        else:
            out[f"{prefix}/{key}"] = np.asarray(value)
    return out


def waffleiron_flax_to_torch(params, batch_stats=None) -> Dict[str, torch.Tensor]:
    """The JAX ``Segmenter``'s variables as the port's ``Segmenter``
    ``state_dict``.  ``params`` (and ``batch_stats``) are nested dicts of
    arrays, or one of the containers they come in: a ``{"params",
    "batch_stats"}`` dict (``net.init``'s, also as the 0-d object array
    that an ``.npz`` gives back), or the payload of the JAX trainer's
    ``ckpt_{best,last}.pkl`` (``{"epoch", "best_miou", "state"}``,
    ``pasco_tpu/training/waffleiron_train.py:585-593``).  Every ``nn.Dense``
    kernel ``[in, out]`` becomes ``weight [out, in]``, the depthwise HWIO
    ``(3, 3, 1, C)`` kernels ``(C, 1, 3, 3)``; BatchNorm ``scale``/``bias``/
    ``mean``/``var``, biases and ``layerscale`` keep their names and shapes."""
    params = _unwrap(params)
    if "state" in params:
        state = params["state"]
        params, batch_stats = state.params, state.batch_stats
    elif "params" in params:
        params, batch_stats = params["params"], params.get("batch_stats", batch_stats)
    flat = {**_flatten(params, "params"), **_flatten(_unwrap(batch_stats) or {}, "batch_stats")}
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        _, *path, leaf = key.split("/")
        arr = np.array(value, dtype=np.float32)
        if leaf == "kernel":
            leaf, arr = "weight", arr.T
        elif leaf in WAFFLE_DEPTHWISE:
            arr = arr.transpose(3, 2, 0, 1)
        out[".".join([*path, leaf])] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


class _ForeignUnpickler(pickle.Unpickler):
    """Reads a JAX checkpoint without importing JAX: classes of
    ``pasco_tpu``, ``optax``, ``flax`` or ``jax`` (the train state and the
    optimizer state around numpy leaves) load as plain attribute holders."""

    FOREIGN = ("pasco_tpu", "optax", "flax", "jax", "jaxlib")

    def find_class(self, module, name):
        if module.split(".")[0] in self.FOREIGN:
            return type(name, (_Foreign,), {})
        return super().find_class(module, name)


class _Foreign:
    def __new__(cls, *args):
        obj = object.__new__(cls)
        obj.args = args
        return obj


def load_waffleiron_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The port's ``Segmenter`` ``state_dict`` from a checkpoint file: an
    ``.npz`` holding ``variables`` (``{"params", "batch_stats"}`` of numpy
    arrays, the JAX extractor's ``--checkpoint``), a JAX trainer's
    ``ckpt_*.pkl``, or the port's own ``ckpt_*.pkl``
    (:meth:`pasco_torch.training.waffleiron_train.WaffleIronTrainer.save_state`)."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=True) as z:
            return waffleiron_flax_to_torch(z["variables"])
    with open(path, "rb") as f:
        payload = _ForeignUnpickler(f).load()
    if "model" in payload:
        return {k: torch.from_numpy(np.asarray(v)) for k, v in payload["model"].items()}
    return waffleiron_flax_to_torch(payload)
