"""Build, load and count the hand-written CUDA kernels.

The sources in ``pasco_torch/csrc/*.cu`` have a plain C interface.  At
first use each is compiled by its own ``nvcc`` process for ``sm_90a``, all
started together, and the objects are linked into one shared library under
``build/pasco_torch/<hash>/`` of the checkout (the hash covers the sources
and flags, so an edit rebuilds), loaded with ``ctypes``.  Nothing here
runs at import time: the CPU tests import every module on a machine
without ``nvcc``.

Every pointer and the stream cross the boundary as ``ctypes.c_void_p``;
each C entry returns ``cudaGetLastError()`` after its launch and
:func:`check` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import weakref
from pathlib import Path
from typing import Dict, Optional

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "pasco_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo",
]
# Extra nvcc flags, e.g. the defines of scripts_torch/conv_ablation.py's
# variants; they are part of the build hash.
EXTRA_FLAGS_ENV = "PASCO_NVCC_EXTRA_FLAGS"

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
U = ctypes.c_uint

# C signature of every entry point (all return cudaError_t as int).
_SIGNATURES = {
    # x, mask, w, bias, aff_a, aff_c, skip, out, tile_ids, n_active,
    # B, X, Z, Y, C, flip, relu_in, relu_out, n_tiles, stream
    "pasco_masked_conv3": [P] * 10 + [I] * 9 + [P],
    # x, mask_in, mask_out, w, bias, a1, c1, a2, c2, out, ids, n_valid,
    # B, X, Z, Y, Ci, Co, stream
    "pasco_down2_fused": [P] * 12 + [I] * 6 + [P],
    # parent, parent_keep, child_mask, union_mask, skip, wd, bd, a1, c1,
    # a2, c2, wr, br, box_min, out, tile_ids, n_active,
    # B, X2, Z2, Y2, Ci, Co, scale, n_tiles, stream
    "pasco_up_preamble": [P] * 17 + [I] * 8 + [P],
    # keep, payload, n, E, cap, ws, ws_tiles, epoch, vals, src, valid,
    # total, stream
    "pasco_stream_extract": [P, P, L, I, I, P, I, U, P, P, P, P, P],
    # x, img, bias, mask, listed, out, ids, n_active,
    # X, Y, Z, Cs, D, NB, NKC, capacity, stream
    "pasco_column_conv3": [P] * 8 + [I] * 8 + [P],
    # f, order, ks, w, b, x, occ, P, F, C, n_cells, in_dtype, out_dtype,
    # stream
    "pasco_featurizer": [P] * 7 + [I] * 6 + [P],
}

# Launch counts of the kernel wrappers: each wrapper adds one where it
# launches its kernel, and nowhere else.
LAUNCHES: Dict[str, int] = {
    "masked_conv3": 0, "conv3_dx": 0, "down2_fused": 0, "up_preamble": 0,
    "stream_extract": 0, "column_conv3": 0, "featurizer": 0,
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build() -> Path:
    """Compile the sources (if this hash is not built yet); returns the
    library path.  Raises with nvcc's output on failure."""
    flags = NVCC_FLAGS + os.environ.get(EXTRA_FLAGS_ENV, "").split()
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libpasco_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    cus = [s for s in _sources() if s.suffix == ".cu"]
    objs = [out_dir / f"{s.stem}.{tag}.o" for s in cus]
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True))
             for cmd in ([_nvcc(), *flags, "-I", str(_CSRC), "-c", "-o", str(o), str(s)]
                         for s, o in zip(cus, objs))]
    failed = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
    failed = [f for f in failed if f[2] != 0]
    if not failed:
        tmp = out_dir / f"libpasco_kernels.{tag}.so"
        cmd = [_nvcc(), *flags, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode == 0:
            os.replace(tmp, lib_path)
        else:
            failed = [(cmd, res.stdout, res.returncode)]
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(
            f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}" for cmd, out, rc in failed))
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            dll = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(dll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = dll
    return _lib


_CASTS: Dict[int, tuple] = {}


def cast_once(t: torch.Tensor, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous ``dtype`` tensor on ``device``, converted once
    per version of ``t`` (a parameter is converted again after an in-place
    update, which bumps its version, or when its data is replaced); the
    copy is dropped with ``t``."""
    if t.device == device and t.dtype == dtype and t.is_contiguous():
        return t
    key = id(t)
    stamp = (t._version, t.data_ptr(), device, dtype)   # in place, or new data
    hit = _CASTS.get(key)
    if hit is not None and hit[0]() is t and hit[1] == stamp:
        return hit[2]
    out = t.detach().to(device=device, dtype=dtype).contiguous()
    _CASTS[key] = (weakref.ref(t, lambda _, k=key: _CASTS.pop(k, None)), stamp, out)
    return out


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_ptr(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as the raw pointer (the public
    ``torch.cuda.current_stream(dev).cuda_stream`` builds a Stream object
    first, host time on every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
            device: Optional[torch.device] = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``
    (and ``shape``/``device`` where given)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
