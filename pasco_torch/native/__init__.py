"""ctypes bindings for the native host library.

Provides :func:`linear_sum_assignment` (Hungarian matching — replaces the
reference's scipy calls at ``matcher_sparse.py:151``, ``ensembler.py:440``,
``panoptic_quality.py:166``) and :func:`connected_components_26` (instance
floodfill — replaces the pure-Python BFS of
``label_gen/gen_instance_labels.py:44-65``).

The shared library is compiled on first use from the sources beside this
file into ``build/pasco_torch/native/`` of the checkout (never into the
source tree); if no toolchain is available we fall back to scipy / a NumPy
BFS so the package stays importable everywhere.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "pasco_torch",
                          "native")
_LIB_PATH = os.path.join(_BUILD_DIR, "libpasco_native.so")
_SOURCES = ("hungarian.cpp", "floodfill.cpp")
# the reference's Makefile flags (pasco_tpu/native/Makefile)
_CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]


def _build() -> None:
    """Compile the library into ``_BUILD_DIR`` (a private name first, then
    renamed, so concurrent processes never load a half-written file)."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}"
    subprocess.run(
        [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", tmp,
         *(os.path.join(_DIR, f) for f in _SOURCES)],
        check=True,
        capture_output=True,
        timeout=120,
    )
    os.replace(tmp, _LIB_PATH)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            if not os.path.exists(_LIB_PATH):
                _build()
            lib = ctypes.CDLL(_LIB_PATH)
            lib.pasco_linear_sum_assignment.restype = ctypes.c_int
            lib.pasco_linear_sum_assignment.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.pasco_linear_sum_assignment_batch.restype = ctypes.c_int
            lib.pasco_linear_sum_assignment_batch.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.pasco_connected_components_26.restype = ctypes.c_int
            lib.pasco_connected_components_26.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
            ]
            _lib = lib
        except Exception:
            _lib_failed = True
    return _lib


def have_native() -> bool:
    return _load() is not None


def linear_sum_assignment(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """scipy-compatible LSA: returns (row_ind, col_ind), both sorted by row.

    Minimises the total cost over a full matching of the smaller dimension.
    """
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    n, m = cost.shape
    lib = _load()
    if lib is None:
        from scipy.optimize import linear_sum_assignment as _scipy_lsa

        return _scipy_lsa(cost)
    out = np.full((n,), -1, dtype=np.int32)
    rc = lib.pasco_linear_sum_assignment(
        cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        m,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    if rc != 0:
        raise RuntimeError("pasco_linear_sum_assignment failed")
    rows = np.nonzero(out >= 0)[0]
    return rows.astype(np.int64), out[rows].astype(np.int64)


def assignment_vector(cost: np.ndarray) -> np.ndarray:
    """LSA as a dense per-row vector: out[i] = matched column or -1."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    n, m = cost.shape
    lib = _load()
    if lib is None:
        from scipy.optimize import linear_sum_assignment as _scipy_lsa

        r, c = _scipy_lsa(cost)
        out = np.full((n,), -1, dtype=np.int32)
        out[r] = c
        return out
    out = np.full((n,), -1, dtype=np.int32)
    rc = lib.pasco_linear_sum_assignment(
        cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        m,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    if rc != 0:
        raise RuntimeError("pasco_linear_sum_assignment failed")
    return out


def connected_components_26(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """26-connected components of a 3D boolean grid.

    Returns ``(labels int32 [X, Y, Z], n_components)``; background = 0.
    """
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    X, Y, Z = mask.shape
    labels = np.zeros((X, Y, Z), dtype=np.int32)
    lib = _load()
    if lib is not None:
        n = lib.pasco_connected_components_26(
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            X,
            Y,
            Z,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return labels, int(n)
    # NumPy/scipy fallback.
    from scipy import ndimage

    structure = np.ones((3, 3, 3), dtype=bool)
    labels, n = ndimage.label(mask, structure=structure)
    return labels.astype(np.int32), int(n)
