"""Kernel 7, the column-sparse 3^3 conv (``pasco_torch/ops/column_conv.py``):
``active_columns`` against the JAX function, and ``block_sparse_conv3``'s
plain version against the JAX ``block_sparse_conv3`` run in Pallas
interpret mode (``tests/test_pallas_conv.py``'s shapes), in f32.

Bound: every cell within ``1e-4 * max|ref|`` (same f32 math, another
summation order); cells of unvisited columns get no conv in either (0,
plus the bias at mask cells), also where the capacity truncates the
column list.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pasco_tpu.ops import pallas_conv as jpc
from pasco_torch.ops import column_conv as tcc

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def test_active_columns_match_jax():
    r = np.random.RandomState(0)
    mask = np.zeros((32, 24, 8), bool)
    mask[3:20, 5:22] = r.rand(17, 17, 8) < 0.02
    mask[30, 1, 7] = True
    for cap in (12, 5, 1):
        ids_j, n_j = jpc.active_columns(jnp.asarray(mask), cap)
        ids_t, n_t = tcc.active_columns(T(mask), cap)
        assert int(n_t[0]) == int(n_j[0]) == min(cap, int(np.asarray(
            mask.reshape(4, 8, 3, 8, 8).any((1, 3, 4))).sum()))
        n = int(n_j[0])
        np.testing.assert_array_equal(ids_t.numpy()[:n], np.asarray(ids_j)[:n])


def test_active_columns_ragged_edges():
    """X, Y not multiples of 8: the edge columns are partial."""
    mask = torch.zeros((10, 13, 3), dtype=torch.bool)
    mask[9, 12, 2] = True
    mask[0, 9, 0] = True
    ids, n = tcc.active_columns(mask, 4)
    assert int(n[0]) == 2
    assert ids[:2].tolist() == [1, 3]            # (bx, by) = (0, 1), (1, 1)
    vis = tcc.visited_cells(ids, n, 10, 13)
    assert vis[8:, 8:].all() and vis[:8, 8:].all() and not vis[:, :8].any()


def _case(seed, X, Y, Z, C, D):
    r = np.random.RandomState(seed)
    mask = np.zeros((X, Y, Z), bool)
    mask[4:20, 6:25, 2:12] = r.rand(16, 19, 10) > 0.5
    x = np.where(mask[..., None], r.randn(X, Y, Z, C), 0).astype(np.float32)
    w = (r.randn(27, C, D) * 0.1).astype(np.float32)
    b = r.randn(D).astype(np.float32)
    return x, w, mask, b


@pytest.mark.parametrize("capacity", [16, 5])
def test_block_sparse_conv3_matches_jax(capacity):
    """The plain version against the Pallas kernel in interpret mode; at
    capacity 5 the list is truncated (the mask touches 9 columns)."""
    x, w, mask, b = _case(0, 32, 32, 16, 64, 32)
    n_cols = int(mask.reshape(4, 8, 4, 8, 16).any((1, 3, 4)).sum())
    assert (capacity >= n_cols) == (capacity == 16)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jpc.block_sparse_conv3(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask),
            block_capacity=capacity, bias=jnp.asarray(b)), np.float64)
    got = tcc.block_sparse_conv3(T(x), T(w), T(mask), capacity, bias=T(b)).numpy()
    assert got.dtype == np.float32
    err = np.abs(got - ref).max()
    assert err <= 1e-4 * np.abs(ref).max(), err
    ids, n = tcc.active_columns(T(mask), capacity)
    vis = tcc.visited_cells(ids, n, 32, 32).numpy()
    # unvisited columns: exactly 0, plus the bias at their mask cells
    visz = np.broadcast_to(vis[..., None], mask.shape)
    assert np.all(got[~visz & ~mask] == 0) and np.all(ref[~visz & ~mask] == 0)
    assert np.all(got[~visz & mask] == b)
    assert (capacity == 16) == visz[mask].all()
    assert np.abs(got[vis]).max() > 0
    # visited but mask-invalid cells carry the raw conv, without the bias
    raw = vis[..., None] & ~mask
    assert np.abs(got[raw]).max() > 0


def test_block_sparse_conv3_skips_dead_columns():
    """``tests/test_pallas_conv.py::test_block_sparse_conv_skips_dead_columns``
    on the port and the JAX function: one live column, the others exactly
    zero, every cell within the bound above."""
    r = np.random.RandomState(1)
    X, Y, Z, C = 16, 16, 8, 64
    mask = np.zeros((X, Y, Z), bool)
    mask[0:8, 0:8, :] = True
    x = np.where(mask[..., None], r.randn(X, Y, Z, C), 0).astype(np.float32)
    w = (r.randn(27, C, C) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jpc.block_sparse_conv3(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask), block_capacity=4), np.float64)
    out = tcc.block_sparse_conv3(T(x), T(w), T(mask), 4).numpy()
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()
    assert np.all(out[8:] == 0) and np.all(out[:, 8:] == 0)
    assert np.abs(out[:8, :8]).max() > 0


def test_block_sparse_conv3_rounds_to_compute_dtype():
    """Inputs rounded to ``compute_dtype``, products in f32, output in
    ``x.dtype``."""
    x, w, mask, b = _case(2, 24, 32, 16, 16, 16)
    got = tcc.block_sparse_conv3(T(x), T(w), T(mask), 12, bias=T(b),
                                 compute_dtype=torch.bfloat16)
    xr = T(x).bfloat16().float()
    wr = T(w).bfloat16().float()
    want = tcc.block_sparse_conv3(xr, wr, T(mask), 12, bias=T(b))
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
