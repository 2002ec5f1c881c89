"""The port's sparse substrate core (``pasco_torch/core/sparse.py``) and
sparse convolutions (``pasco_torch/ops/sparse_conv.py``) against
``pasco_tpu``'s, on seeded numpy inputs in f32 on the CPU.

Index results (coords, masks, rows, segment ids, tables) must be identical
row by row; features that pass through no arithmetic must be identical;
reductions and products within ``rtol=1e-5, atol=1e-5`` (f32, another
summation order).  The inputs include a negative box corner, rows outside
the box, duplicate coordinates, capacities that overflow and ties in the
scores of ``top_k_compact``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasco_tpu.core import sparse as J
from pasco_tpu.ops import sparse_conv as JC
from pasco_torch.core import sparse as P
from pasco_torch.ops import sparse_conv as PC

torch.set_num_threads(1)

CORNER = (-5, 3, -2)        # a negative box corner
EXTENT = (12, 10, 8)
RTOL = ATOL = 1e-5


def jbox(corner=CORNER, extent=EXTENT):
    return J.Box.create(jnp.asarray(corner, jnp.int32), extent)


def pbox(corner=CORNER, extent=EXTENT):
    return P.Box.create(torch.tensor(corner, dtype=torch.int32), extent)


def rand_coords(r, n, stride=1, margin=2, batch=1, unique_rows=False):
    """``[n, 4]`` int32 rows (batch, x, y, z), multiples of ``stride``,
    some up to ``margin`` strides outside the box."""
    lo = np.asarray(CORNER) - margin * stride
    hi = np.asarray(CORNER) + np.asarray(EXTENT) + margin * stride
    xyz = r.randint(lo // stride, -(-hi // stride), size=(n, 3)) * stride
    c = np.concatenate([r.randint(0, batch, (n, 1)), xyz], 1).astype(np.int32)
    if unique_rows:
        c = np.unique(c, axis=0)
        c = c[r.permutation(len(c))]
    return c


def both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def same(t, j):
    np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j))


def close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def grids(r, n, c=5, stride=1, unique_rows=True, p_mask=0.85, margin=2):
    coords = rand_coords(r, n, stride, margin=margin, unique_rows=unique_rows)
    n = len(coords)
    feats = r.randn(n, c).astype(np.float32)
    mask = r.rand(n) < p_mask
    jg = J.SparseGrid(coords=jnp.asarray(coords), feats=jnp.asarray(feats),
                      mask=jnp.asarray(mask), stride=stride)
    pg = P.SparseGrid(torch.from_numpy(coords), torch.from_numpy(feats),
                      torch.from_numpy(mask), stride)
    return jg, pg


def same_grid(t, j, feats=same):
    same(t.mask, j.mask)
    same(t.coords, j.coords)
    feats(t.feats, j.feats)
    assert t.stride == j.stride


# --------------------------------------------------------------------------
# module 1: core/sparse.py
# --------------------------------------------------------------------------


def test_grid_methods():
    jg, pg = grids(np.random.RandomState(0), 50)
    assert int(pg.count()) == int(jg.count())
    same(pg.masked_feats(), jg.masked_feats())
    assert pg.capacity == jg.capacity and pg.num_channels == jg.num_channels
    f = np.ones((pg.capacity, 2), np.float32)
    assert pg.with_feats(torch.from_numpy(f)).feats.shape == (pg.capacity, 2)
    assert pg.replace(stride=4).stride == 4
    mg = P.make_grid(pg.coords.numpy(), pg.feats)
    jm = J.make_grid(jg.coords, jg.feats)
    same(mg.mask, jm.mask)
    same(mg.coords, jm.coords)


@pytest.mark.parametrize("stride", [1, 2])
def test_linear_keys_and_sorted_table(stride):
    r = np.random.RandomState(stride)
    coords = rand_coords(r, 300, stride, batch=2)       # duplicates included
    mask = r.rand(len(coords)) < 0.8
    jk = J.linear_keys(jnp.asarray(coords), jnp.asarray(mask), jbox(), stride)
    pk = P.linear_keys(torch.from_numpy(coords), torch.from_numpy(mask), pbox(), stride)
    same(pk, jk)
    js, jp = J.build_table(jk)
    ps, pp = P.build_table(pk)
    same(ps, js)
    same(pp, jp)
    q = np.concatenate([np.asarray(jk)[::3], r.randint(0, 4000, 40).astype(np.int32)])
    jr, jf = J.lookup(js, jp, jnp.asarray(q))
    pr, pf = P.lookup(ps, pp, torch.from_numpy(q))
    same(pr, jr)
    same(pf, jf)


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_dense_table(stride):
    jg, pg = grids(np.random.RandomState(10 + stride), 200, stride=stride)
    jt = J.build_dense_table(jg.coords, jg.mask, jbox(), stride)
    pt = P.build_dense_table(pg.coords, pg.mask, pbox(), stride)
    same(pt, jt)
    q = rand_coords(np.random.RandomState(20 + stride), 150, stride)
    qm = np.random.RandomState(3).rand(len(q)) < 0.9
    jr, jf = J.lookup_dense_table(jt, jnp.asarray(q), jnp.asarray(qm), jbox(), stride)
    pr, pf = P.lookup_dense_table(pt, torch.from_numpy(q), torch.from_numpy(qm), pbox(), stride)
    same(pr, jr)
    same(pf, jf)


@pytest.mark.parametrize("capacity", [200, 64])     # room for all; overflow
def test_compact(capacity):
    r = np.random.RandomState(capacity)
    jg, pg = grids(r, 220)
    keep = r.rand(pg.capacity) < 0.6
    same_grid(P.compact(pg, torch.from_numpy(keep), capacity),
              J.compact(jg, jnp.asarray(keep), capacity))


@pytest.mark.parametrize("capacity", [160, 40])     # room for all; binding
def test_top_k_compact_with_ties(capacity):
    r = np.random.RandomState(capacity)
    jg, pg = grids(r, 200)
    scores = r.choice([0.1, 0.5, 0.9, 0.9], size=pg.capacity).astype(np.float32)
    keep = r.rand(pg.capacity) < 0.7
    t = P.top_k_compact(pg, torch.from_numpy(scores), torch.from_numpy(keep), capacity)
    j = J.top_k_compact(jg, jnp.asarray(scores), jnp.asarray(keep), capacity)
    same_grid(t, j)     # every row, the losing ones with mask=False too


def test_prune_outside_box():
    jg, pg = grids(np.random.RandomState(5), 120)
    lo, hi = np.array([-4, 4, -1], np.int32), np.array([3, 9, 4], np.int32)
    same_grid(P.prune_outside_box(pg, *(torch.from_numpy(a) for a in (lo, hi))),
              J.prune_outside_box(jg, jnp.asarray(lo), jnp.asarray(hi)))


@pytest.mark.parametrize("reduce,capacity,max_batch,stride", [
    ("max", 300, 1, 1), ("sum", 300, 1, 1), ("mean", 300, 2, 1), ("max", 40, 2, 2),
    ("sum", 40, 1, 2)])
def test_unique(reduce, capacity, max_batch, stride):
    """Duplicates (many rows per cell), rows outside the box, masked rows,
    a second batch, and a capacity that overflows."""
    r = np.random.RandomState(capacity + max_batch)
    coords = rand_coords(r, 400, stride, batch=max_batch)
    mask = r.rand(len(coords)) < 0.85
    feats = r.randn(len(coords), 6).astype(np.float32)
    j = J.unique(jnp.asarray(coords), jnp.asarray(mask), jbox(), stride, capacity,
                 jnp.asarray(feats), reduce, max_batch)
    t = P.unique(torch.from_numpy(coords), torch.from_numpy(mask), pbox(), stride,
                 capacity, torch.from_numpy(feats), reduce, max_batch)
    for a, b in zip(t[:3], j[:3]):
        same(a, b)
    close(t[3], j[3])
    assert 0 < int(t[1].sum()) <= capacity


def test_unique_without_feats():
    r = np.random.RandomState(7)
    coords = rand_coords(r, 100)
    mask = np.ones(len(coords), bool)
    j = J.unique(jnp.asarray(coords), jnp.asarray(mask), jbox(), 1, 128)
    t = P.unique(torch.from_numpy(coords), torch.from_numpy(mask), pbox(), 1, 128)
    assert t[3] is None and j[3] is None
    for a, b in zip(t[:3], j[:3]):
        same(a, b)


@pytest.mark.parametrize("stride", [1, 2])
def test_to_dense_wraps_as_the_reference(stride):
    """Valid rows outside the box: a negative index wraps once, as the
    reference's scatter does; beyond that the row is dropped."""
    jg, pg = grids(np.random.RandomState(30 + stride), 150, stride=stride, margin=3)
    for fill in (0.0, -1.0):
        same(P.to_dense(pg, pbox(), 1, fill), J.to_dense(jg, jbox(), 1, fill))


@pytest.mark.parametrize("capacity", [None, 100])
def test_from_dense_and_gather_dense(capacity):
    r = np.random.RandomState(40)
    ex, ey, ez = (e // 2 for e in EXTENT)
    dense = r.randn(1, ex, ey, ez, 3).astype(np.float32)
    dense[r.rand(1, ex, ey, ez) < 0.7] = 0
    cap = capacity or ex * ey * ez
    jd, pd = both(dense)
    same_grid(P.from_dense(pd, pbox(), 2, cap), J.from_dense(jd, jbox(), 2, cap))
    keep = r.rand(1, ex, ey, ez) < 0.5
    same_grid(P.from_dense(pd, pbox(), 2, cap, torch.from_numpy(keep)),
              J.from_dense(jd, jbox(), 2, cap, jnp.asarray(keep)))
    q = rand_coords(r, 80, 2, batch=2)
    qm = r.rand(len(q)) < 0.9
    same(P.gather_dense(pd, torch.from_numpy(q), torch.from_numpy(qm), pbox(), 2),
         J.gather_dense(jd, jnp.asarray(q), jnp.asarray(qm), jbox(), 2))


@pytest.mark.parametrize("reduce", ["mean", "max"])
def test_global_pool(reduce):
    r = np.random.RandomState(50)
    coords = rand_coords(r, 90, batch=3)
    feats = r.randn(len(coords), 4).astype(np.float32)
    mask = r.rand(len(coords)) < 0.8
    jg = J.SparseGrid(coords=jnp.asarray(coords), feats=jnp.asarray(feats),
                      mask=jnp.asarray(mask))
    pg = P.SparseGrid(*(torch.from_numpy(a) for a in (coords, feats, mask)))
    same(P.batch_offsets(pg, 2), J.batch_offsets(jg, 2))      # batch 2 beyond B
    close(P.global_pool(pg, 2, reduce), J.global_pool(jg, 2, reduce))


# --------------------------------------------------------------------------
# module 2: ops/sparse_conv.py
# --------------------------------------------------------------------------


@pytest.mark.parametrize("ks", [1, 2, 3, 5])
def test_kernel_offsets(ks):
    np.testing.assert_array_equal(PC.kernel_offsets(ks), JC.kernel_offsets(ks))


@pytest.mark.parametrize("ks,stride", [(3, 1), (3, 2), (5, 1)])
def test_rulebook(ks, stride):
    jg, pg = grids(np.random.RandomState(60 + ks + stride), 250, stride=stride)
    j = JC.build_rulebook(jg.coords, jg.mask, jbox(), stride, ks)
    t = PC.build_rulebook(pg.coords, pg.mask, pbox(), stride, ks)
    same(t.rows, j.rows)
    same(t.found, j.found)


@pytest.mark.parametrize("ks", [1, 3])
def test_submanifold_conv3d(ks):
    r = np.random.RandomState(70 + ks)
    jg, pg = grids(r, 250, c=6)
    w = r.randn(ks ** 3, 6, 4).astype(np.float32)
    b = r.randn(4).astype(np.float32)
    j = JC.submanifold_conv3d(jg, jbox(), jnp.asarray(w), jnp.asarray(b))
    t = PC.submanifold_conv3d(pg, pbox(), torch.from_numpy(w), torch.from_numpy(b))
    same_grid(t, j, feats=close)


def test_conv_with_rulebook_shared():
    """A rulebook built once serves a second conv (the residual blocks'
    pattern), bias-free, 27 taps in three groups of nine."""
    r = np.random.RandomState(80)
    jg, pg = grids(r, 250, c=6)
    jrb = JC.build_rulebook(jg.coords, jg.mask, jbox(), 1, 3)
    prb = PC.build_rulebook(pg.coords, pg.mask, pbox(), 1, 3)
    w = r.randn(27, 6, 3).astype(np.float32)
    close(PC.conv_with_rulebook(pg.masked_feats(), prb, torch.from_numpy(w)),
          JC.conv_with_rulebook(jg.masked_feats(), jrb, jnp.asarray(w)))


@pytest.mark.parametrize("out_capacity", [300, 30])      # room; overflow
def test_strided_conv3d(out_capacity):
    r = np.random.RandomState(90 + out_capacity)
    jg, pg = grids(r, 250, c=5, stride=2)
    w = r.randn(8, 5, 7).astype(np.float32)
    b = r.randn(7).astype(np.float32)
    j = JC.strided_conv3d(jg, jbox(), jnp.asarray(w), out_capacity, jnp.asarray(b))
    t = PC.strided_conv3d(pg, pbox(), torch.from_numpy(w), out_capacity, torch.from_numpy(b))
    same_grid(t, j, feats=close)


def test_generative_deconv3d():
    r = np.random.RandomState(100)
    jg, pg = grids(r, 60, c=5, stride=4)
    w = r.randn(8, 5, 3).astype(np.float32)
    b = r.randn(3).astype(np.float32)
    j = JC.generative_deconv3d(jg, jnp.asarray(w), jnp.asarray(b))
    t = PC.generative_deconv3d(pg, torch.from_numpy(w), torch.from_numpy(b))
    same_grid(t, j, feats=close)


@pytest.mark.parametrize("factor,out_capacity", [(2, 256), (4, 20)])
def test_sparse_max_pool(factor, out_capacity):
    jg, pg = grids(np.random.RandomState(110 + factor), 250, c=4)
    j = JC.sparse_max_pool(jg, factor, jbox(), out_capacity)
    t = PC.sparse_max_pool(pg, factor, pbox(), out_capacity)
    same_grid(t, j)


def test_lookup_features():
    r = np.random.RandomState(120)
    jg, pg = grids(r, 200, c=4, stride=2)
    q = rand_coords(r, 150, 2)
    qm = r.rand(len(q)) < 0.9
    jf, jfound = JC.lookup_features(jg, jnp.asarray(q), jnp.asarray(qm), jbox())
    pf, pfound = PC.lookup_features(pg, torch.from_numpy(q), torch.from_numpy(qm), pbox())
    same(pfound, jfound)
    same(pf, jf)


def test_rulebook_conv_function_gradients():
    """``RulebookConvFn``'s backward (a second gather for dW, a scatter-add
    for dX) against autograd of the plain gather form in f64, within
    ``1e-5 * max|ref|`` (the Function computes in f32)."""
    r = np.random.RandomState(130)
    _, pg = grids(r, 300, c=6)
    rb = PC.build_rulebook(pg.coords, pg.mask, pbox(), 1, 3)
    idx = PC._gather_index(rb, pg.capacity)
    x = torch.from_numpy(r.randn(pg.capacity, 6).astype(np.float32))
    w = torch.from_numpy(r.randn(27, 6, 4).astype(np.float32))
    dy = torch.from_numpy(r.randn(pg.capacity, 4).astype(np.float32))
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    PC.RulebookConvFn.apply(xa, idx, wa).backward(dy)
    xb, wb = x.double().requires_grad_(), w.double().requires_grad_()
    xp = torch.cat([xb, xb.new_zeros(1, 6)])
    torch.einsum("nkc,kcd->nd", xp[idx], wb).backward(dy.double())
    for got, ref in ((xa.grad, xb.grad), (wa.grad, wb.grad)):
        assert (got.double() - ref).abs().max() <= 1e-5 * ref.abs().max()
