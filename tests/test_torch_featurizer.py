"""Kernel 8, the fused featurizer (``pasco_torch/ops/featurizer.py``): its
plain version against the JAX ``featurizer_fused`` run in Pallas interpret
mode, and against the port's model featurizer chain at S == 1.

The JAX entry writes the enc_s1 chain's padded, z-pair-packed input
``xpad [X+2, T+2, Ypad, 2C]`` and ``occ[slot, x, t, y]``; its interior is
unpacked here to the port's logical ``[X, Z, Y, C]``.  The extent has
``ex = 16`` (two x-windows), away from the reference's one-window border
fault.  Bounds: occupancy identical; values at occupied cells within
``2e-3`` (``tests/test_pallas_featurizer.py``'s bound; same f32 math,
another summation order); exact zeros at empty cells of the port.
"""

import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from pasco_torch.ops import featurizer as tf

torch.set_num_threads(1)
EXTENT = (16, 32, 16)          # ex, ey, ez


def points(seed, P=400, F=8, C=8):
    r = np.random.RandomState(seed)
    ex, ey, ez = EXTENT
    f = (r.randn(P, F) * 3).astype(np.float32)
    rel = np.stack([r.randint(0, e, P) for e in EXTENT], 1).astype(np.int32)
    # a few crowded cells, so that runs hold several points
    rel[: P // 4] = rel[P // 4: P // 2] % np.array([4, 4, 4], np.int32)
    in_box = r.rand(P) > 0.1
    w = (r.randn(F, C) * 0.2).astype(np.float32)
    b = (r.randn(C) * 0.1).astype(np.float32)
    return f, rel, in_box, w, b


def T(a):
    return torch.from_numpy(np.array(a))


def test_featurizer_matches_jax_kernel():
    from pasco_tpu.ops.dense_ops import blockdiag2_weight
    from pasco_tpu.ops.pallas_conv import HY, conv_plan
    from pasco_tpu.ops.pallas_featurizer import featurizer_fused as jfeat

    f, rel, in_box, w, b = points(7)
    F, C = w.shape
    ex, ey, ez = EXTENT
    Tz = ez // 2
    yt = conv_plan(2 * F, 2 * F, Tz + 2, fused=True, X=ex, Y=ey)[1]
    with pltpu.force_tpu_interpret_mode():
        xpad, _, occ_j = jfeat(
            jnp.asarray(f), jnp.asarray(rel), jnp.asarray(in_box),
            blockdiag2_weight(jnp.asarray(w)), jnp.concatenate([jnp.asarray(b)] * 2),
            EXTENT, yt, -1e30, jnp.float32)
    # occ[slot, x, t, y] -> [x, z = 2t + slot, y]
    occ_ref = np.asarray(occ_j).transpose(1, 2, 0, 3).reshape(ex, ez, ey)
    inner = np.asarray(xpad)[1:-1, 1:Tz + 1, HY:HY + ey]           # [X, T, Y, 2C]
    x_ref = inner.reshape(ex, Tz, ey, 2, C).transpose(0, 1, 3, 2, 4).reshape(ex, ez, ey, C)

    x, occ = tf.featurizer_fused(T(f), T(rel), T(in_box), T(w), T(b), EXTENT, torch.float32)
    np.testing.assert_array_equal(occ.numpy(), occ_ref)
    assert 0 < occ_ref.sum() < in_box.sum()        # some cells hold several points
    x = x.numpy()
    np.testing.assert_allclose(x[occ_ref], x_ref[occ_ref], rtol=2e-3, atol=2e-3)
    assert np.all(x[~occ_ref] == 0)


def test_featurizer_is_the_model_chain_at_s1():
    """The plain version is the model's featurizer chain at S == 1
    (``DensePaSCoNet.forward``: ``scatter_points`` with subnet 0, the
    occupancy ``any`` over subnets, the masked ``enc_in``), in f32 and bf16,
    and it agrees with a numpy per-cell max + 1x1."""
    f, rel, in_box, w, b = points(3)
    ex, ey, ez = EXTENT
    for dt in (torch.float32, torch.bfloat16):
        x, occ = tf.featurizer_fused(T(f), T(rel), T(in_box), T(w), T(b), EXTENT, dt)
        g, occ_s = tf.scatter_points(T(f), T(rel), T(in_box),
                                     torch.zeros(len(f), dtype=torch.int32), 1, EXTENT, dt)
        mask1 = occ_s.any(-1)
        xm = tf.enc_in_1x1(g, mask1, T(w), T(b))
        assert x.dtype == dt and torch.equal(occ, mask1) and torch.equal(x, xm)

    # numpy: max over each cell's points, then the 1x1 + bias
    grid = np.full((ex, ez, ey, f.shape[1]), -np.inf, np.float32)
    for p in np.nonzero(in_box)[0]:
        xi, yi, zi = rel[p]
        grid[xi, zi, yi] = np.maximum(grid[xi, zi, yi], f[p])
    occ_np = np.isfinite(grid[..., 0])
    want = np.where(occ_np[..., None], np.where(occ_np[..., None], grid, 0) @ w + b, 0)
    x, occ = tf.featurizer_fused(T(f), T(rel), T(in_box), T(w), T(b), EXTENT, torch.float32)
    np.testing.assert_array_equal(occ.numpy(), occ_np)
    np.testing.assert_allclose(x.numpy(), want, rtol=1e-5, atol=1e-5)


def test_featurizer_empty_scan():
    f, rel, in_box, w, b = points(5)
    x, occ = tf.featurizer_fused(T(f), T(rel), torch.zeros(len(f), dtype=torch.bool),
                                 T(w), T(b), EXTENT, torch.float32)
    assert not occ.any() and not x.any()
    assert x.shape == (EXTENT[0], EXTENT[2], EXTENT[1], w.shape[1])


def test_sort_points_matches_numpy():
    """The kernel's index preparation: int32 keys of the valid points in
    ascending flat ``[X, Z, Y]`` order, each point once, the invalid ones
    last with key ``n_cells``; and the per-chunk point slices the kernel
    finds by binary search equal a brute-force count."""
    f, rel, in_box, _, _ = points(9, P=600)
    ex, ey, ez = EXTENT
    n_cells = ex * ey * ez
    ks, order = tf.sort_points(T(rel), T(in_box), EXTENT)
    ks, order = ks.numpy(), order.numpy()
    assert ks.dtype == np.int32 and sorted(order) == list(range(len(rel)))
    want = np.where(in_box, (rel[:, 0] * ez + rel[:, 2]) * ey + rel[:, 1], n_cells)
    np.testing.assert_array_equal(ks, want[order])
    assert np.all(np.diff(ks) >= 0) and np.sum(ks == n_cells) == np.sum(~in_box)
    ch = 128                                   # cells per chunk (csrc/featurizer.cu)
    starts = np.minimum(np.arange(0, n_cells + ch, ch), n_cells)
    brute = np.array([np.sum(ks < c) for c in starts])
    np.testing.assert_array_equal(np.searchsorted(ks, starts, side="left"), brute)
    for c0, p0, p1 in zip(starts[:-1], brute[:-1], brute[1:]):
        assert np.all((ks[p0:p1] >= c0) & (ks[p0:p1] < c0 + ch))


def test_featurizer_one_cell_and_last_cell():
    """All valid points in one cell (one long run), then points in the
    box's last cell and its first: against a numpy max + 1x1."""
    f, _, _, w, b = points(4, P=300)
    ex, ey, ez = EXTENT
    for cells in ([(3, 5, 7)], [(ex - 1, ey - 1, ez - 1), (0, 0, 0)]):
        rel = np.array([cells[i % len(cells)] for i in range(len(f))], np.int32)
        in_box = np.ones(len(f), bool)
        x, occ = tf.featurizer_fused(T(f), T(rel), T(in_box), T(w), T(b), EXTENT,
                                     torch.float32)
        assert int(occ.sum()) == len(cells)
        for i, (cx, cy, cz) in enumerate(cells):
            assert bool(occ[cx, cz, cy])
            want = f[i::len(cells)].max(0) @ w + b
            np.testing.assert_allclose(x[cx, cz, cy].numpy(), want, rtol=1e-5, atol=1e-5)
        assert not x[~occ].any()
