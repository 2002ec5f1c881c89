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


def _rna_tf32_numpy(v):
    """PTX ``cvt.rna.tf32.f32`` on the bit pattern, sign and magnitude
    apart: keep 10 mantissa bits, round half away from zero (a carry may
    run into the exponent), NaN stays NaN."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    sign, mag = bits & np.uint32(0x80000000), bits & np.uint32(0x7FFFFFFF)
    up = (mag & np.uint32(0x1FFF)) >= 0x1000
    mag = (mag & np.uint32(0xFFFFE000)) + np.where(up, np.uint32(0x2000), np.uint32(0))
    out = (sign | mag).view(np.float32)
    return np.where(np.isnan(v), v, out)


def _f32(bits):
    return np.array(bits, np.uint32).view(np.float32)


def test_tf32_split_matches_bit_level_rna():
    """The weight-split helper against a bit-level ``cvt.rna`` on
    hand-picked values: ties (away from zero, both signs), negatives,
    subnormals (a tie among them too), +-inf (lo = 0) and a tie whose
    rounding carries into the exponent (2 - 2^-11 -> 2)."""
    v = np.concatenate([
        np.array([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 1 + 2 ** -11 - 2 ** -23,
                  -3.14159, -1e-3, 0.0, -0.0, 2 - 2 ** -11, -(2 - 2 ** -11), 65504.5,
                  np.inf, -np.inf], np.float32),
        _f32([0x00000001, 0x00001000, 0x00003000, 0x80001FFF, 0x007FF000, 0x807FFFFF]),
    ]).astype(np.float32)
    hi, lo = (t.numpy() for t in tcc.tf32_split(torch.from_numpy(v)))
    want_hi = _rna_tf32_numpy(v)
    np.testing.assert_array_equal(hi.view(np.uint32), want_hi.view(np.uint32))
    fin = np.isfinite(v)
    with np.errstate(invalid="ignore"):
        want_lo = np.where(fin, _rna_tf32_numpy(np.where(fin, v - want_hi, 0)), 0)
    np.testing.assert_array_equal(lo.view(np.uint32), want_lo.astype(np.float32).view(np.uint32))
    assert hi[0] == 1 + 2 ** -10 and hi[1] == -(1 + 2 ** -10) and hi[2] == 1 + 2 ** -9
    assert hi[3] == 1.0 and hi[8] == 2.0 and hi[9] == -2.0
    assert hi[13] == _f32([0x00000000]) and hi[14] == _f32([0x00002000])   # subnormal tie
    assert hi[17] == _f32([0x00800000]) and hi[18] == -hi[17]   # carry to a normal
    assert np.all((hi.view(np.uint32) & 0x1FFF) == 0) and np.all((lo.view(np.uint32) & 0x1FFF) == 0)


def test_tf32_split_reconstructs_f32():
    """``hi + lo`` is the f32 input to within 2^-22 relative, over normal
    values of many magnitudes."""
    r = np.random.RandomState(3)
    v = (r.randn(100000) * 10.0 ** r.randint(-30, 30, 100000)).astype(np.float32)
    hi, lo = tcc.tf32_split(torch.from_numpy(v))
    err = np.abs(v.astype(np.float64) - hi.double().numpy() - lo.double().numpy())
    assert np.all(err <= 2.0 ** -22 * np.abs(v.astype(np.float64)))


_JAX_REFS = {}


def _jax_ref(capacity):
    if capacity not in _JAX_REFS:
        x, w, mask, b = _case(0, 32, 32, 16, 64, 32)
        with pltpu.force_tpu_interpret_mode():
            _JAX_REFS[capacity] = np.asarray(jpc.block_sparse_conv3(
                jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask),
                block_capacity=capacity, bias=jnp.asarray(b)), np.float64)
    return _JAX_REFS[capacity]


@pytest.mark.parametrize("products", [1, 2, 3])
def test_split_emulation_against_jax(products):
    """The kernel's arithmetic in plain PyTorch (three TF32 products) stays
    within ``1e-5 * max|ref|`` of the JAX function in interpret mode, the
    bound the card holds the kernel to; one TF32 product, or two (hi hi +
    hi lo), breaks it, so that bound tells the kernel's f32 accuracy from
    TF32."""
    x, w, mask, b = _case(0, 32, 32, 16, 64, 32)
    ref = _jax_ref(16)
    got = tcc.block_sparse_conv3_split(T(x), T(w), T(mask), 16, bias=T(b),
                                       products=products).numpy()
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    if products == 3:
        assert rel <= 1e-5, rel
    else:
        assert rel > 1e-5 and rel > 10 * 1e-5 / products, rel


def _image_to_weights(img, nb, nkc, c, d):
    """Inverse of the kernel's weight layout, derived from the A fragment
    (k position t of k8 step s is channel 4t + 2s of a 16-channel group,
    position t + 4 the next one) and wgmma's 128-byte K-major swizzle."""
    nd = -(-d // 64)
    u = img.reshape(nd, nkc, 27, nb, 2, 64, 8, 4)
    out = np.zeros((2, 27, nkc * nb * 32, nd * 64), np.float32)
    for n in range(64):
        for pc in range(8):
            lc = pc ^ (n % 8)
            for e in range(4):
                P = 4 * lc + e
                S, p = P // 8, P % 8
                ch = 16 * (S // 2) + 4 * (p % 4) + 2 * (S % 2) + p // 4
                for kc in range(nkc):
                    for b in range(nb):
                        out[:, :, kc * 64 + b * 32 + ch, n::64] = np.moveaxis(
                            u[:, kc, :, b, :, n, pc, e], 0, -1).transpose(1, 0, 2)
    return out[:, :, :c, :d]


@pytest.mark.parametrize("c,d", [(6, 16), (40, 48), (64, 64), (96, 80)])
def test_split_weight_image_layout(c, d):
    """The image the kernel streams holds exactly the split weights, each
    at the place the kernel's A fragment and wgmma's swizzle read it, with
    zeros past C and D."""
    r = np.random.RandomState(c + d)
    w = r.randn(27, c, d).astype(np.float32)
    img, nb, nkc = tcc.split_weight_image(T(w))
    cp = 32 if c <= 32 else -(-c // 64) * 64
    assert (nb, nkc) == (min(cp, 64) // 32, cp // min(cp, 64))
    assert img.numel() == 2 * 27 * cp * -(-d // 64) * 64
    hi, lo = (t.numpy() for t in tcc.tf32_split(T(w)))
    back = _image_to_weights(img.numpy(), nb, nkc, c, d)
    np.testing.assert_array_equal(back[0], hi)
    np.testing.assert_array_equal(back[1], lo)
    assert np.abs(img.numpy()).sum() == pytest.approx(np.abs(hi).sum() + np.abs(lo).sum(),
                                                      rel=1e-5)
