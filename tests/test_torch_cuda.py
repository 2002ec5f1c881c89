"""The CUDA kernels against their plain versions on the card, at small and
ragged shapes (tile edges in x, z and y, both conv tile geometries) and
every channel width of the flagship path, the differentiable training
conv's gradients likewise, a batch of scans through rows 1-3 in one
launch each (bit for bit the per-scan launches) and through row 4 once
per scan, the dense bottleneck's four launches (row 9) at the ladder's
stride-8 grids and on ragged ones, a batch against per-scan launches, its
refusals and its route (no ``F.conv3d`` at inference, none of its launches
in training), the traced forward (the program's spans and counters on: the
same outputs, device ms per stage), the whole forward (n_infers 1, 3 and, with the KITTI-360 widths,
2; a batch of two scans against the per-scan forwards) and one whole
train step with the kernels against the
plain versions on the CPU, the data-parallel step of two gloo ranks
sharing the card against the single-card step, and the WaffleIron
frontend (the forward and one train step) against the CPU.

Marked ``cuda``; each test skips without a CUDA device.  This file imports
no JAX, so it runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance for the conv-like kernels: bf16 in and out, so
``2e-2 * max|ref| + 2e-2`` at mask-valid cells (output rounding and another
summation order) and exact zeros elsewhere; extraction is bit-exact.
"""

import pytest
import torch

from pasco_torch import kernels
from pasco_torch.core.sparse import Box
from pasco_torch.ops import conv, deconv, down, extract
from pasco_torch.ops.dense_ops import maxpool2_mask, upsample2_mask

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _gen():
    return torch.Generator().manual_seed(0)


def _randn(g, dev, *shape, scale=1.0):
    return (torch.randn(shape, generator=g) * scale).to(dev, torch.bfloat16)


def _mask(g, dev, shape, p):
    return (torch.rand(shape, generator=g) < p).to(dev)


def _check(got, ref, mask):
    g, r = got.float(), ref.float()
    if mask.any():
        err = (g - r)[mask].abs().max().item()
        assert err <= 2e-2 * r[mask].abs().max().item() + 2e-2, err
    assert not (g[~mask] != 0).any()


# Conv cases beyond the ragged shapes: Z = 4 (s8) and Z = 8 (s4) boxes, an
# all-true and an all-false mask (every tile active / none: the kernel
# writes the zeros), and a box with more active tiles (288 of 4 x 4 x 16
# cells) than resident CTAs at every width (264 at C = 64, 132 at 128 and
# 256): the persistent walk wraps.
CONV_CASES = [((5, 12, 37), 0.4), ((6, 4, 20), 0.4), ((3, 32, 16), 0.4),
              ((9, 4, 44), 0.4), ((7, 8, 30), 0.4), ((6, 8, 33), 1.0),
              ((6, 8, 33), 0.0), ((72, 16, 64), 0.5)]


@pytest.mark.parametrize("shape,p", CONV_CASES)
@pytest.mark.parametrize("ci,co", [(64, 64), (128, 128), (256, 256)])
def test_masked_conv3_matches_plain(dev, shape, p, ci, co):
    """Both launch forms at every width: the full prologue/epilogue (BN
    affine, relu, bias, skip, relu) and the bare masked conv."""
    g = _gen()
    m = _mask(g, dev, shape, p)
    x = _randn(g, dev, *shape, ci)
    w = _randn(g, dev, 27, ci, co, scale=(27 * ci) ** -0.5)
    skip = _randn(g, dev, *shape, co)
    aff = (torch.rand(ci, generator=g).to(dev) + 0.5, torch.randn(ci, generator=g).to(dev) * 0.1)
    b = torch.randn(co, generator=g).to(dev) * 0.1
    before = kernels.LAUNCHES["masked_conv3"]
    for kw in (dict(bias=b, affine=aff, relu_in=True, skip=skip, relu_out=True), {}):
        _check(conv.masked_conv3(x, m, w, **kw), conv.masked_conv3_plain(x, m, w, **kw), m)
    assert kernels.LAUNCHES["masked_conv3"] == before + 2


def test_masked_conv3_refuses_other_widths(dev):
    """The kernel takes Ci = Co in {64, 128, 256} and raises on the rest."""
    m = torch.ones((4, 4, 16), dtype=torch.bool, device=dev)
    for ci, co in ((32, 128), (64, 128), (96, 96)):
        x = torch.zeros((4, 4, 16, ci), dtype=torch.bfloat16, device=dev)
        with pytest.raises(ValueError):
            conv.masked_conv3(x, m, torch.zeros((27, ci, co), dtype=torch.bfloat16,
                                                device=dev))


@pytest.mark.parametrize("shape,p", CONV_CASES)
@pytest.mark.parametrize("ch", [64, 128, 256])
def test_masked_conv3_fn_grads_match_plain(dev, shape, p, ch):
    """MaskedConv3Fn (kernel forward and dx, plain dw and db) against
    autograd of ``masked_conv3_plain``, at every residual/refiner width.
    dx is the kernel's flipped mode on the original weight."""
    g = _gen()
    m = _mask(g, dev, shape, p)
    x = _randn(g, dev, *shape, ch)
    w = _randn(g, dev, 27, ch, ch, scale=(27 * ch) ** -0.5).float()
    b = torch.randn(ch, generator=g).to(dev) * 0.1
    dy = _randn(g, dev, *shape, ch)
    before = kernels.LAUNCHES["conv3_dx"]
    out = []
    for fn in (lambda *a: conv.MaskedConv3Fn.apply(*a, None), conv.masked_conv3_plain):
        xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
        y = fn(xs, m, ws, bs)
        y.backward(dy)
        out.append((y.detach(), xs.grad, ws.grad, bs.grad))
    assert kernels.LAUNCHES["conv3_dx"] == before + 1
    (y, gx, gw, gb), (yr, gxr, gwr, gbr) = out
    _check(y, yr, m)
    _check(gx, gxr, m)
    every = torch.ones((27, ch), dtype=torch.bool, device=dev)
    if m.any():
        _check(gw, gwr, every)
        _check(gb, gbr, every[0])
    else:
        assert not gw.any() and not gb.any() and not gwr.any() and not gbr.any()


@pytest.mark.parametrize("ch", [64, 128, 256])
def test_conv3_dx_flip_matches_transposed_weight(dev, ch):
    """The flipped mode on ``w`` equals the forward mode on the explicit
    ``w.flip(0).transpose(1, 2)`` (an asymmetric weight, so a tap or a
    transpose missed by the flag shows)."""
    g = _gen()
    shape = (6, 8, 33)
    m = _mask(g, dev, shape, 0.7)
    dym = torch.where(m[..., None], _randn(g, dev, *shape, ch),
                      torch.zeros((), dtype=torch.bfloat16, device=dev))
    w = _randn(g, dev, 27, ch, ch, scale=(27 * ch) ** -0.5)
    got = conv.conv3_dx(dym, m, w)
    want = conv.masked_conv3(dym, m, w.flip(0).transpose(1, 2).contiguous())
    _check(got, want, m)
    _check(got, conv.masked_conv3_plain(dym, m, w.flip(0).transpose(1, 2)), m)


def _nan_pool(shape, dev):
    """Leave a NaN-filled block of ``shape`` (bf16) in the caching
    allocator, so that a kernel's ``torch.empty`` output of that size
    likely starts as NaNs: a cell the kernel fails to write then shows."""
    torch.full(shape, float("nan"), dtype=torch.bfloat16, device=dev)


# Down cases: a ragged last item (135 output cells), an empty and a full
# mask, and a box whose items (288 of 64 valid cells, 144 zero items)
# outnumber the resident CTAs at every width (264 at Co = 128, 132 at 256),
# once dense and once at ~4% valid output cells, as the scan's occupancy.
DOWN_CASES = [((6, 10, 18), 0.3), ((6, 10, 18), 0.0), ((6, 10, 18), 1.0),
              ((96, 16, 96), 0.5), ((96, 16, 96), 0.006)]


@pytest.mark.parametrize("shape,p", DOWN_CASES)
@pytest.mark.parametrize("ci,co", [(64, 128), (128, 256), (256, 256)])
def test_down2_fused_matches_plain(dev, shape, p, ci, co):
    g = _gen()
    m = _mask(g, dev, shape, p)
    m2 = maxpool2_mask(m)
    x = _randn(g, dev, *shape, ci)
    w = _randn(g, dev, 8, ci, co, scale=(8 * ci) ** -0.5)
    vec = lambda lo: (torch.rand(co, generator=g) + lo).to(dev)  # noqa: E731
    args = (x, m, m2, w, vec(-0.5), (vec(0.5), vec(-0.5)), (vec(0.5), vec(-0.5)))
    before = kernels.LAUNCHES["down2_fused"]
    _nan_pool((*m2.shape, co), dev)
    _check(down.down2_fused(*args), down.down2_fused_plain(*args), m2)
    assert kernels.LAUNCHES["down2_fused"] == before + 1


def test_down2_fused_refuses_other_widths(dev):
    m = torch.ones((4, 4, 4), dtype=torch.bool, device=dev)
    for ci, co in ((32, 64), (64, 64), (256, 128)):
        x = torch.zeros((4, 4, 4, ci), dtype=torch.bfloat16, device=dev)
        w = torch.zeros((8, ci, co), dtype=torch.bfloat16, device=dev)
        v = torch.zeros(co, device=dev)
        with pytest.raises(ValueError):
            down.down2_fused(x, m, maxpool2_mask(m), w, v, (v, v), (v, v))


# Up cases (parent box; keep, child and skip densities): a ragged last tile
# (66 parents), an empty and a full union, and a box of 144 128-parent
# tiles (more than the 132 resident CTAs), once near dense and once sparse
# (most tiles inactive: the kernel writes their zeros).
UP_CASES = [((3, 2, 11), 0.6, 0.8, 0.3), ((3, 2, 11), 0.0, 0.0, 0.0),
            ((3, 2, 11), 1.0, 1.0, 1.0), ((36, 8, 64), 0.6, 0.9, 0.3),
            ((36, 8, 64), 0.01, 0.8, 0.005)]


@pytest.mark.parametrize("pshape,pk,pc,ps", UP_CASES)
@pytest.mark.parametrize("ci,co", [(128, 64), (256, 128), (256, 256)])
def test_up_preamble_matches_plain(dev, pshape, pk, pc, ps, ci, co):
    """Against the plain version on a box with a negative corner."""
    g = _gen()
    X2, Z2, Y2 = pshape
    cshape = (2 * X2, 2 * Z2, 2 * Y2)
    pkeep = _mask(g, dev, pshape, pk)
    child = upsample2_mask(pkeep) & _mask(g, dev, cshape, pc)
    skip_mask = _mask(g, dev, cshape, ps)
    union = child | skip_mask
    skip = torch.where(skip_mask[..., None], _randn(g, dev, *cshape, co),
                       torch.zeros((), dtype=torch.bfloat16, device=dev))
    box = Box.create(torch.tensor([-16, 8, -8], device=dev),
                     (2 * cshape[0], 2 * cshape[2], 2 * cshape[1]))
    vec = lambda n, lo: (torch.rand(n, generator=g) + lo).to(dev)  # noqa: E731
    args = (_randn(g, dev, X2, Z2, Y2, ci), pkeep, child, union, skip, box, 2,
            _randn(g, dev, 8, ci, co, scale=ci ** -0.5), vec(co, -0.5),
            (vec(co, 0.5), vec(co, -0.5)), (vec(co + 3, 0.5), vec(co + 3, -0.5)),
            _randn(g, dev, co + 3, co, scale=0.1), vec(co, -0.5))
    before = kernels.LAUNCHES["up_preamble"]
    _nan_pool((*cshape, co), dev)
    _check(deconv.up_preamble(*args), deconv.up_preamble_plain(*args), union)
    assert kernels.LAUNCHES["up_preamble"] == before + 1


@pytest.mark.parametrize("n_shape,cap,e", [((7, 9, 33), 500, 20), ((40, 8, 40), 9000, 0),
                                           ((16, 16, 16), 100000, 64)])
def test_stream_extract_bit_exact(dev, n_shape, cap, e):
    g = _gen()
    keep = _mask(g, dev, n_shape, 0.5)
    pay = _randn(g, dev, *n_shape, e) if e else None
    got = extract.stream_extract(keep, cap, pay)
    ref = extract.stream_extract_plain(keep, cap, pay)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and torch.equal(a, b)


def _nan_blocks(dev, *nbytes):
    """Leave NaN-filled blocks of these sizes in the caching allocator, so
    that outputs of those sizes allocated next (``torch.empty``) likely start
    as NaN bits: a byte the kernel fails to write then shows."""
    blocks = [torch.full((max(1, -(-n // 2)),), float("nan"), dtype=torch.bfloat16,
                         device=dev) for n in nbytes]
    del blocks


def _extract_checked(keep, cap, pay):
    """One ``stream_extract`` call on NaN-poisoned outputs, exactly one
    counted launch, bit-exact against the plain version."""
    dev = keep.device
    e = 0 if pay is None else pay.shape[-1]
    _nan_blocks(dev, cap * e * 2, cap * 4, cap, 4)
    before = kernels.LAUNCHES["stream_extract"]
    got = extract.stream_extract(keep, cap, pay)
    assert kernels.LAUNCHES["stream_extract"] == before + 1
    ref = extract.stream_extract_plain(keep, cap, pay)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    return got


# Edge cases: (label, keep shape, keep density, cap; None = the kept count,
# E).  16384 cells make one tile; 13 x 29 x 61 is more than one and not a
# multiple of it.
EXTRACT_EDGES = [
    ("empty keep", (16, 8, 32), 0.0, 1000, 20),
    ("all kept, cap < total", (16, 8, 40), 1.0, 3000, 20),
    ("cap == total", (16, 8, 40), 0.4, None, 64),
    ("ragged n", (13, 29, 61), 0.5, 9000, 20),
    ("ragged n, rows only", (13, 29, 61), 0.5, 16000, 0),
    ("one cell", (1, 1, 1), 1.0, 5, 3),
    ("odd E, many tiles", (64, 16, 97), 0.3, 50000, 5),
    ("cap binds in the first tile", (64, 16, 97), 0.9, 700, 20),
]


@pytest.mark.parametrize("label,shape,p,cap,e", EXTRACT_EDGES,
                         ids=[c[0] for c in EXTRACT_EDGES])
def test_stream_extract_edge_cases(dev, label, shape, p, cap, e):
    g = _gen()
    keep = _mask(g, dev, shape, p)
    cap = int(keep.sum()) if cap is None else cap
    pay = _randn(g, dev, *shape, e) if e else None
    vals, src, valid, total = _extract_checked(keep, cap, pay)
    assert int(total) == int(keep.sum())


def test_stream_extract_back_to_back(dev):
    """20 calls on one stream without a synchronisation between them,
    alternating shapes, caps and E (0, 20, 64), then each against the plain
    version: bit-exact, which shows that the look-back flags (epoch-tagged)
    and the ticket carry nothing from one call to the next."""
    g = _gen()
    shapes = [(40, 8, 40), (13, 7, 61), (88, 32, 88), (5, 3, 7)]
    calls = []
    for i in range(20):
        shape = shapes[i % len(shapes)]
        e = (0, 20, 64)[i % 3]
        keep = _mask(g, dev, shape, (0.2, 0.7, 0.0, 1.0, 0.5)[i % 5])
        pay = _randn(g, dev, *shape, e) if e else None
        cap = (100, 5000, 30000, 250000)[i % 4]
        calls.append((keep, cap, pay))
    before = kernels.LAUNCHES["stream_extract"]
    outs = [extract.stream_extract(*c) for c in calls]
    assert kernels.LAUNCHES["stream_extract"] == before + len(calls)
    for (keep, cap, pay), got in zip(calls, outs):
        ref = extract.stream_extract_plain(keep, cap, pay)
        for a, b in zip(got, ref):
            assert a.shape == b.shape and torch.equal(a, b)


def _column_case(g, dev, shape, c, d, p):
    m = _mask(g, dev, shape, p)
    x = torch.where(m[..., None], torch.randn((*shape, c), generator=g).to(dev),
                    torch.zeros((), device=dev))
    w = torch.randn((27, c, d), generator=g).to(dev) * (27 * c) ** -0.5
    b = torch.randn(d, generator=g).to(dev) * 0.1
    return x, w, m, b


@pytest.mark.parametrize("shape,p", [((16, 16, 8), 0.02), ((20, 13, 5), 0.05),
                                     ((24, 40, 32), 0.01), ((9, 9, 3), 0.3)])
@pytest.mark.parametrize("c,d", [(64, 64), (16, 32), (40, 48), (6, 16)])
@pytest.mark.parametrize("part", [1.0, 0.5])
def test_column_conv3_matches_plain(dev, shape, p, c, d, part):
    """Row 7: ragged column grids (X, Y not multiples of 8), Z not a
    multiple of the kernel's z-slab, C not a multiple of 8 or of its
    channel chunk, and a capacity at half the occupied columns.  Bound
    ``1e-5 * max|ref|`` at visited cells: f32 and the kernel's three TF32
    products read ~5e-7, one or two TF32 products >= 1.9e-4; elsewhere
    exactly the bias at mask cells and 0."""
    from pasco_torch.ops import column_conv as cc

    g = _gen()
    x, w, m, b = _column_case(g, dev, shape, c, d, p)
    n_occ = int(cc.active_columns(m, 10 ** 6)[1])
    cap = max(1, int(n_occ * part))
    before = kernels.LAUNCHES["column_conv3"]
    got = cc.block_sparse_conv3(x, w, m, cap, bias=b)
    assert kernels.LAUNCHES["column_conv3"] == before + 1
    ref = cc.block_sparse_conv3_plain(x, w, m, cap, bias=b)
    ids, n = cc.active_columns(m, cap)
    vis = cc.visited_cells(ids, n, shape[0], shape[1])[..., None].expand(shape)
    assert (got - ref)[vis].abs().max() <= 1e-5 * ref[vis].abs().max()
    rest = torch.where(m[..., None], b, torch.zeros((), device=dev))[~vis]
    assert torch.equal(got[~vis], rest) and torch.equal(ref[~vis], rest)


@pytest.mark.parametrize("c,d,cd", [(96, 80, None), (64, 64, torch.bfloat16)])
def test_column_conv3_wide_and_bf16(dev, c, d, cd):
    """Row 7 beyond one channel chunk and one output tile (C = 96: two
    64-channel halos; D = 80: two items per slab), and with bf16-rounded
    inputs (their TF32 ``lo`` is 0), within the bound above."""
    from pasco_torch.ops import column_conv as cc

    x, w, m, b = _column_case(_gen(), dev, (20, 13, 9), c, d, 0.05)
    got = cc.block_sparse_conv3(x, w, m, 100, bias=b, compute_dtype=cd)
    ref = cc.block_sparse_conv3_plain(x, w, m, 100, bias=b, compute_dtype=cd)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_column_conv3_empty_mask(dev):
    from pasco_torch.ops import column_conv as cc

    x, w, m, b = _column_case(_gen(), dev, (16, 24, 8), 64, 64, 0.0)
    assert not cc.block_sparse_conv3(x, w, m, 6, bias=b).any()


def test_column_conv3_plain_ignores_global_tf32(dev):
    """The plain version states its precision: with cuDNN's global TF32
    flag at PyTorch's default (True) it still computes in f32."""
    from pasco_torch.ops import column_conv as cc

    x, w, m, b = _column_case(_gen(), dev, (24, 40, 32), 64, 64, 0.01)
    want = cc.block_sparse_conv3_plain(x, w, m, 100, bias=b)
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = cc.block_sparse_conv3_plain(x, w, m, 100, bias=b)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert torch.equal(got, want)


def _points(g, dev, P, F, extent, p_valid=0.9):
    rel = torch.stack([torch.randint(0, e, (P,), generator=g) for e in extent], 1)
    rel[: P // 3] = rel[P // 3: 2 * (P // 3)] // 2      # crowded cells
    f = torch.randn((P, F), generator=g) * 3
    return f.to(dev), rel.int().to(dev), (torch.rand(P, generator=g) < p_valid).to(dev)


@pytest.mark.parametrize("P,F,C,extent", [(5000, 64, 64, (24, 40, 16)),
                                          (777, 16, 32, (5, 7, 3)),
                                          (3000, 128, 256, (16, 16, 16))])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_featurizer_matches_plain(dev, P, F, C, extent, dtype):
    """Row 8 against the model's featurizer chain: occupancy identical,
    values at occupied cells within the bf16 bound (f32: ``1e-4 *
    max|ref| + 1e-5``), exact zeros elsewhere."""
    from pasco_torch.ops import featurizer as fz

    g = _gen()
    f, rel, in_box = _points(g, dev, P, F, extent)
    w = (torch.randn((F, C), generator=g) * F ** -0.5).to(dev)
    b = (torch.randn(C, generator=g) * 0.1).to(dev)
    before = kernels.LAUNCHES["featurizer"]
    x, occ = fz.featurizer_fused(f, rel, in_box, w, b, extent, dtype)
    assert kernels.LAUNCHES["featurizer"] == before + 1
    xr, occr = fz.featurizer_fused_plain(f, rel, in_box, w, b, extent, dtype)
    assert x.dtype == dtype and torch.equal(occ, occr) and occ.sum() < in_box.sum()
    if dtype == torch.bfloat16:
        _check(x, xr, occ)
    else:
        err = (x - xr)[occ].abs().max()
        assert err <= 1e-4 * xr[occ].abs().max() + 1e-5, err
        assert not x[~occ].any()


def test_featurizer_empty_scan(dev):
    from pasco_torch.ops import featurizer as fz

    g = _gen()
    f, rel, in_box = _points(g, dev, 500, 64, (8, 16, 8), p_valid=0.0)
    w, b = torch.ones((64, 64), device=dev), torch.ones(64, device=dev)
    x, occ = fz.featurizer_fused(f, rel, in_box, w, b, (8, 16, 8))
    assert not occ.any() and not x.any()


def _featurizer_checked(dev, f, rel, in_box, extent, dtype=torch.bfloat16, C=64):
    """One ``featurizer_fused`` call over NaN-poisoned outputs, one counted
    launch; occupancy identical to the plain version's, values within the
    bf16 bound at occupied cells, exact zeros elsewhere."""
    from pasco_torch.ops import featurizer as fz

    g = _gen()
    F = f.shape[1]
    w = (torch.randn((F, C), generator=g) * F ** -0.5).to(dev)
    b = (torch.randn(C, generator=g) * 0.1).to(dev)
    ex, ey, ez = extent
    _nan_blocks(dev, ex * ey * ez * C * dtype.itemsize, ex * ey * ez)
    before = kernels.LAUNCHES["featurizer"]
    x, occ = fz.featurizer_fused(f, rel, in_box, w, b, extent, dtype)
    assert kernels.LAUNCHES["featurizer"] == before + 1
    xr, occr = fz.featurizer_fused_plain(f, rel, in_box, w, b, extent, dtype)
    assert torch.equal(occ, occr)
    _check(x, xr, occ)
    return x, occ


def test_featurizer_one_long_run(dev):
    """Every point in one cell: one run of 20000 points, split over
    segments and warps, merged by the shared max."""
    g = _gen()
    extent = (24, 40, 16)
    f = (torch.randn((20000, 64), generator=g) * 3).to(dev)
    rel = torch.tensor([[5, 17, 9]], dtype=torch.int32).expand(20000, 3).contiguous().to(dev)
    x, occ = _featurizer_checked(dev, f, rel, torch.ones(20000, dtype=torch.bool, device=dev),
                                 extent)
    assert int(occ.sum()) == 1 and bool(occ[5, 9, 17])


def test_featurizer_last_cell(dev):
    """Points in the box's last cell (the last, ragged chunk) and its first,
    with bf16 features."""
    g = _gen()
    extent = (7, 9, 5)                       # 315 cells: chunks of 128 leave 59
    ex, ey, ez = extent
    rel = torch.tensor([[ex - 1, ey - 1, ez - 1]] * 30 + [[0, 0, 0]] * 3, dtype=torch.int32)
    f = (torch.randn((33, 32), generator=g) * 3).to(dev, torch.bfloat16)
    x, occ = _featurizer_checked(dev, f, rel.to(dev), torch.ones(33, dtype=torch.bool,
                                                                 device=dev), extent)
    assert int(occ.sum()) == 2 and bool(occ[-1, -1, -1]) and bool(occ[0, 0, 0])


def test_featurizer_scan_box_nan_pool(dev):
    """A scan-sized point set in the flagship box (352, 352, 32) over a
    NaN-filled allocator block of the volume's size: every cell written."""
    g = _gen()
    extent = (352, 352, 32)
    P = 120000
    rel = torch.stack([torch.randint(0, e, (P,), generator=g) for e in extent], 1)
    rel[: P // 2] = rel[P // 2:] // 4 * 4                    # crowded cells
    f = (torch.randn((P, 64), generator=g) * 3).to(dev)
    in_box = (torch.rand(P, generator=g) < 0.95).to(dev)
    x, occ = _featurizer_checked(dev, f, rel.int().to(dev), in_box, extent)
    assert 0 < int(occ.sum()) < int(in_box.sum())


# The smaller boxes of the flagship's ladder (SceneConfig.box_candidates):
# every kernel of the inference path at the extents AdaptiveForward gives it
# there ([X, Z, Y] = side / scale, 32 / scale, side / scale).
LADDER = (256, 288, 320)


def _ladder_shape(side, scale):
    return (side // scale, 32 // scale, side // scale)


@pytest.mark.parametrize("side", LADDER)
@pytest.mark.parametrize("scale,ch", [(1, 64), (2, 128), (4, 256), (8, 256)])
def test_masked_conv3_at_ladder_boxes(dev, side, scale, ch):
    """The res-block conv2 form (prologue, bias, skip, relu) at every stage
    extent of the box; at s8, Y = 32, 36 and 40 leave last y tiles of 16, 4
    and 8 rows."""
    g = _gen()
    shape = _ladder_shape(side, scale)
    m = _mask(g, dev, shape, 0.5)
    x = _randn(g, dev, *shape, ch)
    w = _randn(g, dev, 27, ch, ch, scale=(27 * ch) ** -0.5)
    kw = dict(bias=torch.randn(ch, generator=g).to(dev) * 0.1,
              affine=(torch.rand(ch, generator=g).to(dev) + 0.5,
                      torch.randn(ch, generator=g).to(dev) * 0.1),
              relu_in=True, skip=_randn(g, dev, *shape, ch), relu_out=True)
    _nan_pool((*shape, ch), dev)
    _check(conv.masked_conv3(x, m, w, **kw), conv.masked_conv3_plain(x, m, w, **kw), m)


@pytest.mark.parametrize("side", LADDER)
@pytest.mark.parametrize("scale,ci,co", [(1, 64, 128), (2, 128, 256), (4, 256, 256)])
@pytest.mark.parametrize("p", [0.5, 0.03])
def test_down2_fused_at_ladder_boxes(dev, side, scale, ci, co, p):
    """enc_s2/s4/s8 at the box (even extents at every input), near dense
    and at a scan-like occupancy."""
    g = _gen()
    shape = _ladder_shape(side, scale)
    m = _mask(g, dev, shape, p)
    m2 = maxpool2_mask(m)
    vec = lambda lo: (torch.rand(co, generator=g) + lo).to(dev)  # noqa: E731
    args = (_randn(g, dev, *shape, ci), m, m2, _randn(g, dev, 8, ci, co, scale=(8 * ci) ** -0.5),
            vec(-0.5), (vec(0.5), vec(-0.5)), (vec(0.5), vec(-0.5)))
    _nan_pool((*m2.shape, co), dev)
    _check(down.down2_fused(*args), down.down2_fused_plain(*args), m2)


@pytest.mark.parametrize("side", LADDER)
@pytest.mark.parametrize("scale,ci,co", [(4, 256, 256), (2, 256, 128), (1, 128, 64)])
def test_up_preamble_at_ladder_boxes(dev, side, scale, ci, co):
    """dec_s4/s2/s1 at the box: the parent extent at 2 * scale, a near-dense
    child set and a sparse skip, a box corner below the origin."""
    g = _gen()
    cshape = _ladder_shape(side, scale)
    pshape = _ladder_shape(side, 2 * scale)
    pkeep = _mask(g, dev, pshape, 0.8)
    child = upsample2_mask(pkeep) & _mask(g, dev, cshape, 0.9)
    skip_mask = _mask(g, dev, cshape, 0.05)
    union = child | skip_mask
    skip = torch.where(skip_mask[..., None], _randn(g, dev, *cshape, co),
                       torch.zeros((), dtype=torch.bfloat16, device=dev))
    box = Box.create(torch.tensor([-8, 16, -4], device=dev), (side, side, 32))
    vec = lambda n, lo: (torch.rand(n, generator=g) + lo).to(dev)  # noqa: E731
    args = (_randn(g, dev, *pshape, ci), pkeep, child, union, skip, box, scale,
            _randn(g, dev, 8, ci, co, scale=ci ** -0.5), vec(co, -0.5),
            (vec(co, 0.5), vec(co, -0.5)), (vec(co + 3, 0.5), vec(co + 3, -0.5)),
            _randn(g, dev, co + 3, co, scale=0.1), vec(co, -0.5))
    _nan_pool((*cshape, co), dev)
    _check(deconv.up_preamble(*args), deconv.up_preamble_plain(*args), union)


@pytest.mark.parametrize("side", LADDER)
@pytest.mark.parametrize("p,cap,e", [(0.9, 400000, 20), (0.1, 150016, 64), (0.5, 400000, 0)])
def test_stream_extract_at_ladder_boxes(dev, side, p, cap, e):
    """s1 of the box: 128, 162 and 200 tiles; the decoder cap binding, a
    refiner payload, rows only."""
    g = _gen()
    shape = _ladder_shape(side, 1)
    keep = _mask(g, dev, shape, p)
    _extract_checked(keep, cap, _randn(g, dev, *shape, e) if e else None)


def test_stream_extract_alternating_boxes(dev):
    """20 calls back to back at s1 of 352 -> 256 -> 320 -> 288 (the tile
    count falls and rises on one workspace), then each bit-exact against
    the plain version."""
    g = _gen()
    sides = (352, 256, 320, 288)
    calls = {s: (_mask(g, dev, _ladder_shape(s, 1), 0.8), 400000,
                 _randn(g, dev, *_ladder_shape(s, 1), 20)) for s in sides}
    outs = [(sides[i % 4], extract.stream_extract(*calls[sides[i % 4]])) for i in range(20)]
    for side, got in outs:
        ref = extract.stream_extract_plain(*calls[side])
        for a, b in zip(got, ref):
            assert a.shape == b.shape and torch.equal(a, b), side


def test_forward_box_288_against_352(dev):
    """The flagship forward (seeded random init) of bench.py's third scan,
    which picks the 288 box, through 288 and through 352
    (``chip_smoke.two_boxes_check``: kept cells identical, logits within the
    bf16 bound)."""
    import chip_smoke as cs
    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.models.unet import build_net

    cfg = PaSCoConfig()
    scan = cs.make_scans(cfg, 3, dev)[2]
    assert cs.box_of(cfg, scan[0]) == (288, 288, 32)
    net = build_net(cfg, dev)
    net.reset_parameters(torch.Generator().manual_seed(0))
    cs.two_boxes_check(cfg, net, scan, (288, 288, 32))


# --------------------------------------------------------------------------
# a batch of scans: rows 1-3 in one launch, row 4 once per scan
# --------------------------------------------------------------------------


def _batch_masks(g, dev, shape, ps):
    return torch.stack([_mask(g, dev, shape, p) for p in ps])


def _counted(name, fn, n):
    before = kernels.LAUNCHES[name]
    out = fn()
    assert kernels.LAUNCHES[name] == before + n, (name, kernels.LAUNCHES[name] - before)
    return out


@pytest.mark.parametrize("shape", [(9, 8, 37), (72, 16, 64)])
@pytest.mark.parametrize("ch", [64, 128, 256])
def test_masked_conv3_batch_one_launch_equals_per_scan(dev, shape, ch):
    """Three scans (one with no valid cell) in one launch: each scan bit
    for bit its own launch, and within the bound of the plain version;
    every cell written (a NaN-filled pool underneath)."""
    g = _gen()
    m = _batch_masks(g, dev, shape, (0.4, 0.0, 0.7))
    x, skip = _randn(g, dev, 3, *shape, ch), _randn(g, dev, 3, *shape, ch)
    w = _randn(g, dev, 27, ch, ch, scale=(27 * ch) ** -0.5)
    kw = dict(bias=torch.randn(ch, generator=g).to(dev) * 0.1, relu_in=True, relu_out=True,
              affine=(torch.rand(ch, generator=g).to(dev) + 0.5,
                      torch.randn(ch, generator=g).to(dev) * 0.1))
    _nan_pool((3, *shape, ch), dev)
    got = _counted("masked_conv3", lambda: conv.masked_conv3(x, m, w, skip=skip, **kw), 1)
    for b in range(3):
        assert torch.equal(got[b], conv.masked_conv3(x[b], m[b], w, skip=skip[b], **kw)), b
    _check(got, conv.masked_conv3_plain(x, m, w, skip=skip, **kw), m)
    dym = torch.where(m[..., None], x, torch.zeros((), dtype=x.dtype, device=dev))
    dx = conv.conv3_dx(dym, m, w)
    for b in range(3):
        assert torch.equal(dx[b], conv.conv3_dx(dym[b], m[b], w)), b


@pytest.mark.parametrize("shape,ps", [((6, 10, 18), (0.3, 0.0, 1.0)),
                                      ((96, 16, 96), (0.006, 0.5, 0.02))])
@pytest.mark.parametrize("ci,co", [(64, 128), (128, 256), (256, 256)])
def test_down2_fused_batch_one_launch_equals_per_scan(dev, shape, ps, ci, co):
    g = _gen()
    m = _batch_masks(g, dev, shape, ps)
    m2 = maxpool2_mask(m)
    x = _randn(g, dev, 3, *shape, ci)
    vec = lambda lo: (torch.rand(co, generator=g) + lo).to(dev)  # noqa: E731
    rest = (_randn(g, dev, 8, ci, co, scale=(8 * ci) ** -0.5), vec(-0.5),
            (vec(0.5), vec(-0.5)), (vec(0.5), vec(-0.5)))
    _nan_pool((*m2.shape, co), dev)
    got = _counted("down2_fused", lambda: down.down2_fused(x, m, m2, *rest), 1)
    for b in range(3):
        assert torch.equal(got[b], down.down2_fused(x[b], m[b], m2[b], *rest)), b
    _check(got, down.down2_fused_plain(x, m, m2, *rest), m2)


@pytest.mark.parametrize("pshape,pk,pc,ps", [((3, 2, 11), 0.6, 0.8, 0.3),
                                             ((36, 8, 64), 0.6, 0.9, 0.3)])
@pytest.mark.parametrize("ci,co", [(128, 64), (256, 128), (256, 256)])
def test_up_preamble_batch_one_launch_equals_per_scan(dev, pshape, pk, pc, ps, ci, co):
    """Three scans, each at its own box corner (one of them with an empty
    union): each bit for bit its own launch at that corner, within the
    bound of the plain version; with the corners permuted the plain
    version moves."""
    g = _gen()
    X2, Z2, Y2 = pshape
    cshape = (2 * X2, 2 * Z2, 2 * Y2)
    pkeep = _batch_masks(g, dev, pshape, (pk, 0.0, pk))
    child = upsample2_mask(pkeep) & _batch_masks(g, dev, cshape, (pc, pc, pc))
    union = child | _batch_masks(g, dev, cshape, (ps, 0.0, ps))
    skip = torch.where(union[..., None], _randn(g, dev, 3, *cshape, co),
                       torch.zeros((), dtype=torch.bfloat16, device=dev))
    mins = torch.tensor([[-16, 8, -8], [0, 0, 0], [40, -24, 6]], dtype=torch.int32, device=dev)
    extent = (2 * cshape[0], 2 * cshape[2], 2 * cshape[1])
    vec = lambda n, lo: (torch.rand(n, generator=g) + lo).to(dev)  # noqa: E731
    w = (_randn(g, dev, 8, ci, co, scale=ci ** -0.5), vec(co, -0.5),
         (vec(co, 0.5), vec(co, -0.5)), (vec(co + 3, 0.5), vec(co + 3, -0.5)),
         _randn(g, dev, co + 3, co, scale=0.1), vec(co, -0.5))
    parent = _randn(g, dev, 3, X2, Z2, Y2, ci)
    args = (parent, pkeep, child, union, skip, Box.create(mins, extent), 2, *w)
    _nan_pool((3, *cshape, co), dev)
    got = _counted("up_preamble", lambda: deconv.up_preamble(*args), 1)
    for b in range(3):
        one = deconv.up_preamble(parent[b], pkeep[b], child[b], union[b], skip[b],
                                 Box.create(mins[b], extent), 2, *w)
        assert torch.equal(got[b], one), b
    ref = deconv.up_preamble_plain(*args)
    _check(got, ref, union)
    moved = deconv.up_preamble_plain(parent, pkeep, child, union, skip,
                                     Box.create(mins.roll(1, 0), extent), 2, *w)
    assert not torch.equal(moved[0], ref[0])


def test_stream_extract_batch_launches_per_scan(dev):
    g = _gen()
    keep = _batch_masks(g, dev, (40, 8, 40), (0.5, 0.0, 0.05))
    pay = _randn(g, dev, 3, 40, 8, 40, 20)
    got = _counted("stream_extract", lambda: extract.stream_extract(keep, 9000, pay), 3)
    for b in range(3):
        one = extract.stream_extract(keep[b], 9000, pay[b])
        for a, o in zip(got, one):
            assert torch.equal(a[b], o), b
    for a, r in zip(got, extract.stream_extract_plain(keep, 9000, pay)):
        assert a.shape == r.shape and torch.equal(a, r)


def test_batched_forward_on_card(dev):
    """The flagship forward (seeded random init) on a batch of two of
    bench.py's scans (distinct box corners) against each scan's own
    forward (``chip_smoke.batch_forward_check``), with no host sync."""
    import chip_smoke as cs
    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.models.unet import build_net, stack_inputs

    cfg = PaSCoConfig()
    scans = cs.make_scans(cfg, 2, dev)
    net = build_net(cfg, dev)
    net.reset_parameters(torch.Generator().manual_seed(0))
    cs.batch_forward_check(cfg, net, scans)
    bench = cs._script("bench")
    with torch.no_grad():
        assert bench.host_syncs(lambda: bench.reduced(net(stack_inputs(
            [inp for _, inp in scans])))) == []


def test_traced_forward_on_card(dev):
    """The flagship S=3 forward (seeded random init) of bench.py's first
    scan through ``AdaptiveForward`` with the program's tracing on: the
    outputs are bit for bit those with it off; the stage spans carry device
    ms from CUDA events and their sum is within 3% of the dispatch's; the
    kernel spans carry none and sit in the stages; the root row's launches
    equal the kernel spans by name; ``masked_conv3.tile_cells`` counts 256
    cells a listed tile."""
    import dataclasses

    import chip_smoke as cs
    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.inference.dispatch import AdaptiveForward
    from pasco_torch.models.unet import build_net
    from pasco_torch.utils import timing

    cfg = PaSCoConfig()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, n_infers=3))
    col, inp = cs.make_scans(cfg, 1, dev)[0]
    net = build_net(cfg, dev)
    net.reset_parameters(torch.Generator().manual_seed(0))
    fwd = AdaptiveForward(net)
    box = cs.box_of(cfg, col)

    def flat(v):
        if isinstance(v, torch.Tensor):
            return [v]
        if isinstance(v, dict):
            v = list(v.values())
        elif hasattr(v, "__dataclass_fields__"):
            v = [getattr(v, k) for k in v.__dataclass_fields__]
        return [t for x in v for t in flat(x)] if isinstance(v, (list, tuple)) else []

    timing.drain()
    with torch.no_grad():
        fwd(inp, box)
        off = flat(fwd(inp, box))
        timing.tracing(True)
        try:
            on = flat(fwd(inp, box))
        finally:
            timing.tracing(False)
    got = timing.drain()
    assert len(off) == len(on) > 20 and all(torch.equal(a, b) for a, b in zip(off, on))
    rows = got["rows"]
    root = rows[0]
    stages = [r for r in rows if r["parent"] == root["id"]]
    ids = {r["id"] for r in stages}
    kernel_rows = [r for r in rows if r["name"].startswith("pasco.kernel.")]
    assert len(stages) == 10 and all(r["device_ms"] > 0 for r in [root] + stages)
    assert abs(sum(r["device_ms"] for r in stages) - root["device_ms"]) \
        <= 0.03 * root["device_ms"]
    assert kernel_rows and all(r["device_ms"] is None and r["parent"] in ids
                               for r in kernel_rows)
    by_name = {}
    for r in kernel_rows:
        key = r["name"][len("pasco.kernel."):]
        by_name[key] = by_name.get(key, 0) + 1
    assert root["launches"] == by_name and by_name["masked_conv3"] == 60
    cells = got["counters"][0]["masked_conv3.tile_cells"]
    assert cells > 0 and cells % 256 == 0


def test_wrappers_raise_on_wrong_input(dev):
    x = torch.zeros((4, 4, 4, 64), device=dev)           # f32, not bf16
    m = torch.ones((4, 4, 4), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        conv.masked_conv3(x, m, torch.zeros((27, 64, 64), device=dev))
    with pytest.raises(ValueError):
        extract.stream_extract(m, 10, x)


# --------------------------------------------------------------------------
# row 9: spc_dense3d, the dense bottleneck (SPCDense3D at inference)
# --------------------------------------------------------------------------


def _spc_case(dev, shape, ch, seed=0):
    """``x [B, X, Z, Y, C]`` bf16, the module's kernels and packed affines
    (random running statistics in every BN)."""
    import chip_smoke as cs

    m = cs.spc_module(ch, seed).to(dev)
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(shape + (ch,), generator=g).to(dev, torch.bfloat16)
    return m, x, cs.spc_weights(m), m.affines()


def _spc_check(got, ref):
    """The kernel against the plain version on the card: both sum the same
    bf16 products in f32, in another order; x1, t and s are rounded to bf16
    between launches, where a one-ulp flip moves what follows."""
    err = (got - ref).abs().max().item()
    assert err <= 5e-3 * ref.abs().max().item() + 1e-3, err
    assert (got - ref).norm().item() <= 1e-3 * ref.norm().item()


@pytest.mark.parametrize("side", (36, 40, 44))
@pytest.mark.parametrize("B", (1, 2))
@pytest.mark.parametrize("ch", (128, 256))
def test_spc_dense3d_matches_plain_at_ladder_grids(dev, side, B, ch):
    """The four launches against the plain version at the stride-8 grids of
    the 288, 320 and 352 boxes ([X, Z, Y] = side, 4, side), every output
    cell written (a NaN-filled pool underneath); at Z = 4 the (5, 5, 3) and
    (7, 7, 5) convs skip the taps that reach only padding."""
    from pasco_torch.ops import spc_dense3d as sd

    m, x, w, aff = _spc_case(dev, (B, side, 4, side), ch)
    _nan_pool(x.shape, dev)
    torch.full(x.shape, float("nan"), device=dev)               # and one of f32
    got = _counted("spc_dense3d", lambda: sd.spc_dense3d(x, w, aff), 4)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    _spc_check(got, sd.spc_dense3d_plain(x, w, aff))


@pytest.mark.parametrize("shape", [(1, 5, 2, 7), (2, 3, 1, 9), (1, 12, 4, 11), (1, 1, 3, 130)])
@pytest.mark.parametrize("ch", (64, 192))
def test_spc_dense3d_matches_plain_small_grids(dev, shape, ch):
    """Ragged grids (a tile of 128 raster cells over several x lines, a
    plane of one x line, Z = 1, 2, 3 and 4) at the 64-channel blocks."""
    from pasco_torch.ops import spc_dense3d as sd

    m, x, w, aff = _spc_case(dev, shape, ch, seed=1)
    _nan_pool(x.shape, dev)
    torch.full(x.shape, float("nan"), device=dev)
    _spc_check(sd.spc_dense3d(x, w, aff), sd.spc_dense3d_plain(x, w, aff))


@pytest.mark.parametrize("ch", (128, 256))
def test_spc_dense3d_batch_equals_per_scan(dev, ch):
    """One launch set for a batch of two scans is bit for bit two per-scan
    launch sets."""
    from pasco_torch.ops import spc_dense3d as sd

    m, x, w, aff = _spc_case(dev, (2, 44, 4, 44), ch, seed=2)
    got = sd.spc_dense3d(x, w, aff)
    for b in range(2):
        assert torch.equal(got[b:b + 1], sd.spc_dense3d(x[b:b + 1].contiguous(), w, aff)), b


def test_spc_dense3d_refuses_other_inputs(dev):
    """A width, dtype, layout or kernel shape the kernel does not take, and a
    plane too wide for its halo, raise (no fallback)."""
    from pasco_torch.ops import spc_dense3d as sd

    m, x, w, aff = _spc_case(dev, (1, 6, 4, 6), 128)
    with pytest.raises(ValueError):
        sd.spc_dense3d(x.float(), w, aff)                        # f32
    with pytest.raises(ValueError):
        sd.spc_dense3d(x.transpose(2, 3), w, aff)                 # not contiguous
    with pytest.raises(ValueError):
        sd.spc_dense3d(x[0], w, aff)                              # no batch axis
    with pytest.raises(ValueError):
        sd.spc_dense3d(x[..., :96].contiguous(), w, aff)          # C = 96
    with pytest.raises(ValueError):
        sd.spc_dense3d(x, {**w, "a4": w["a4"][:, :, :4]}, aff)     # an even extent
    with pytest.raises(ValueError):
        sd.spc_dense3d(torch.zeros((1, 4, 4, 2000, 128), dtype=torch.bfloat16, device=dev),
                       w, aff)                                     # halo too wide


def test_spc_dense3d_module_route(dev, monkeypatch):
    """``SPCDense3D`` on the card: in eval mode under no_grad it calls no
    ``F.conv3d`` (patched to raise) and launches the kernel four times, within
    the plain version's bound; in training mode it launches nothing and
    composes the convs."""
    import torch.nn.functional as F

    from pasco_torch.ops import spc_dense3d as sd

    m, x, w, aff = _spc_case(dev, (1, 44, 4, 44), 256, seed=3)
    xm = x.float().permute(0, 1, 3, 2, 4)                        # [B, X, Y, Z, C] as the net
    conv3d = F.conv3d

    def refuse(*a, **k):
        raise AssertionError("F.conv3d called")

    monkeypatch.setattr(F, "conv3d", refuse)
    with torch.no_grad():
        got = _counted("spc_dense3d", lambda: m(xm, torch.bfloat16), 4)
    _spc_check(got.permute(0, 1, 3, 2, 4), sd.spc_dense3d_plain(x, w, aff))
    monkeypatch.setattr(F, "conv3d", conv3d)
    m.train()
    out = _counted("spc_dense3d", lambda: m(xm, torch.bfloat16), 0)
    assert out.requires_grad and torch.isfinite(out).all()


def test_eval_forward_calls_no_conv3d(dev, monkeypatch):
    """The whole dense forward at ``flagship_narrow_config`` on the card
    (eval, no_grad): no ``F.conv3d``, four ``spc_dense3d`` launches a
    forward."""
    import numpy as np
    import torch.nn.functional as F

    from pasco_torch.core.config import flagship_narrow_config
    from pasco_torch.models.unet import ModelInput, build_net

    cfg = flagship_narrow_config(n_infers=1)
    r = np.random.RandomState(0)
    P = cfg.capacity.num_points
    coords = np.zeros((P, 4), np.int32)
    coords[:, 1:] = np.stack([r.randint(0, e, P) for e in cfg.scene.scene_size], 1)
    gmax = np.array(cfg.scene.scene_size, np.int32) - 1
    inp = ModelInput(
        torch.from_numpy(r.randn(P, cfg.model.in_channels).astype(np.float32)),
        torch.from_numpy(coords), torch.arange(P) < 3000, torch.zeros(3, dtype=torch.int32),
        torch.from_numpy(gmax), torch.zeros((1, 3), dtype=torch.int32),
        torch.from_numpy(gmax[None]))
    net = build_net(cfg, dev)
    net.reset_parameters(torch.Generator().manual_seed(0))

    def refuse(*a, **k):
        raise AssertionError("F.conv3d called")

    monkeypatch.setattr(F, "conv3d", refuse)
    with torch.no_grad():
        for _ in range(2):
            _counted("spc_dense3d", lambda: net(ModelInput(*(t.to(dev) for t in inp))), 4)


def _forward_matches_cpu_plain(dev, S, kitti360=False):
    import dataclasses

    import numpy as np

    from pasco_tpu.core.config import flagship_narrow_config
    from pasco_torch.models.unet import ModelInput, build_net

    cfg = flagship_narrow_config(n_infers=S)
    if kitti360:    # kitti360_config's classes, input channels and things
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, n_classes=19, in_channels=8),
                          thing_ids=(1, 2, 3, 4, 5, 6))
    r = np.random.RandomState(0)
    P = cfg.capacity.num_points
    coords = np.zeros((P, 4), np.int32)
    coords[:, 0] = r.randint(0, S, P)
    coords[:, 1:] = np.stack([r.randint(0, e, P) for e in cfg.scene.scene_size], 1)
    gmax = np.array(cfg.scene.scene_size, np.int32) - 1
    # one box per subnet inside the scene
    smin = np.array([[0, 0, 0], [2, 0, 1], [0, 3, 0]], np.int32)[:S]
    smax = np.stack([gmax, gmax - [0, 2, 0], gmax - [3, 0, 1]])[:S].astype(np.int32)
    inp = ModelInput(
        torch.from_numpy(r.randn(P, cfg.model.in_channels).astype(np.float32)),
        torch.from_numpy(coords), torch.arange(P) < 3000 * S,
        torch.zeros(3, dtype=torch.int32), torch.from_numpy(gmax),
        torch.from_numpy(smin), torch.from_numpy(smax))
    net = build_net(cfg, device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = net(inp)
        net_gpu = net.to(dev)
        got = net_gpu(ModelInput(*(t.to(dev) for t in inp)))

    def cells(out, scale, s):
        g = out.sem_grids[scale]
        m = g.mask.cpu().numpy()
        c = g.coords.cpu().numpy()
        lg = out.sem_logits[scale][:, s].float().cpu().numpy()
        return {tuple(c[i]): lg[i] for i in np.nonzero(m)[0]}

    for scale in (1, 2, 4):
        a, b = cells(ref, scale, 0), cells(got, scale, 0)
        assert len(set(a) & set(b)) >= 0.99 * len(set(a) | set(b)), scale
    strict = set(range(S))   # subnets held to the elementwise query bound
    if S > 1:
        for s in range(S):
            for scale in (1, 2, 4):
                g_ref, g_got = ref.panop_grids[scale], got.panop_grids[scale]
                pa = set(map(tuple, g_ref.coords[s][g_ref.mask[s]].tolist()))
                pb = set(map(tuple, g_got.coords[s][g_got.mask[s]].cpu().tolist()))
                assert pa and len(pa ^ pb) <= max(1, 0.02 * len(pa | pb)), (scale, s)
                if pa != pb:
                    strict.discard(s)
        assert strict, "no subnet kept identical extraction sets"
    for s in range(S):
        a, b = cells(ref, 1, s), cells(got, 1, s)
        mag = max(max(np.abs(v).max() for v in a.values()), 1.0)
        worst = max(np.abs(a[k] - b[k]).max() for k in set(a) & set(b))
        assert worst <= 0.02 * mag + 0.125, (s, worst)
    q_ref = ref.predictor.query_logits.float().numpy()
    q_got = got.predictor.query_logits.float().cpu().numpy()
    assert q_ref.shape[0] == S
    for s in range(S):
        d = q_ref[s] - q_got[s]
        if s in strict:
            assert np.abs(d).max() <= 0.02 * max(np.abs(q_ref[s]).max(), 1.0) + 0.125, s
        else:
            assert np.linalg.norm(d) <= 0.05 * np.linalg.norm(q_ref[s]), s


def test_forward_matches_cpu_plain(dev):
    """The whole forward with the CUDA kernels against the same model's
    plain versions on the CPU, both bf16, at full widths over a small box
    (``flagship_narrow_config``).  Bounds as the reference's pallas-on/off
    equivalence test (``tests/test_pipeline_equivalence.py``): extraction
    sets nearly identical (Jaccard >= 0.99: the caps bind, so a near-tie
    flipped by bf16 rounding shifts the tail), logits within
    ``0.02 * scale + 0.125``."""
    _forward_matches_cpu_plain(dev, 1)


def test_mimo_forward_matches_cpu_plain(dev):
    """The same at ``n_infers=3``: points spread over the three subnets,
    three different subnet boxes; the scale-1 logits of every subnet held
    to the bounds above.  Each subnet's refined extraction sets may differ
    in 2% of their union, or in one cell: they follow that subnet's own
    argmax (class 0 or not) per cell, with no ``any`` over subnets to
    absorb a bf16 near-tie, so a cell flips more often than in the shared
    set (measured on an H100 80GB HBM3 at 700 W: 26 of 2061 cells at s1
    for one subnet, 1 of 29 at s4 for another).  The query logits of a
    subnet whose sets agree
    hold to the bound above (measured max|d| 0.036 and 0.004); those of a
    subnet whose sets differ attend over other voxels and hold to 5% in
    norm (measured 2.1%, max|d| 0.24)."""
    _forward_matches_cpu_plain(dev, 3)


def test_kitti360_forward_matches_cpu_plain(dev):
    """The same at ``n_infers=2`` with ``kitti360_config``'s 19 classes and 8
    raw input channels (two subnets, two subnet boxes)."""
    _forward_matches_cpu_plain(dev, 2, kitti360=True)


def test_dp_two_ranks_on_card_match_single_card(dev):
    """Two gloo ranks sharing the card (``chip_smoke.dp_rank`` at
    ``flagship_narrow_config(n_infers=1)``): the data-parallel step on two
    copies of a scene with SyncBN and shared draws against the single-card
    step, whose own check against the plain CPU step is
    ``test_train_step_matches_cpu_plain`` (bounds at
    ``chip_smoke._hold_step``); the cut BatchNorm reduction must miss
    them; on two distinct scenes without SyncBN the step must be their
    accumulation on one card, which rank 0's own gradient must miss;
    ``dp_eval_step`` on two scenes gives the sum of their counts."""
    import os
    import pickle
    import tempfile

    import chip_smoke
    from pasco_torch.core.config import flagship_narrow_config
    from pasco_torch.parallel.mesh import spawn_ranks
    from pasco_torch.training.loop import synthetic_train_scenes

    cfg = flagship_narrow_config(n_infers=1)
    cols = synthetic_train_scenes(cfg, 2, seed=1)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scenes.pkl")
        with open(path, "wb") as fh:
            pickle.dump((cols[0], cols), fh)
        r0, r1 = spawn_ranks(chip_smoke.dp_rank, 2, cfg, path)
    assert not r0["over"], r0["over"]
    assert r0["cut_over"]
    assert not r0["distinct_over"], r0["distinct_over"]
    assert r0["own_over"]
    assert all(torch.equal(r0[k]["sums"], r1[k]["sums"]) for k in ("cut", "dp", "distinct"))
    want = sum(r0["alone"])
    assert torch.equal(r0["eval"], want) and torch.equal(r1["eval"], want)


def test_train_step_matches_cpu_plain(dev):
    """One train step at ``flagship_narrow_config(n_infers=1)`` with the
    kernels against the plain versions on the CPU (bounds at
    ``chip_smoke.narrow_step_check``), on each of four scenes."""
    from chip_smoke import narrow_step_check

    for seed in (1, 2, 3, 4):
        narrow_step_check(dev, seed=seed)


def test_mimo_train_step_matches_cpu_plain(dev):
    """The same at ``n_infers=3``, a distinct scan per subnet."""
    from chip_smoke import narrow_step_check

    for seed in (1, 2, 3, 4):
        narrow_step_check(dev, n_infers=3, seed=seed)


def test_train_step_with_spatial_dropout_matches_cpu_plain(dev):
    """The narrow train step with every spatial dropout at 0.2, the CPU
    steps on the card step's keep vectors (``chip_smoke.DecisionPins``),
    bounds at ``chip_smoke.narrow_step_check``, on each of two scenes."""
    from chip_smoke import narrow_step_check

    for seed in (1, 2):
        narrow_step_check(dev, seed=seed, dropout=0.2)


def test_mc_dropout_on_card(dev):
    """``chip_smoke.mc_dropout_phase`` on one synthetic scan: two MC
    samples differ, rows 1-5 launch as on the inference path, the eval
    forward before and after is bit-identical."""
    from chip_smoke import make_scans, mc_dropout_phase

    from pasco_torch.core.config import PaSCoConfig

    (_, inp), = make_scans(PaSCoConfig(), 1, dev)
    mc_dropout_phase(dev, inp)


def test_trainer_on_card_with_resume(dev, tmp_path):
    """``train`` at ``flagship_narrow_config(1)`` (full widths, small box)
    on the card: 2 epochs of 4 scenes at ``accum_steps=2`` with 2 worker
    processes and a validation scene, then a resumed run that goes on from
    step 4; the training conv runs on its kernel (``conv3_dx`` launches)."""
    from pasco_torch.core.config import flagship_narrow_config
    from pasco_torch.data.synthetic import SyntheticKittiDataset
    from pasco_torch.training.loop import read_metrics, train

    cfg = flagship_narrow_config(n_infers=1)

    def data(n, **kw):
        return SyntheticKittiDataset(n_scenes=n, n_subnets=1, scene_size=cfg.scene.scene_size,
                                     n_points=3000, point_feat_dim=cfg.model.in_channels - 6,
                                     **kw)

    kernels.reset_launches()
    state = train(cfg, data(4), data(1, split="val", seed=50), n_epochs=2,
                  log_dir=str(tmp_path), accum_steps=2, num_workers=2, device=dev)
    assert state.step == 4 and kernels.LAUNCHES["conv3_dx"] > 0
    assert all(r["total_loss"] == r["total_loss"] and r["grad_norm"] > 0
               for r in state.history)
    assert sum("val/pq_dagger_all" in r for r in read_metrics(str(tmp_path))) == 2
    more = train(cfg, data(4), n_epochs=1, limit_train_batches=2, log_dir=str(tmp_path),
                 accum_steps=2, num_workers=2, device=dev)
    assert [r["step"] for r in more.history] == [5]


def test_sparse_forward_matches_cpu(dev):
    """The sparse substrate (``substrate="sparse"``, no hand-written
    kernel) at ``tiny_config`` in f32 with every cap unbound
    (``chip_smoke.sparse_config``), n_infers 1 and 3: the forward on the
    card against the same net on the CPU (TF32 off), held by
    ``chip_smoke.compare_sparse``: the same kept cells at every scale and
    for every subnet, but near ties, and the semantic and query logits
    within ``1e-3 * max|ref| + 1e-4``; no row of the kernel table
    launched."""
    import dataclasses

    import numpy as np
    from chip_smoke import compare_sparse, eval_scene, sparse_config

    from pasco_torch.core.config import tiny_config
    from pasco_torch.models.unet import build_net, scene_to_model_input

    for S in (1, 3):
        cfg = sparse_config(tiny_config(S), caps_unbound=True)
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32"))
        col = eval_scene(cfg, np.random.RandomState(S), n_points=1500, max_angle=10.0)
        net = build_net(cfg, device="cpu")
        net.reset_parameters(torch.Generator().manual_seed(0))
        kernels.reset_launches()
        with torch.no_grad():
            ref = net(scene_to_model_input(col, "cpu"))
            got = net.to(dev)(scene_to_model_input(col, dev))
        kept, _, _, _ = compare_sparse(ref, got)
        assert min(kept.values()) > 0
        assert not any(kernels.LAUNCHES.values())


def test_rulebook_conv_fn_on_card(dev):
    """``RulebookConvFn`` on the card (forward, dX, dW; f32, TF32 off)
    against autograd of the plain gather form, ``x[idx] @ w`` summed over
    the taps, in f64 on the same inputs, within ``1e-5 * max|ref|``; at a
    decoder-like shape (20000 rows of 64 channels, 27 taps, a tenth of the
    neighbours absent)."""
    from pasco_torch.ops.sparse_conv import RulebookConvFn

    g = _gen()
    n, ci, co = 20000, 64, 64
    x = torch.randn(n, ci, generator=g).to(dev)
    w = torch.randn(27, ci, co, generator=g).to(dev) * 0.05
    idx = torch.randint(0, n, (n, 27), generator=g)
    idx[torch.rand(n, 27, generator=g) < 0.1] = n
    idx = idx.to(dev)
    dy = torch.randn(n, co, generator=g).to(dev)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = RulebookConvFn.apply(xa, idx, wa)
    out.backward(dy)
    xb, wb = x.double().requires_grad_(), w.double().requires_grad_()
    ref = torch.einsum("nkc,kcd->nd", torch.cat([xb, xb.new_zeros(1, ci)])[idx], wb)
    ref.backward(dy.double())
    for got, want in ((out, ref), (xa.grad, xb.grad), (wa.grad, wb.grad)):
        err = (got.double() - want.detach()).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err


def test_waffleiron_card_matches_cpu(dev):
    """The WaffleIron Segmenter at a narrow width (depth 4, 32 channels,
    4000 points) on the card against the CPU from the same weights, in
    eval and train mode: logits, tokens and the parked BatchNorm
    statistics within ``1e-4 * max|ref| + 1e-5``
    (``chip_smoke.waffle_card_check``), no kernel launched."""
    import chip_smoke as cs

    kernels.reset_launches()
    cs.waffle_card_check(dev)
    assert not any(kernels.LAUNCHES.values())


def test_waffleiron_train_step_card_matches_cpu(dev):
    """One WaffleIron train step at B = 2 (depth 4, 32 channels) on the card
    against the same step on the CPU: the loss within ``1e-5`` of it, the
    updated parameters and the per-scan-averaged running statistics within
    ``1e-4 * max|ref| + 1e-5``, but ``embed.nbn1.bias``, whose gradient is
    zero in exact arithmetic (``nbn2`` removes its shift), held to one
    Adam step."""
    import chip_smoke as cs
    from pasco_torch.models.waffleiron import Segmenter
    from pasco_torch.training import waffleiron_train as wt

    r = torch.Generator().manual_seed(3)
    clouds, labels = [], []
    for n in (3000, 2500):
        xyz = torch.randn(n, 3, generator=r) * 8
        clouds.append(torch.cat([xyz, torch.rand(n, 2, generator=r)], 1).numpy())
        labels.append((torch.floor(xyz[:, 0]) % 19).to(torch.int32).numpy())
    grids = cs.WAFFLE_NARROW["grids_shape"]
    nets, logs = [], []
    for device in ("cpu", dev):
        net = Segmenter(**cs.WAFFLE_NARROW)
        net.reset_parameters(torch.Generator().manual_seed(0))
        net = net.to(device)
        before = {k: v.clone() for k, v in net.state_dict().items()}
        tx = wt.make_waffleiron_optimizer(warmup_end=0, max_iter=100)
        batch = wt.build_point_batch(clouds, labels, 3200, grids_shape=grids, fov=20.0,
                                     device=device)
        _, out = wt.waffleiron_train_step(wt.create_waffle_state(net, tx), batch, net=net, tx=tx)
        nets.append(net.state_dict())
        logs.append(out)
    assert abs(logs[1]["loss"].item() - logs[0]["loss"].item()) <= 1e-5 * logs[0]["loss"].item()
    for k, want in nets[0].items():
        got = nets[1][k].cpu()
        if k == "embed.nbn1.bias":
            assert (got - before[k].cpu()).abs().max() <= 1e-3 * (1 + 3e-3 * before[k].abs().max())
            continue
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item() + 1e-5, (k, err)


# --------------------------------------------------------------------------
# the sparse substrate (substrate="sparse") through AdaptiveForward
# --------------------------------------------------------------------------


def _sparse_net(dev):
    """PaSCo-single on the sparse substrate (seeded random init) and the
    third of bench.py's scans, which picks the 288 box."""
    import dataclasses

    import chip_smoke as cs
    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.models.unet import build_net

    cfg = PaSCoConfig()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, substrate="sparse"))
    scan = cs.make_scans(cfg, 3, dev)[2]
    assert cs.box_of(cfg, scan[0]) == (288, 288, 32)
    net = build_net(cfg, dev)
    net.reset_parameters(torch.Generator().manual_seed(0))
    return net, scan[1]


@pytest.mark.parametrize("side", [288, 352])
def test_sparse_adaptive_forward_is_the_direct_call(dev, side):
    """``AdaptiveForward`` over the sparse net at a box gives the kept cells
    and logits of a direct ``PaSCoNet`` call at that box."""
    from pasco_torch.inference.dispatch import AdaptiveForward

    net, inp = _sparse_net(dev)
    fwd = AdaptiveForward(net)
    box = (side, side, 32)
    with torch.no_grad():
        got, want = fwd(inp, box), net(inp, box_extent=box)
        if side == 288:
            assert fwd.box_for(inp) == box
            picked = fwd(inp)
            assert torch.equal(picked.sem_grids[1].coords, want.sem_grids[1].coords)
    for s in (4, 2, 1):
        for a, b in ((got.sem_grids[s], want.sem_grids[s]),
                     (got.panop_grids[s], want.panop_grids[s])):
            assert torch.equal(a.mask, b.mask) and torch.equal(a.coords[a.mask], b.coords[b.mask])
    assert torch.equal(got.sem_logits[1], want.sem_logits[1])


def test_sparse_stage_spans_cover_the_dispatch(dev):
    """One traced sparse forward: the stage spans' device ms sum to at least
    99% of ``pasco.dispatch``'s, and the convs and rulebooks have spans."""
    from pasco_torch.inference.dispatch import AdaptiveForward
    from pasco_torch.utils import timing

    net, inp = _sparse_net(dev)
    fwd = AdaptiveForward(net)
    with torch.no_grad():
        fwd(inp)
        timing.drain()
        timing.tracing(True)
        try:
            fwd(inp)
        finally:
            timing.tracing(False)
    rows = timing.drain()["rows"]
    root = rows[0]
    assert root["name"] == "pasco.dispatch"
    stages = [r for r in rows if r["parent"] == root["id"]]
    assert len(stages) == 10
    assert sum(r["device_ms"] for r in stages) >= 0.99 * root["device_ms"]
    names = {r["name"] for r in rows}
    assert {"pasco.sparse.conv", "pasco.sparse.rulebook"} <= names


# --------------------------------------------------------------------------
# the dense forward replayed from CUDA graphs (inference/dispatch.py)
# --------------------------------------------------------------------------


def _leaves(v):
    """Every tensor of a forward's output, in a fixed order."""
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, dict):
        v = list(v.values())
    elif hasattr(v, "__dataclass_fields__"):
        v = [getattr(v, k) for k in v.__dataclass_fields__]
    return [t for x in v for t in _leaves(x)] if isinstance(v, (list, tuple)) else []


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) > 20 and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _graph_net(dev, n_infers=1, seed=0):
    import dataclasses

    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.models.unet import build_net

    cfg = PaSCoConfig()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, n_infers=n_infers))
    net = build_net(cfg, dev)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return cfg, net


@pytest.mark.parametrize("n_infers", [1, 3])
def test_graph_forward_bit_equal_at_every_box(dev, n_infers):
    """Every box candidate captured first (one warm-up, at the first box),
    then at each box two scans in alternation: each replay's outputs equal
    the eager forward's bit for bit (a look-back flag left by the last
    replay would show), the first call's outputs are unchanged by the later
    calls, a replay adds nothing to ``kernels.LAUNCHES`` (it runs no
    wrapper), and its profiler trace holds the eager forward's kernels in
    the eager order, each as often as the eager forward's wrappers count.
    After the captures ten calls capture nothing."""
    import chip_smoke as cs
    from pasco_torch.inference import dispatch

    cfg, net = _graph_net(dev, n_infers)
    inps = [inp for _, inp in cs.make_scans(cfg, 2, dev)]
    fwd = dispatch.AdaptiveForward(net)
    kernels.reset_launches()
    with torch.no_grad():
        first = {box: fwd(inps[0], box) for box in fwd.cands}
        kept = {box: [t.clone() for t in _leaves(out)] for box, out in first.items()}
        captures = dispatch.GRAPHS["captures"]
        assert captures == len(fwd.cands) and dispatch.GRAPHS["eager"] == 0
        for box in fwd.cands:
            eager = []
            for inp in inps:
                before = dict(kernels.LAUNCHES)
                eager.append(net(inp, box_extent=box))
                per_eager = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
            for j in (1, 0, 1):
                before = dict(kernels.LAUNCHES)
                got = fwd(inps[j], box)
                assert kernels.LAUNCHES == before
                assert _same(got, eager[j]), (box, j)
            assert _same(first[box], eager[0]), box
            replayed = cs.kernel_sequence(cs.profile_call(lambda: fwd(inps[0], box), reps=3)[0])
            assert replayed == cs.kernel_sequence(
                cs.profile_call(lambda: net(inps[0], box_extent=box), reps=3)[0]), box
            assert {k: replayed.count(k) for k in cs.KERNEL_NAMES} == \
                {k: per_eager[k] for k in cs.KERNEL_NAMES}, box
        for box in fwd.cands:
            assert all(torch.equal(a, b) for a, b in zip(_leaves(first[box]), kept[box])), box
        replays = dispatch.GRAPHS["replays"]
        for i in range(10):
            fwd(inps[i % 2], fwd.cands[i % len(fwd.cands)])
        torch.cuda.synchronize()
    assert dispatch.GRAPHS["captures"] == captures
    assert dispatch.GRAPHS["replays"] == replays + 10


def test_graph_forward_recaptures_after_new_weights(dev):
    """New weights loaded (``load_state_dict``) and one parameter updated in
    place: each time the graph is captured again and its outputs equal the
    eager forward's under the new weights."""
    import chip_smoke as cs
    from pasco_torch.inference import dispatch

    cfg, net = _graph_net(dev)
    _, other = _graph_net(dev, seed=1)
    inp = cs.make_scans(cfg, 1, dev)[0][1]
    fwd = dispatch.AdaptiveForward(net)
    box = fwd.cands[-1]
    kernels.reset_launches()
    with torch.no_grad():
        old = fwd(inp, box)
        net.load_state_dict(other.state_dict())
        got = fwd(inp, box)
        assert dispatch.GRAPHS["captures"] == 2
        assert _same(got, net(inp, box_extent=box)) and not _same(got, old)
        net.dec_s1.head_bias.add_(0.5)
        got = fwd(inp, box)
        assert dispatch.GRAPHS["captures"] == 3
        assert _same(got, net(inp, box_extent=box))


def test_graph_forward_batch_of_two(dev):
    """A batch of two scans (B = 2) replays from its own graph and equals
    the eager batched forward bit for bit."""
    import chip_smoke as cs
    from pasco_torch.inference import dispatch
    from pasco_torch.models.unet import stack_inputs

    cfg, net = _graph_net(dev)
    batch = stack_inputs([inp for _, inp in cs.make_scans(cfg, 2, dev)])
    fwd = dispatch.AdaptiveForward(net)
    box = fwd.cands[-1]
    kernels.reset_launches()
    with torch.no_grad():
        for _ in range(2):
            assert _same(fwd(batch, box), net(batch, box_extent=box))
    assert dispatch.GRAPHS["captures"] == 1 and dispatch.GRAPHS["replays"] == 2
