"""The CUDA kernels against their plain versions on the card, at small and
ragged shapes (tile edges in x, z and y, both conv tile geometries) and
every channel width of the flagship path, the differentiable training
conv's gradients likewise, and the whole forward and one whole train step
with the kernels against the plain versions on the CPU.

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


@pytest.mark.parametrize("ci,co", [(64, 128), (128, 256), (256, 256)])
def test_down2_fused_matches_plain(dev, ci, co):
    g = _gen()
    m = _mask(g, dev, (6, 10, 18), 0.3)
    m2 = maxpool2_mask(m)
    x = _randn(g, dev, 6, 10, 18, ci)
    w = _randn(g, dev, 8, ci, co, scale=(8 * ci) ** -0.5)
    vec = lambda lo: (torch.rand(co, generator=g) + lo).to(dev)  # noqa: E731
    args = (x, m, m2, w, vec(-0.5), (vec(0.5), vec(-0.5)), (vec(0.5), vec(-0.5)))
    _check(down.down2_fused(*args), down.down2_fused_plain(*args), m2)


@pytest.mark.parametrize("ci,co", [(128, 64), (256, 128), (256, 256)])
def test_up_preamble_matches_plain(dev, ci, co):
    g = _gen()
    X2, Z2, Y2 = 3, 2, 11
    pkeep = _mask(g, dev, (X2, Z2, Y2), 0.6)
    child = upsample2_mask(pkeep) & _mask(g, dev, (2 * X2, 2 * Z2, 2 * Y2), 0.8)
    skip_mask = _mask(g, dev, (2 * X2, 2 * Z2, 2 * Y2), 0.3)
    union = child | skip_mask
    skip = torch.where(skip_mask[..., None], _randn(g, dev, 2 * X2, 2 * Z2, 2 * Y2, co),
                       torch.zeros((), dtype=torch.bfloat16, device=dev))
    box = Box.create(torch.tensor([-16, 8, -8], device=dev), (12, 44, 8))
    vec = lambda n, lo: (torch.rand(n, generator=g) + lo).to(dev)  # noqa: E731
    args = (_randn(g, dev, X2, Z2, Y2, ci), pkeep, child, union, skip, box, 2,
            _randn(g, dev, 8, ci, co, scale=ci ** -0.5), vec(co, -0.5),
            (vec(co, 0.5), vec(co, -0.5)), (vec(co + 3, 0.5), vec(co + 3, -0.5)),
            _randn(g, dev, co + 3, co, scale=0.1), vec(co, -0.5))
    _check(deconv.up_preamble(*args), deconv.up_preamble_plain(*args), union)


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


def _column_case(g, dev, shape, c, d, p):
    m = _mask(g, dev, shape, p)
    x = torch.where(m[..., None], torch.randn((*shape, c), generator=g).to(dev),
                    torch.zeros((), device=dev))
    w = torch.randn((27, c, d), generator=g).to(dev) * (27 * c) ** -0.5
    b = torch.randn(d, generator=g).to(dev) * 0.1
    return x, w, m, b


@pytest.mark.parametrize("shape,p", [((16, 16, 8), 0.02), ((20, 13, 5), 0.05),
                                     ((24, 40, 32), 0.01), ((9, 9, 3), 0.3)])
@pytest.mark.parametrize("c,d", [(64, 64), (16, 32), (40, 48)])
@pytest.mark.parametrize("part", [1.0, 0.5])
def test_column_conv3_matches_plain(dev, shape, p, c, d, part):
    """Row 7: ragged column grids (X, Y not multiples of 8), Z not a
    multiple of the kernel's z-slab, C not a multiple of its channel chunk,
    and a capacity at half the occupied columns.  f32 bound
    ``1e-3 * max|ref| + 1e-3`` at visited cells; elsewhere exactly the bias
    at mask cells and 0."""
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
    assert (got - ref)[vis].abs().max() <= 1e-3 * ref[vis].abs().max() + 1e-3
    rest = torch.where(m[..., None], b, torch.zeros((), device=dev))[~vis]
    assert torch.equal(got[~vis], rest) and torch.equal(ref[~vis], rest)


def test_column_conv3_empty_mask(dev):
    from pasco_torch.ops import column_conv as cc

    x, w, m, b = _column_case(_gen(), dev, (16, 24, 8), 64, 64, 0.0)
    assert not cc.block_sparse_conv3(x, w, m, 6, bias=b).any()


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


def test_wrappers_raise_on_wrong_input(dev):
    x = torch.zeros((4, 4, 4, 64), device=dev)           # f32, not bf16
    m = torch.ones((4, 4, 4), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        conv.masked_conv3(x, m, torch.zeros((27, 64, 64), device=dev))
    with pytest.raises(ValueError):
        extract.stream_extract(m, 10, x)


def _forward_matches_cpu_plain(dev, S):
    import numpy as np

    from pasco_tpu.core.config import flagship_narrow_config
    from pasco_torch.models.unet import ModelInput, build_net

    cfg = flagship_narrow_config(n_infers=S)
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
