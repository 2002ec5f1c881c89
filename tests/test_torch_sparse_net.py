"""The port's sparse-substrate network (``substrate="sparse"``) against
``pasco_tpu``'s on the CPU in f32, on weights carried over by
``flax_to_torch`` with ``strict=True``.

* The blocks, ``CylinderFeat``/``mimo_merge``, the ``Encoder``, the
  ``DenseBottleneck`` and the ``GenerativeDecoder`` each against the flax
  module on a small seeded grid, in inference and (where a BatchNorm
  decides) training mode: coordinates and masks identical row by row,
  features within ``1e-5 * max|ref| + 1e-5`` (f32, another summation
  order).
* The whole forward at ``sparse_config(n_infers)`` (``tiny_config`` in f32
  with every cap raised to its stage's row count, so that no cap binds) at
  n_infers 1 and 3: the kept coordinate sets identical at every scale and
  for every subnet, and, rows keyed by coordinate, the semantic logits,
  the kept and refined features, the carried logits and the query and
  voxel logits within ``1e-3 * max|ref| + 1e-4`` (the transformer's
  attention rounds to bf16 inside in both packages).  The decoder orders
  its kept rows by score, and near-equal scores may order differently in
  the two packages, so rows are compared by coordinate.

One module-scoped JAX compile per n_infers.
"""

import dataclasses
import functools

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_model_forward import labelweights, make_input
from test_torch_convert import flatten, nest, perturbed, tiny_f32_config

from pasco_tpu.core import sparse as J
from pasco_tpu.models import blocks as JB
from pasco_torch.convert import flax_to_torch
from pasco_torch.core import sparse as P
from pasco_torch.models import blocks as PB
from pasco_torch.models.unet import ModelInput, PaSCoNet, build_net

torch.set_num_threads(1)

BLOCK_TOL = 1e-5      # x max|ref|, and absolute
NET_TOL = (1e-3, 1e-4)


def sparse_config(n_infers=1):
    """``tiny_f32_config`` on the sparse substrate with each decoder and
    panoptic cap at its stage's row count (no cap binds) and the
    attention's KV in one chunk.  The decoder orders its kept rows by
    score, so the two packages may order near-equal scores differently;
    over several chunks that changes each chunk's running max, against
    which the probabilities are rounded to bf16, and moves logits by a
    bf16 step.  In one chunk the order changes only f32 sums."""
    cfg = chip_smoke.sparse_config(tiny_f32_config(n_infers), n_infers, caps_unbound=True)
    m = cfg.model
    return cfg.replace(model=dataclasses.replace(m, transformer=dataclasses.replace(
        m.transformer, kv_chunk=cfg.capacity.dec_s1)))


def keyed(coords, mask, *vals):
    """The valid rows ordered by coordinate: ``(coords, [vals...])``."""
    m = np.asarray(mask)
    c = np.asarray(coords)[m]
    order = np.lexsort(c.T[::-1])
    return c[order], [np.asarray(v)[m][order] for v in vals]


def assert_close(got, ref, tol):
    rel, ab = tol
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max(initial=0.0)
    assert err <= rel * np.abs(ref).max(initial=0.0) + ab, err


def assert_same_rows(tg, jg, *pairs, tol=NET_TOL):
    """``tg``/``jg``: grids of one scale (or one subnet); ``pairs``: (port
    values, reference values) on those rows.  The kept coordinate sets
    are identical and the values agree, row by row keyed by coordinate."""
    tc, tv = keyed(tg.coords.numpy(), tg.mask.numpy(), *(p for p, _ in pairs))
    jc, jv = keyed(jg.coords, jg.mask, *(j for _, j in pairs))
    np.testing.assert_array_equal(tc, jc)
    for a, b in zip(tv, jv):
        assert_close(a, b, tol)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

CORNER, EXTENT = (-6, 2, -3), (16, 16, 8)


def small_grid(r, n=300, c=8, stride=1):
    """A grid of unique cells at ``stride`` (coords multiples of it) inside
    the box, 90% of its rows valid."""
    lo = np.asarray(CORNER)
    hi = lo + np.asarray(EXTENT)
    xyz = r.randint(-(-lo // stride), (hi - 1) // stride + 1, size=(n, 3)) * stride
    coords = np.unique(np.concatenate([np.zeros((n, 1), np.int64), xyz], 1), axis=0)
    coords = coords[r.permutation(len(coords))].astype(np.int32)
    feats = r.randn(len(coords), c).astype(np.float32)
    mask = r.rand(len(coords)) < 0.9
    jg = J.SparseGrid(coords=jnp.asarray(coords), feats=jnp.asarray(feats),
                      mask=jnp.asarray(mask), stride=stride)
    pg = P.SparseGrid(*(torch.from_numpy(a) for a in (coords, feats, mask)), stride)
    jbox = J.Box.create(jnp.asarray(CORNER, jnp.int32), EXTENT)
    pbox = P.Box.create(torch.tensor(CORNER, dtype=torch.int32), EXTENT)
    return jg, pg, jbox, pbox


# name: (flax module, port module, flax call, port call, stride, has_bn)
BLOCKS = {
    "SparseConv_k3": (lambda: JB.SparseConv(6), lambda: PB.SparseConv(8, 6),
                      lambda m, g, b, t: m(g, b), lambda m, g, b: m(g, b), 1, False),
    "SparseConv_k1": (lambda: JB.SparseConv(6, 1), lambda: PB.SparseConv(8, 6, 1),
                      lambda m, g, b, t: m(g, b), lambda m, g, b: m(g, b), 1, False),
    "SparseDownConv": (lambda: JB.SparseDownConv(6, 64), lambda: PB.SparseDownConv(8, 6, 64),
                       lambda m, g, b, t: m(g, b), lambda m, g, b: m(g, b), 2, False),
    "SparseGenerativeDeconv": (lambda: JB.SparseGenerativeDeconv(5),
                               lambda: PB.SparseGenerativeDeconv(8, 5),
                               lambda m, g, b, t: m(g), lambda m, g, b: m(g), 4, False),
    "BasicConvBlock": (lambda: JB.BasicConvBlock(6, 100), lambda: PB.BasicConvBlock(8, 6, 100),
                       lambda m, g, b, t: m(g, b, t), lambda m, g, b: m(g, b), 1, True),
    "ResidualBlock": (lambda: JB.ResidualBlock(8), lambda: PB.ResidualBlock(8, 8),
                      lambda m, g, b, t: m(g, b, t), lambda m, g, b: m(g, b), 1, True),
    "ResidualBlock_downsample_se": (
        lambda: JB.ResidualBlock(6, use_se=True), lambda: PB.ResidualBlock(8, 6, use_se=True),
        lambda m, g, b, t: m(g, b, t), lambda m, g, b: m(g, b), 1, True),
    "SELayer": (lambda: JB.SELayer(8), lambda: PB.SELayer(8),
                lambda m, g, b, t: m(g), lambda m, g, b: m(g), 1, False),
    "CAM": (lambda: JB.CAM(8), lambda: PB.CAM(8),
            lambda m, g, b, t: m(g, b), lambda m, g, b: m(g, b), 1, False),
    "DepthwiseSeparableConvMultiheads": (
        lambda: JB.DepthwiseSeparableConvMultiheads(8, n_heads=2),
        lambda: PB.DepthwiseSeparableConvMultiheads(8, n_heads=2),
        lambda m, g, b, t: m(g, b), lambda m, g, b: m(g, b), 1, False),
    "submanifold_maxpool": (None, None, lambda m, g, b, t: JB.submanifold_maxpool(g, b, 3),
                            lambda m, g, b: PB.submanifold_maxpool(g, b, 3), 1, False),
}


def _flax_variables(jmod, call, jg, jbox, seed):
    v = jmod.init(jax.random.PRNGKey(seed), jg, jbox, False, method=lambda m, g, b, t: call(
        m, g, b, t))
    return perturbed(flatten(v), seed=seed)


@pytest.mark.parametrize("name,train", [(n, False) for n in sorted(BLOCKS)]
                         + [(n, True) for n in sorted(BLOCKS) if BLOCKS[n][5]])
def test_block(name, train):
    """Inference mode, and training mode (batch statistics, and the
    running statistics they update) where a BatchNorm decides."""
    jmk, pmk, jcall, pcall, stride, _ = BLOCKS[name]
    jg, pg, jbox, pbox = small_grid(np.random.RandomState(len(name)), stride=stride)
    if jmk is None:
        same = lambda a, b: np.testing.assert_array_equal(a, np.asarray(b))  # noqa: E731
        out_j, out_p = jcall(None, jg, jbox, False), pcall(None, pg, pbox)
        np.testing.assert_array_equal(out_p.mask.numpy(), np.asarray(out_j.mask))
        same(out_p.feats.numpy(), out_j.feats)
        return
    jmod, pmod = jmk(), pmk()
    flat = _flax_variables(jmod, jcall, jg, jbox, seed=3)
    pmod.load_state_dict(flax_to_torch(flat), strict=True)
    pmod.train(train)
    if train:
        out_j, mutated = jmod.apply(nest(flat), jg, jbox, True, mutable=["batch_stats"],
                                    method=lambda m, g, b, t: jcall(m, g, b, t))
    else:
        out_j = jmod.apply(nest(flat), jg, jbox, False,
                           method=lambda m, g, b, t: jcall(m, g, b, t))
    out_p = pcall(pmod, pg, pbox)
    np.testing.assert_array_equal(out_p.mask.numpy(), np.asarray(out_j.mask))
    np.testing.assert_array_equal(out_p.coords.numpy(), np.asarray(out_j.coords))
    assert_close(out_p.feats.detach().numpy(), out_j.feats, (BLOCK_TOL, BLOCK_TOL))
    if train:
        from pasco_torch.models.norm import commit_batch_stats

        commit_batch_stats(pmod)
        sd = pmod.state_dict()
        for k, v in flax_to_torch(flatten({"batch_stats": mutated["batch_stats"]})).items():
            assert_close(sd[k].numpy(), v.numpy(), (BLOCK_TOL, BLOCK_TOL))


def test_pointwise_multiheads_is_block_diagonal():
    jmod = JB.PointwiseConvMultiheads(8, 6, n_heads=2)
    x = np.random.RandomState(0).randn(20, 8).astype(np.float32)
    flat = perturbed(flatten(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))), seed=1)
    pmod = PB.PointwiseConvMultiheads(8, 6, n_heads=2)
    pmod.load_state_dict(flax_to_torch(flat), strict=True)
    assert_close(pmod(torch.from_numpy(x)).detach().numpy(),
                 jmod.apply(nest(flat), jnp.asarray(x)), (BLOCK_TOL, BLOCK_TOL))


# --------------------------------------------------------------------------
# the network's modules
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def run_both(n_infers):
    """One inference forward of each package at ``sparse_config(n_infers)``
    on shared perturbed weights, with the module outputs: the
    reference's through flax ``capture_intermediates``, the port's through
    forward hooks; and the port's MC-dropout forward."""
    from pasco_tpu.models.unet import PaSCoNet as JNet

    cfg = sparse_config(n_infers)
    inp = make_input(cfg, rng=0, n_pts=1200)
    jnet = JNet(cfg)
    lw = labelweights(cfg)
    v = jax.jit(lambda i: jnet.init({"params": jax.random.PRNGKey(0)}, i, lw, train=False))(inp)
    flat = perturbed(flatten(v), seed=1)

    def run(v, i):
        return jnet.apply(v, i, lw, train=False, capture_intermediates=True,
                          mutable=["intermediates"])

    jout, inter = jax.jit(run)(nest(flat), inp)
    net = build_net(cfg, device="cpu")
    net.load_state_dict(flax_to_torch(flat), strict=True)
    seen = {}
    for name in ("cylinder_feat", "encoder", "dense_bottleneck", "decoder"):
        getattr(net, name).register_forward_hook(
            lambda _m, _i, o, name=name: seen.__setitem__(name, o))
    tin = ModelInput(*(torch.from_numpy(np.array(a)) for a in inp))
    tlw = {k: torch.from_numpy(np.array(w)) for k, w in lw.items()}
    with torch.no_grad():
        tout = net(tin, tlw)
        mc = net(tin, tlw, torch.Generator().manual_seed(1), mc_dropout=True)
    return dict(cfg=cfg, jout=jout, tout=tout, mc=mc, inter=inter["intermediates"],
                seen=seen)


@pytest.fixture(scope="module")
def stages():
    return run_both(3)


def test_cylinder_feat_and_mimo_merge(stages):
    """Per-(subnet, cell) voxels identical row by row (first-occurrence
    order), max-pooled features within the block bound; the merge on the
    union of cells with subnet i in channel block i."""
    from pasco_torch.models.cylinder_feat import mimo_merge

    jg = stages["inter"]["cylinder_feat"]["__call__"][0]
    pg = stages["seen"]["cylinder_feat"]
    np.testing.assert_array_equal(pg.mask.numpy(), np.asarray(jg.mask))
    np.testing.assert_array_equal(pg.coords.numpy(), np.asarray(jg.coords))
    assert_close(pg.feats.numpy(), jg.feats, (BLOCK_TOL, BLOCK_TOL))
    from pasco_tpu.models.cylinder_feat import mimo_merge as jmerge

    cfg = stages["cfg"]
    jbox = J.Box.create(jnp.zeros(3, jnp.int32), cfg.scene.box_extent)
    pbox = P.Box.create(torch.zeros(3, dtype=torch.int32), cfg.scene.box_extent)
    jm = jmerge(jg, jbox, 3, cfg.capacity.enc_s1)
    pm = mimo_merge(pg, pbox, 3, cfg.capacity.enc_s1)
    np.testing.assert_array_equal(pm.coords.numpy(), np.asarray(jm.coords))
    np.testing.assert_array_equal(pm.mask.numpy(), np.asarray(jm.mask))
    assert_close(pm.feats.numpy(), jm.feats, (BLOCK_TOL, BLOCK_TOL))
    assert int(pm.mask.sum()) < int(pg.mask.sum())       # the subnets share cells


def test_encoder(stages):
    jenc = stages["inter"]["encoder"]["__call__"][0]
    for jg, pg in zip(jenc, stages["seen"]["encoder"]):
        np.testing.assert_array_equal(pg.mask.numpy(), np.asarray(jg.mask))
        np.testing.assert_array_equal(pg.coords.numpy(), np.asarray(jg.coords))
        assert_close(pg.feats.numpy(), jg.feats, (1e-4, 1e-4))
        assert int(pg.mask.sum()) > 0


def test_dense_bottleneck(stages):
    jg = stages["inter"]["dense_bottleneck"]["__call__"][0]
    pg = stages["seen"]["dense_bottleneck"]
    np.testing.assert_array_equal(pg.mask.numpy(), np.asarray(jg.mask))
    np.testing.assert_array_equal(pg.coords.numpy(), np.asarray(jg.coords))
    assert_close(pg.feats.numpy(), jg.feats, (1e-4, 1e-4))


def test_generative_decoder(stages):
    """The decoder's kept voxels, logits and refined per-subnet grids."""
    jd = stages["inter"]["decoder"]["__call__"][0]
    pd = stages["seen"]["decoder"]
    for s in (4, 2, 1):
        assert_same_rows(pd.xs[s], jd.xs[s], (pd.xs[s].feats, jd.xs[s].feats),
                         (pd.sem_logits[s], jd.sem_logits[s]))
        for i in range(3):
            tp, jp = pd.panop_grids[s].subnet(i), jd.panop_grids[s]
            jp = J.SparseGrid(coords=jp.coords[i], feats=jp.feats[i], mask=jp.mask[i],
                              stride=jp.stride)
            pairs = [(tp.feats, jp.feats)]
            if s == 1:
                pairs.append((pd.sem_logits_pruned[i], jd.sem_logits_pruned[i]))
            assert_same_rows(tp, jp, *pairs)


# --------------------------------------------------------------------------
# the whole forward
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[1, 3], ids=["n_infers_1", "n_infers_3"])
def forward(request):
    r = run_both(request.param)
    return r["cfg"], r["jout"], r["tout"], r["mc"]


def test_kept_coords_identical(forward):
    cfg, jout, tout, _ = forward
    S = cfg.model.n_infers
    for scale in (4, 2, 1):
        jg, tg = jout.sem_grids[scale], tout.sem_grids[scale]
        tc, _ = keyed(tg.coords.numpy(), tg.mask.numpy())
        jc, _ = keyed(jg.coords, jg.mask)
        np.testing.assert_array_equal(tc, jc)
        assert len(tc) > 0
        for s in range(S):
            jp, tp = jout.panop_grids[scale], tout.panop_grids[scale]
            tc, _ = keyed(tp.coords[s].numpy(), tp.mask[s].numpy())
            jc, _ = keyed(jp.coords[s], jp.mask[s])
            np.testing.assert_array_equal(tc, jc)
            assert len(tc) > 0


def test_logits_and_features_match(forward):
    cfg, jout, tout, _ = forward
    for scale in (4, 2, 1):
        tg, jg = tout.sem_grids[scale], jout.sem_grids[scale]
        assert_same_rows(tg, jg, (tout.sem_logits[scale], jout.sem_logits[scale]),
                         (tg.feats, jg.feats))
    for s in range(cfg.model.n_infers):
        jp, tp = jout.panop_grids[1], tout.panop_grids[1]
        jg = J.SparseGrid(coords=jp.coords[s], feats=jp.feats[s], mask=jp.mask[s])
        assert_same_rows(tp.subnet(s), jg, (tp.feats[s], jp.feats[s]),
                         (tout.predictor.voxel_logits[s], jout.predictor.voxel_logits[s]),
                         (tout.sem_logits_pruned[s], jout.sem_logits_pruned[s]))
    assert_close(tout.predictor.query_logits.numpy(), jout.predictor.query_logits, NET_TOL)
    for (ct, _), (cj, _) in zip(tout.predictor.aux, jout.predictor.aux):
        assert_close(ct.numpy(), cj, NET_TOL)


def test_output_shapes_and_mc_dropout(forward):
    """The reference's shapes; at the released recipe's zero rates the
    MC-dropout forward is the inference forward."""
    cfg, jout, tout, mc = forward
    assert tout.sem_logits[1].shape == tuple(jout.sem_logits[1].shape)
    assert tout.sem_logits_pruned.shape == tuple(jout.sem_logits_pruned.shape)
    assert tout.predictor.query_logits.shape == tuple(jout.predictor.query_logits.shape)
    assert tout.predictor.voxel_logits.shape == tuple(jout.predictor.voxel_logits.shape)
    assert torch.equal(mc.predictor.query_logits, tout.predictor.query_logits)
    assert torch.equal(mc.sem_logits[1], tout.sem_logits[1])


def test_build_net_picks_the_substrate():
    cfg = sparse_config()
    net = build_net(cfg, device="cpu")
    assert isinstance(net, PaSCoNet) and net.cfg is cfg and not net.training
    dense = build_net(tiny_f32_config(), device="cpu")
    assert not isinstance(dense, PaSCoNet)
    inp = ModelInput(*(torch.from_numpy(np.array(a))[None] for a in make_input(cfg, rng=0)))
    with pytest.raises(ValueError, match="one scan per call"):
        net(inp)
    from pasco_torch.training.convert_torch import load_reference_into

    with pytest.raises(ValueError, match="dense substrate"):
        load_reference_into(net, {})


def test_seeded_init_families():
    """The port's own init (the card has no JAX): flax's families and
    scales, reproducible from the generator."""
    cfg = sparse_config()
    a, b = build_net(cfg, device="cpu"), build_net(cfg, device="cpu")
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    sd = a.state_dict()
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in sd.items())
    w = sd["encoder.s1_res0.conv1.kernel"]
    bound = (1.0 / (27 * 16)) ** 0.5
    assert bound >= w.abs().max() > 0.9 * bound
    w = sd["decoder.voxel_feats_s1.conv1.kernel"]
    assert bound >= w.abs().max() > 0.9 * bound
    assert torch.all(sd["decoder.block_s1.up.bias"] == 0)
    assert torch.all(sd["cylinder_feat.bn1.var"] == 1)
    fc = sd["cylinder_feat.fc2.weight"]        # lecun normal, fan_in 64
    assert abs(fc.std().item() - (1 / 64) ** 0.5) < 0.02
