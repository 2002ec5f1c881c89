"""The batched inference forward (``B`` scans per call: the reference
``bench.py``'s ``BENCH_BATCH > 1``, ``jax.vmap`` of the forward) on the CPU.

* The port's forward on a stacked ``ModelInput`` at ``tiny_config`` in f32
  against ``jax.jit(jax.vmap(net.apply))`` of the reference on shared
  weights (one JAX compile): identical extraction coords and masks at every
  scale of every scan, logits, refined features and query logits within
  ``test_torch_slice.py``'s ``rtol=2e-2, atol=1e-2``.
* The same batched forward against the port's own unbatched forward on
  each scan: identical coords and masks, every float within ``atol=1e-5``.
  Both run with oneDNN off: oneDNN picks its conv3d algorithm by batch
  size, so its sums at N = 2 and N = 1 differ by ~1e-8, which flips the
  bf16 rounding of a few semantic logits (by 4e-3); ATen's own conv3d
  computes each scan alone, and with it the two forwards agree bit for
  bit.  The plain conv's batch check below runs with it too.
* The two scans have different box corners (``global_min``), so a scan
  read at another scan's origin shows in the coords.
* Each kernel's plain version (rows 1-4) and the featurizer's scatter on a
  ``[B, ...]`` batch against ``B`` unbatched calls: identical outputs; the
  tile lists of rows 1-3 over ``B`` scans (ids, the active count, a scan
  with no valid cell).
* What must raise: ``B > 1`` in training mode and under MC dropout;
  ``scripts_torch/bench.py`` at ``BENCH_BATCH=2`` with ``BENCH_INFERS=3``
  or ``BENCH_BATCH_PALLAS=0``.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_model_forward import labelweights, make_input
from test_torch_convert import nest, perturbed, tiny_f32_config

from pasco_torch.convert import flax_to_torch, torch_to_flax
from pasco_torch.core.sparse import Box
from pasco_torch.models.unet import ModelInput, build_net, scan_output, stack_inputs
from pasco_torch.ops import conv, deconv, down, extract
from pasco_torch.ops.dense_ops import bbox_mask, maxpool2_mask, upsample2_mask
from pasco_torch.ops.featurizer import scatter_points

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIFTS = ((0, 0, 0), (5, -3, 2))   # each scan's box corner (global_min)


def scan_arrays(cfg, rng, shift):
    """``make_input``'s scan ``rng`` moved by ``shift`` voxels: points,
    global and subnet boxes (numpy, the ``ModelInput`` field order)."""
    a = [np.array(x) for x in make_input(cfg, rng=rng)]
    off = np.asarray(shift, np.int32)
    a[1][:, 1:] += off
    for i in (3, 4, 5, 6):
        a[i] = a[i] + off
    return a


@pytest.fixture(scope="module")
def outputs():
    from pasco_tpu.models.dense_unet import DensePaSCoNet
    from pasco_tpu.models.unet import ModelInput as JInput

    cfg = tiny_f32_config()
    scans = [scan_arrays(cfg, k, shift) for k, shift in enumerate(SHIFTS)]
    assert not np.array_equal(scans[0][3], scans[1][3])   # distinct global_min
    net = build_net(cfg, device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(0))
    flat = perturbed(torch_to_flax(net.state_dict()), seed=1)
    net.load_state_dict(flax_to_torch(flat), strict=True)
    jnet, lw = DensePaSCoNet(cfg), labelweights(cfg)
    binp = JInput(*(jnp.asarray(np.stack(parts)) for parts in zip(*scans)))
    jout = jax.jit(jax.vmap(lambda v, i: jnet.apply(v, i, lw, train=False),
                            in_axes=(None, 0)))(nest(flat), binp)
    tin = [ModelInput(*(torch.from_numpy(a) for a in s)) for s in scans]
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        tout = net(stack_inputs(tin))
        singles = [net(i) for i in tin]
    return cfg, scans, jout, tout, singles


def test_each_scans_coords_lie_in_its_own_box(outputs):
    _, scans, _, tout, _ = outputs
    assert not np.array_equal(scans[0][3], scans[1][3])
    for b, s in enumerate(scans):
        g = tout.sem_grids[1]
        c = g.coords[b][g.mask[b]][:, 1:].numpy()
        assert (c >= s[3]).all() and (c <= s[4]).all()


@pytest.mark.parametrize("which", ["sem_grids", "panop_grids"])
def test_batched_coords_identical_to_vmap(outputs, which):
    _, _, jout, tout, _ = outputs
    for scale in (1, 2, 4):
        jg, tg = getattr(jout, which)[scale], getattr(tout, which)[scale]
        assert tg.coords.shape[0] == len(SHIFTS)
        np.testing.assert_array_equal(tg.mask.numpy(), np.asarray(jg.mask))
        np.testing.assert_array_equal(tg.coords.numpy(), np.asarray(jg.coords))
        for b in range(len(SHIFTS)):
            assert tg.mask[b].sum() > 0


def test_batched_logits_and_features_match_vmap(outputs):
    _, _, jout, tout, _ = outputs
    tol = dict(rtol=2e-2, atol=1e-2)
    for scale in (1, 2, 4):
        np.testing.assert_allclose(tout.sem_logits[scale].numpy(),
                                   np.asarray(jout.sem_logits[scale]), **tol)
        np.testing.assert_allclose(tout.panop_grids[scale].feats.numpy(),
                                   np.asarray(jout.panop_grids[scale].feats), **tol)
    p_t, p_j = tout.predictor, jout.predictor
    np.testing.assert_allclose(p_t.query_logits.numpy(), np.asarray(p_j.query_logits), **tol)
    np.testing.assert_allclose(p_t.voxel_logits.numpy(), np.asarray(p_j.voxel_logits), **tol)
    for (ct, mt), (cj, mj) in zip(p_t.aux, p_j.aux):
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **tol)
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), **tol)


def test_batched_output_shapes(outputs):
    cfg, _, _, tout, _ = outputs
    cap, m = cfg.capacity, cfg.model
    B, Q = len(SHIFTS), m.transformer.num_queries
    assert tout.sem_logits[1].shape == (B, cap.dec_s1, 1, m.n_classes)
    assert tout.sem_grids[1].coords.shape == (B, cap.dec_s1, 4)
    assert tout.sem_grids[1].feats.shape == (B, cap.dec_s1, m.f)
    assert tout.panop_grids[1].coords.shape == (B, 1, cap.panop_s1, 4)
    assert tout.sem_logits_pruned.shape == (B, 1, cap.panop_s1, m.n_classes)
    assert tout.predictor.query_logits.shape == (B, 1, Q, m.n_classes + 1)
    assert tout.predictor.voxel_logits.shape == (B, 1, cap.panop_s1, Q)


def _leaves(out):
    grids = [g for d in (out.sem_grids, out.panop_grids) for g in d.values()]
    ints = [t for g in grids for t in (g.coords, g.mask)]
    floats = [g.feats for g in grids] + list(out.sem_logits.values())
    floats += [out.sem_logits_pruned, out.predictor.query_logits, out.predictor.voxel_logits]
    floats += [t for pair in out.predictor.aux for t in pair]
    return ints, floats


def test_batched_matches_unbatched_per_scan(outputs):
    _, _, _, tout, singles = outputs
    for b, single in enumerate(singles):
        (ints_b, floats_b), (ints_1, floats_1) = _leaves(scan_output(tout, b)), _leaves(single)
        for got, want in zip(ints_b, ints_1):
            assert torch.equal(got, want)
        for got, want in zip(floats_b, floats_1):
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_batch_is_inference_only(outputs):
    cfg, scans, _, _, _ = outputs
    net = build_net(cfg, device="cpu")
    binp = stack_inputs([ModelInput(*(torch.from_numpy(a) for a in s)) for s in scans])
    with torch.no_grad():
        with pytest.raises(ValueError, match="inference only"):
            net(binp, mc_dropout=True, generator=torch.Generator().manual_seed(0))
        net.train()
        with pytest.raises(ValueError, match="inference only"):
            net(binp, generator=torch.Generator().manual_seed(0))


def _bench():
    spec = importlib.util.spec_from_file_location(
        "torch_bench", os.path.join(ROOT, "scripts_torch", "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("env,match", [
    ({"BENCH_INFERS": "3"}, "BENCH_INFERS"),
    ({"BENCH_BATCH_PALLAS": "0"}, "BENCH_BATCH_PALLAS"),
])
def test_bench_batch_refuses_other_settings(monkeypatch, env, match):
    monkeypatch.setenv("BENCH_BATCH", "2")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=match):
        _bench().main()


# --------------------------------------------------------------------------
# the kernels' plain versions and tile lists on a batch
# --------------------------------------------------------------------------

def _masks(r, shape, density=(0.3, 0.0, 0.6)):
    """One mask per density (the 0.0 scan has no valid cell)."""
    return torch.from_numpy(np.stack([r.rand(*shape) < d for d in density]))


def _randn(r, *shape):
    return torch.from_numpy(r.randn(*shape).astype(np.float32))


def _per_scan(fn, *batched):
    """``fn`` on each scan of the batched arguments (None passes through)."""
    B = next(a for a in batched if a is not None).shape[0]
    outs = [fn(*(None if a is None else a[b] for a in batched)) for b in range(B)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(p) for p in zip(*outs))
    return torch.stack(outs)


def test_masked_conv3_plain_batch_equals_per_scan():
    r = np.random.RandomState(0)
    m = _masks(r, (6, 4, 10))
    c = 8
    x, skip = _randn(r, 3, 6, 4, 10, c), _randn(r, 3, 6, 4, 10, c)
    w, bias = _randn(r, 27, c, c) * 0.2, _randn(r, c)
    aff = (_randn(r, c).abs() + 0.5, _randn(r, c) * 0.1)
    kw = dict(bias=bias, affine=aff, relu_in=True, relu_out=True)
    with torch.backends.mkldnn.flags(enabled=False):   # see the module docstring
        got = conv.masked_conv3(x, m, w, skip=skip, **kw)
        want = _per_scan(lambda xb, mb, sb: conv.masked_conv3(xb, mb, w, skip=sb, **kw),
                         x, m, skip)
    assert torch.equal(got, want)
    assert (got[1] == 0).all()


def test_down2_fused_plain_batch_equals_per_scan():
    r = np.random.RandomState(1)
    m = _masks(r, (6, 4, 10))
    ci, co = 8, 16
    x = _randn(r, 3, 6, 4, 10, ci)
    args = (_randn(r, 8, ci, co) * 0.2, _randn(r, co),
            (_randn(r, co).abs() + 0.5, _randn(r, co)), (_randn(r, co).abs() + 0.5, _randn(r, co)))
    got = down.down2_fused(x, m, maxpool2_mask(m), *args)
    want = _per_scan(lambda xb, mb: down.down2_fused(xb, mb, maxpool2_mask(mb), *args), x, m)
    assert torch.equal(got, want)


def test_up_preamble_plain_batch_equals_per_scan():
    """Each scan's coordinate channels from its own box corner; with the
    corners swapped the result moves."""
    r = np.random.RandomState(2)
    ci, co, sc = 8, 4, 2
    keep = _masks(r, (3, 2, 5), (0.5, 0.0, 0.8))
    child = upsample2_mask(keep) & _masks(r, (6, 4, 10), (0.9, 0.9, 0.9))
    union = child | _masks(r, (6, 4, 10), (0.2, 0.0, 0.2))
    parent, skip = _randn(r, 3, 3, 2, 5, ci), _randn(r, 3, 6, 4, 10, co)
    skip = torch.where(union[..., None], skip, torch.zeros(()))
    mins = torch.tensor([[0, 0, 0], [4, -6, 2], [-8, 10, 6]], dtype=torch.int32)
    box = Box.create(mins, (12, 20, 8))
    w = (_randn(r, 8, ci, co) * 0.3, _randn(r, co), (_randn(r, co).abs() + 0.5, _randn(r, co)),
         (_randn(r, co + 3).abs() + 0.5, _randn(r, co + 3)), _randn(r, co + 3, co) * 0.3,
         _randn(r, co))
    got = deconv.up_preamble(parent, keep, child, union, skip, box, sc, *w)
    want = _per_scan(
        lambda p, k, c, u, s, mn: deconv.up_preamble(p, k, c, u, s, Box.create(mn, box.extent),
                                                     sc, *w),
        parent, keep, child, union, skip, mins)
    assert torch.equal(got, want)
    swapped = deconv.up_preamble(parent, keep, child, union, skip,
                                 Box.create(mins.flip(0), box.extent), sc, *w)
    assert not torch.equal(swapped[0], got[0])
    shared = deconv.up_preamble(parent, keep, child, union, skip, Box.create(mins[2], box.extent),
                                sc, *w)
    assert torch.equal(shared[2], got[2])


def test_stream_extract_plain_batch_equals_per_scan():
    r = np.random.RandomState(3)
    keep = _masks(r, (6, 4, 10))
    pay = _randn(r, 3, 6, 4, 10, 5).to(torch.bfloat16)
    for cap in (7, 500):
        got = extract.stream_extract(keep, cap, pay)
        want = _per_scan(lambda k, p: extract.stream_extract(k, cap, p), keep, pay)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert got[3].tolist() == [int(k.sum()) for k in keep]


def test_scatter_points_batch_equals_per_scan():
    r = np.random.RandomState(4)
    B, P, F, S, ext = 3, 200, 6, 2, (5, 7, 4)
    f = _randn(r, B, P, F)
    rel = torch.from_numpy(np.stack([r.randint(0, e, (B, P)) for e in ext], -1).astype(np.int32))
    in_box = torch.from_numpy(r.rand(B, P) < 0.7)
    in_box[1] = False
    subnet = torch.from_numpy(r.randint(0, S, (B, P)).astype(np.int32))
    got = scatter_points(f, rel, in_box, subnet, S, ext, torch.float32)
    want = _per_scan(lambda *a: scatter_points(*a, S, ext, torch.float32), f, rel, in_box, subnet)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _check_batched_tiles(tiles_fn, masks, full=True):
    """The tile list over a batch holds each scan's active tiles, offset by
    the scan's first id, ascending (and with ``full``, then every inactive
    tile once)."""
    got = tiles_fn(masks)
    singles = [tiles_fn(m) for m in masks]
    n = singles[0].n_tiles
    assert got.n_tiles == len(masks) * n
    want = torch.cat([t.ids[: int(t.n_active)] + b * n for b, t in enumerate(singles)])
    assert int(got.n_active) == sum(int(t.n_active) for t in singles) == want.numel()
    assert torch.equal(got.ids[: want.numel()], want.to(got.ids.dtype))
    if full:
        assert torch.equal(got.ids.sort().values,
                           torch.arange(got.n_tiles, dtype=got.ids.dtype))
    assert int(singles[1].n_active) == 0
    return got


def test_tile_lists_over_a_batch():
    r = np.random.RandomState(5)
    m = _masks(r, (10, 6, 36), (0.02, 0.0, 0.05))
    t = _check_batched_tiles(conv.conv_tiles, m)
    assert (t.tx, t.tz) == (conv.TX, conv.TZ)
    _check_batched_tiles(deconv.up_tiles, m)
    _check_batched_tiles(down.down_tiles, maxpool2_mask(m), full=False)
    # the unbatched lists are the batch of one
    for fn, mm in ((conv.conv_tiles, m[0]), (deconv.up_tiles, m[2]),
                   (down.down_tiles, maxpool2_mask(m)[2])):
        one, batch = fn(mm), fn(mm[None])
        assert torch.equal(one.ids, batch.ids) and torch.equal(one.n_active, batch.n_active)


def test_bbox_mask_batch_uses_each_scans_corner():
    r = np.random.RandomState(6)
    mins = torch.tensor([[0, 0, 0], [3, -2, 1]], dtype=torch.int32)
    lo = mins + torch.from_numpy(r.randint(0, 3, (2, 3)).astype(np.int32))
    hi = lo + torch.from_numpy(r.randint(2, 6, (2, 3)).astype(np.int32))
    box = Box.create(mins, (8, 10, 6))
    got = bbox_mask(box, 2, lo, hi)
    for b in range(2):
        assert torch.equal(got[b], bbox_mask(Box.create(mins[b], box.extent), 2, lo[b], hi[b]))
    assert not torch.equal(got[1], bbox_mask(Box.create(mins[0], box.extent), 2, lo[1], hi[1]))


def test_bench_batch_protocol_on_tiny_scans(outputs):
    """``scripts_torch/bench.py``'s batched protocol end to end on the CPU
    at ``tiny_config``: the reference's scans (seed 0, then 100, ...), one
    stacked input, ``max(iters, 6)`` timed calls.  (The reference draws
    these scans without augmentation, so they share a box corner; the
    tests above hold the per-scan corners.)"""
    cfg = outputs[0]
    bench = _bench()
    binp = bench.batch_scans(cfg, 2, "cpu")
    assert binp.point_feats.shape[0] == 2
    assert not torch.equal(binp.point_feats[0], binp.point_feats[1])
    net = build_net(cfg, device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(0))
    res = bench.measure_batch(net, binp, iters=1)
    assert len(res["samples_s"]) == 6 and res["scans_per_sec"] > 0
    assert res["device_ms"] is None


def test_bench_host_syncs_runs_without_autograd(monkeypatch):
    """``scripts_torch/bench.py`` resets the peak memory before it counts a
    forward's host syncs, so that forward must keep no activations for a
    backward: ``host_syncs`` runs it without autograd.  (With autograd the
    printed peak counted the activations kept for a backward, well above
    what the inference forward needs.)"""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda *a: None)
    seen = []
    assert _bench().host_syncs(lambda: seen.append(torch.is_grad_enabled())) == []
    assert seen == [False]
