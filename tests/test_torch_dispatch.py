"""The port's scene-adaptive box dispatch (``pasco_torch/inference/
dispatch.py``) against the reference's, at ``tiny_config`` in f32 on the
CPU (one JAX compile: the reference's full-box forward).

* ``candidate_boxes`` and ``pick_box`` equal the reference's on the cases of
  ``tests/test_dispatch.py`` and on 200 seeded bboxes;
* ``AdaptiveForward`` picks (48, 48, 16) for ``make_input(cfg, rng=0)``;
* the small-box forward against the full-box forward of the same net:
  extraction coords and masks identical at every scale; every f32 output
  (query and voxel logits, refined features) within ``1e-5`` absolute
  plus ``1e-5`` relative; the semantic logits, which both forwards round
  to bf16, within one bf16 ulp (a value next to a rounding boundary may
  round the other way);
* the small-box forward against the reference's full-box forward on shared
  weights: coords identical, logits within ``test_torch_slice.py``'s
  ``rtol=2e-2, atol=1e-2``;
* the shapes the CUDA wrappers meet at every box of the flagship ladder
  (256/288/320/352): tile counts and partial tiles of ``masked_conv3``,
  even extents for ``down2_fused``, ``up_preamble``'s tile count,
  ``stream_extract``'s tiles and its workspace over calls that alternate
  between boxes.
"""

import jax
import numpy as np
import pytest
import torch
from test_model_forward import labelweights, make_input
from test_torch_convert import flatten, init_reference, nest, tiny_f32_config

from pasco_torch.convert import flax_to_torch
from pasco_torch.inference import dispatch
from pasco_torch.models.unet import ModelInput, build_net

torch.set_num_threads(1)

SMALL = (48, 48, 16)


@pytest.mark.parametrize("gmin,gmax,want", [
    ((0, 0, 0), (31, 31, 15), SMALL),
    ((0, 0, 0), (47, 47, 15), SMALL),
    ((0, 0, 0), (48, 31, 15), (64, 64, 16)),
    ((0, 0, 0), (80, 31, 15), (64, 64, 16)),      # nothing covers: the largest
    ((8, 8, 0), (50, 50, 15), SMALL),             # offset minimum
])
def test_pick_box_cases(gmin, gmax, want):
    from pasco_tpu.inference.dispatch import pick_box

    cands = (SMALL, (64, 64, 16))
    got = dispatch.pick_box(cands, np.array(gmin), np.array(gmax))
    assert got == pick_box(cands, np.array(gmin), np.array(gmax)) == want


@pytest.mark.parametrize("name", ["PaSCoConfig", "tiny_config", "flagship_narrow_config"])
def test_pick_box_matches_reference_seeded(name):
    import dataclasses

    from pasco_tpu.core import config as jcfg
    from pasco_tpu.inference.dispatch import candidate_boxes, pick_box

    from pasco_torch.core import config as tcfg

    ref_cfg, cfg = getattr(jcfg, name)(), getattr(tcfg, name)()
    cands = dispatch.candidate_boxes(cfg)
    assert cands == candidate_boxes(ref_cfg)
    fixed = cfg.replace(scene=dataclasses.replace(cfg.scene, box_candidates=()))
    assert dispatch.candidate_boxes(fixed) == (tuple(cfg.scene.box_extent),)
    r = np.random.RandomState(0)
    big = np.asarray(cands[-1])
    picked = set()
    for _ in range(200):
        gmin = r.randint(-40, 40, 3)
        gmax = gmin + (r.rand(3) * 1.15 * big).astype(int)
        got = dispatch.pick_box(cands, gmin, gmax)
        assert got == pick_box(cands, gmin, gmax)
        picked.add(got)
    assert picked == set(cands)


def _torch_input(inp):
    return ModelInput(*(torch.from_numpy(np.array(a)) for a in inp))


@pytest.fixture(scope="module")
def outputs():
    """The port's net on the reference's initial weights: small box, full
    box, and the reference's full-box forward.  The bottleneck convolves
    its whole box, so the cells between the bbox and the box edge make the
    outputs depend on the box (ROADMAP.md, queue 3); at these weights
    (BatchNorm the identity, as ``tests/test_dispatch.py`` has them) that
    stays within the bounds below, while BN shifts flip kept cells."""
    cfg = tiny_f32_config()
    inp = make_input(cfg, rng=0)
    jnet, lw, variables = init_reference(cfg, inp)
    flat = flatten(variables)
    jout = jax.jit(lambda v, i: jnet.apply(v, i, lw, train=False))(nest(flat), inp)
    net = build_net(cfg, device="cpu")
    net.load_state_dict(flax_to_torch(flat), strict=True)
    fwd = dispatch.AdaptiveForward(net, {k: torch.tensor(np.asarray(v))
                                         for k, v in labelweights(cfg).items()})
    tin = _torch_input(inp)
    with torch.no_grad():
        small, full = fwd(tin), net(tin)
    return fwd, tin, small, full, jout


def test_box_for_picks_small(outputs):
    fwd, tin, *_ = outputs
    assert fwd.cands == (SMALL, (64, 64, 16))
    assert fwd.box_for(tin) == SMALL


def _grids(out):
    for which in ("sem_grids", "panop_grids"):
        for scale in (1, 2, 4):
            yield f"{which}[{scale}]", getattr(out, which)[scale]


def test_small_box_matches_full_box(outputs):
    _, _, small, full, _ = outputs
    for name, g in _grids(small):
        h = dict(_grids(full))[name]
        assert torch.equal(g.coords, h.coords) and torch.equal(g.mask, h.mask), name
        assert g.mask.sum() > 0, name
        if name.startswith("panop"):
            np.testing.assert_allclose(g.feats.numpy(), h.feats.numpy(), rtol=1e-5, atol=1e-5)
    p, q = small.predictor, full.predictor
    np.testing.assert_allclose(p.query_logits.numpy(), q.query_logits.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p.voxel_logits.numpy(), q.voxel_logits.numpy(), rtol=1e-5, atol=1e-5)
    for scale in (1, 2, 4):
        a, b = small.sem_logits[scale].numpy(), full.sem_logits[scale].numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
        assert (np.abs(a - b) <= ulp).all(), scale


def test_small_box_matches_reference_full_box(outputs):
    _, _, small, _, jout = outputs
    for name, g in _grids(small):
        which, scale = name[:-3], int(name[-2])
        jg = getattr(jout, which)[scale]
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(jg.mask))
        np.testing.assert_array_equal(g.coords.numpy(), np.asarray(jg.coords))
    for scale in (1, 2, 4):
        np.testing.assert_allclose(small.sem_logits[scale].numpy(),
                                   np.asarray(jout.sem_logits[scale]), rtol=2e-2, atol=1e-2)
    np.testing.assert_allclose(small.predictor.query_logits.numpy(),
                               np.asarray(jout.predictor.query_logits), rtol=2e-2, atol=1e-2)
    np.testing.assert_allclose(small.predictor.voxel_logits.numpy(),
                               np.asarray(jout.predictor.voxel_logits), rtol=2e-2, atol=1e-2)


# The flagship ladder: the extents the kernels meet at s1/s2/s4/s8
# ([X, Z, Y]), the masked_conv3 tiles (4 x 4 x 16) and the stream_extract
# tiles of s1 (16384 cells).
LADDER = [(256, 2_097_152, 128), (288, 2_654_208, 162), (320, 3_276_800, 200),
          (352, 3_964_928, 242)]


@pytest.mark.parametrize("side,cells,extract_tiles", LADDER)
def test_ladder_shapes_in_the_wrappers(side, cells, extract_tiles):
    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.ops import conv, deconv, extract

    assert (side, side, 32) in dispatch.candidate_boxes(PaSCoConfig())
    ext = {s: (side // s, 32 // s, side // s) for s in (1, 2, 4, 8)}
    assert np.prod(ext[1]) == cells
    for s in (1, 2, 4):                       # the downs' inputs: even extents
        assert all(e % 2 == 0 for e in ext[s]), (s, ext[s])
    for s, (X, Z, Y) in ext.items():
        m = torch.zeros((X, Z, Y), dtype=torch.bool)
        m[-1, -1, -1] = True                  # the last cell: in the last tile
        t = conv.conv_tiles(m)
        nbx, nbz, nby = -(-X // 4), -(-Z // 4), -(-Y // 16)
        assert t.n_tiles == nbx * nbz * nby and int(t.n_active) == 1
        assert int(t.ids[0]) == t.n_tiles - 1
        # the last y tile holds Y % 16 rows (or 16): 4 at 36, 8 at 40, 12 at 44
        assert Y - (nby - 1) * 16 == (Y % 16 or 16)
        if s < 8:                             # a parent level for up_preamble
            X2, Z2, Y2 = ext[2 * s]
            ut = deconv.up_tiles(m)
            assert ut.n_tiles == -(-(X2 * Z2 * Y2) // deconv.ROWS)
            assert int(ut.n_active) == 1 and int(ut.ids[0]) == ut.n_tiles - 1
    assert -(-cells // extract.TILE) == extract_tiles


def test_extract_workspace_alternating_boxes():
    """Calls that alternate between boxes (352 -> 256 -> 320 -> 288) share
    one workspace: it grows to the largest tile count once, never shrinks,
    and every call takes a new epoch."""
    from pasco_torch.ops import extract

    ws = extract._Workspace()
    tiles = {side: -(-cells // extract.TILE) for side, cells, _ in LADDER}
    seen = []
    for k in range(20):
        side = (352, 256, 320, 288)[k % 4]
        buf, n, epoch = ws.take(tiles[side], torch.device("cpu"))
        assert n == 242 and buf.numel() == 242 and n >= tiles[side]
        seen.append((buf.data_ptr(), epoch))
    assert len({p for p, _ in seen}) == 1
    assert [e for _, e in seen] == list(range(1, 21))
