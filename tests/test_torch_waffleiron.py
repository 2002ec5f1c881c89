"""The port's WaffleIron frontend (``pasco_torch/models/waffleiron.py``)
against the JAX package's (``pasco_tpu/models/waffleiron.py``) on the CPU,
at depth 4, 32 channels, grids ((32, 32), (32, 8), (32, 8)), 512 points of
which 400 valid:

* ``knn_indices`` and ``grid_cell_indices``: identical arrays;
* each module (``Embedding``, ``ChannelMix``, ``SpatialMix``,
  ``WaffleIron``, ``Segmenter``) on the JAX variables (random BatchNorm
  statistics, biases and LayerScales) through
  ``convert.waffleiron_flax_to_torch``: outputs in eval mode, and outputs
  and new running statistics in train mode, within ``TOL_REL * max|ref| +
  TOL_ABS`` (f32 on both sides, other summation orders; measured ~1e-6 of
  max|ref|);
* padded rows: zero tokens and the classifier's bias as logits;
* an empty grid cell reads 0 (``SpatialMix`` against a float64 numpy
  version of the flatten, the depthwise FFN and the inflate);
* ``waffleiron_flax_to_torch`` maps every key, and back;
* without a card the entry points raise.
"""

import numpy as np
import pytest
import torch

import jax

from pasco_tpu.models import waffleiron as ref
from pasco_torch.convert import waffleiron_flax_to_torch
from pasco_torch.models import waffleiron as port
from pasco_torch.models.norm import BatchNorm, commit_batch_stats

TOL_REL, TOL_ABS = 1e-4, 1e-5
GRIDS = ((32, 32), (32, 8), (32, 8))
C, DEPTH, P, N_VALID, K = 32, 4, 512, 400, 8


def scan_inputs(seed=0, grids=GRIDS):
    """feats [P, 5] ([intensity, xyz, |xyz|]), neighbors [K, P], cells
    [3, P], mask [P]: the extractor's layout, zero-padded past N_VALID."""
    r = np.random.RandomState(seed)
    xyz = r.rand(P, 3) * 40 - 20
    feats = np.zeros((P, 5), np.float32)
    feats[:N_VALID] = np.concatenate(
        [r.rand(P, 1), xyz, np.linalg.norm(xyz, axis=1, keepdims=True)], 1)[:N_VALID]
    nbrs = np.zeros((K, P), np.int32)
    nbrs[:, :N_VALID] = ref.knn_indices(xyz[:N_VALID], K)
    cells = np.zeros((3, P), np.int32)
    cells[:, :N_VALID] = ref.grid_cell_indices(xyz[:N_VALID], grids)
    mask = np.zeros(P, bool)
    mask[:N_VALID] = True
    return feats, nbrs, cells, mask


def randomise(variables, seed):
    """The JAX variables with random BatchNorm statistics and affines,
    biases and LayerScales (the kernels keep their init), as numpy."""
    r = np.random.RandomState(seed)

    def one(path, x):
        name, x = path[-1].key, np.asarray(x)
        if name == "mean":
            return (r.randn(*x.shape) * 0.3).astype(np.float32)
        if name in ("var", "scale", "layerscale"):
            return (0.5 + r.rand(*x.shape)).astype(np.float32)
        if name == "bias":
            return (r.randn(*x.shape) * 0.1).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(one, variables)


def t(a, dtype=None):
    a = torch.from_numpy(np.asarray(a))
    return a if dtype is None else a.to(dtype)


def port_args(feats, nbrs, cells, mask):
    return t(feats), t(nbrs, torch.int64), t(cells, torch.int64), t(mask)


def close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= TOL_REL * np.abs(want).max() + TOL_ABS, (what, err, np.abs(want).max())


def check_stats(mod, new_stats, what):
    """The port's running statistics after ``commit_batch_stats`` against
    the JAX ``batch_stats`` a training-mode apply returned."""
    commit_batch_stats(mod)
    want = waffleiron_flax_to_torch({}, new_stats)
    got = mod.state_dict()
    assert want and set(want) <= set(got)
    for k, v in want.items():
        close(got[k], v.numpy(), f"{what}: {k}")


# ---------------------------------------------------------------------------
# Host preprocessing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_host_indices_identical(seed):
    r = np.random.RandomState(seed)
    xyz = r.randn(3000, 3) * np.array([30, 30, 3])      # some past the FOV and z range
    for k in (5, 16):
        np.testing.assert_array_equal(port.knn_indices(xyz, k), ref.knn_indices(xyz, k))
    for grids in (GRIDS, port.GRIDS):
        np.testing.assert_array_equal(port.grid_cell_indices(xyz, grids),
                                      ref.grid_cell_indices(xyz, grids))
    np.testing.assert_array_equal(port.grid_cell_indices(xyz, fov=20.0, z_range=(-2.0, 1.0)),
                                  ref.grid_cell_indices(xyz, fov=20.0, z_range=(-2.0, 1.0)))


# ---------------------------------------------------------------------------
# Module by module
# ---------------------------------------------------------------------------


def _tokens(seed):
    r = np.random.RandomState(seed)
    tok = (r.randn(P, C) * 0.5).astype(np.float32)
    tok[N_VALID:] = 0.0
    return tok


def module_case(name):
    """(JAX module, port module, JAX call args, port call args)."""
    feats, nbrs, cells, mask = scan_inputs()
    f, nb, ce, m = port_args(feats, nbrs, cells, mask)
    tok = _tokens(1)
    if name == "Embedding":
        return (ref.Embedding(C), port.Embedding(5, C), (feats, nbrs, mask), (f, nb, m))
    if name == "ChannelMix":
        return (ref.ChannelMix(C), port.ChannelMix(C), (tok, mask), (t(tok), m))
    if name == "SpatialMix":
        return (ref.SpatialMix(C, GRIDS[0]), port.SpatialMix(C, GRIDS[0]),
                (tok, cells[0], mask), (t(tok), ce[0], m))
    if name == "WaffleIron":
        return (ref.WaffleIron(C, DEPTH, GRIDS), port.WaffleIron(C, DEPTH, GRIDS),
                (tok, cells, mask), (t(tok), ce, m))
    return (ref.Segmenter(n_classes=19, channels=C, depth=DEPTH, in_channels=5,
                          grids_shape=GRIDS),
            port.Segmenter(n_classes=19, channels=C, depth=DEPTH, in_channels=5,
                           grids_shape=GRIDS),
            (feats, nbrs, cells, mask), (f, nb, ce, m))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["Embedding", "ChannelMix", "SpatialMix", "WaffleIron",
                                  "Segmenter"])
def test_module_matches_reference(name, train):
    jmod, pmod, jargs, pargs = module_case(name)
    variables = jax.jit(lambda *a: jmod.init({"params": jax.random.PRNGKey(0)}, *a, False))(
        *jargs)
    variables = randomise(variables, seed=3)
    pmod.load_state_dict(waffleiron_flax_to_torch(variables))
    pmod.train(train)
    if train:
        want, new = jax.jit(lambda v, *a: jmod.apply(v, *a, True, mutable=["batch_stats"]))(
            variables, *jargs)
    else:
        want = jax.jit(lambda v, *a: jmod.apply(v, *a, False))(variables, *jargs)
    got = pmod(*pargs)
    for i, (g, w) in enumerate(zip(*((got, want) if name == "Segmenter" else
                                     ((got,), (want,))))):
        close(g, w, f"{name} output {i}")
    if train:
        check_stats(pmod, new["batch_stats"], name)


def test_padded_rows_stay_zero():
    feats, nbrs, cells, mask = scan_inputs()
    net = port.Segmenter(n_classes=19, channels=C, depth=DEPTH, grids_shape=GRIDS)
    net.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        net.classif.bias.normal_(generator=torch.Generator().manual_seed(1))
    for train in (False, True):
        net.train(train)
        logits, tokens = net(*port_args(feats, nbrs, cells, mask))
        assert torch.isfinite(logits).all()
        assert (tokens[N_VALID:] == 0).all()
        assert torch.equal(logits[N_VALID:], net.classif.bias.expand(P - N_VALID, -1))
        # the reference's own check (tests/test_waffleiron.py:43)
        assert torch.allclose(tokens[401], tokens[510])


def _spatial_mix_f64(mod, tokens, cell_ind, mask):
    """SpatialMix in float64 numpy: BN (running statistics), the mean per
    cell with an empty cell 0, depthwise 3x3 -> ReLU -> depthwise 3x3
    ('same'), the inflate, LayerScale."""
    H, W = mod.grid_shape
    sd = {k: v.double().numpy() for k, v in mod.state_dict().items()}
    x = tokens.double().numpy()
    h = (x - sd["norm.mean"]) / np.sqrt(sd["norm.var"] + 1e-5) * sd["norm.scale"] + sd["norm.bias"]
    h[~mask] = 0
    grid = np.zeros((H * W, x.shape[1]))
    cnt = np.zeros(H * W)
    for i in np.nonzero(mask)[0]:
        grid[cell_ind[i]] += h[i]
        cnt[cell_ind[i]] += 1
    grid = (grid / np.maximum(cnt, 1)[:, None]).reshape(H, W, -1)

    def dw(g, w):                      # w (C, 1, 3, 3), cross-correlation
        pad = np.pad(g, ((1, 1), (1, 1), (0, 0)))
        return sum(pad[a:a + H, b:b + W] * w[:, 0, a, b] for a in range(3) for b in range(3))

    grid = dw(np.maximum(dw(grid, sd["dw1"]), 0), sd["dw2"]).reshape(H * W, -1)
    out = grid[cell_ind] * sd["layerscale"]
    out[~mask] = 0
    return x + out, cnt


def test_empty_cells_read_zero():
    r = np.random.RandomState(4)
    grid = (16, 16)
    n = 40
    mask = np.ones(n, bool)
    mask[-5:] = False
    cell_ind = r.randint(0, 256, n)
    tokens = torch.from_numpy(r.randn(n, C).astype(np.float32))
    mod = port.SpatialMix(C, grid).eval()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
        mod.norm.var.uniform_(0.5, 1.5, generator=g)
    want, cnt = _spatial_mix_f64(mod, tokens, cell_ind, mask)
    assert (cnt == 0).sum() > 200          # most cells empty
    got = mod(tokens, torch.from_numpy(cell_ind), torch.from_numpy(mask))
    close(got, want, "SpatialMix on an almost empty grid")


def test_convert_maps_every_key():
    jnet, pnet, jargs, _ = module_case("Segmenter")
    variables = jax.tree_util.tree_map(np.asarray, randomise(
        jax.jit(lambda *a: jnet.init({"params": jax.random.PRNGKey(0)}, *a))(*jargs), 5))
    sd = waffleiron_flax_to_torch(variables)
    assert set(sd) == set(pnet.state_dict())
    pnet.load_state_dict(sd)
    flat = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(variables[coll])[0]:
            flat[tuple(p.key for p in path)] = leaf
    assert len(flat) == len(sd)
    for path, leaf in flat.items():
        *mods, name = path
        back = pnet.state_dict()[".".join([*mods, "weight" if name == "kernel" else name])]
        back = back.numpy()
        if name == "kernel":
            back = back.T
        elif name in ("dw1", "dw2"):
            back = back.transpose(2, 3, 1, 0)
        np.testing.assert_array_equal(back, leaf, err_msg=str(path))
    # the containers: net.init's dict, the 0-d object array of an npz
    holder = np.empty((), object)
    holder[()] = variables
    for form in (variables, holder):
        got = waffleiron_flax_to_torch(form)
        assert all(torch.equal(got[k], sd[k]) for k in sd)
    n_bn = sum(isinstance(m, BatchNorm) for m in pnet.modules())
    assert n_bn == 3 + 2 * DEPTH


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.segmenter_device("cuda")
    assert port.segmenter_device("cpu") == torch.device("cpu")


def test_cell_indices_past_the_grid():
    """Cell indices outside ``[0, H*W)`` (a grid smaller than the indices
    were made for): the flatten drops them, as JAX's ``segment_sum`` does,
    and the inflate clips them."""
    feats, nbrs, cells, mask = scan_inputs(seed=2, grids=((64, 64), (64, 8), (64, 8)))
    tok = _tokens(5)
    jmod, pmod = ref.SpatialMix(C, GRIDS[0]), port.SpatialMix(C, GRIDS[0])
    args = (tok, cells[0] - 1500, mask)         # past both ends of the 32 x 32 grid
    assert (args[1][mask] < 0).any() and (args[1][mask] >= 32 * 32).any()
    variables = randomise(jax.jit(lambda *a: jmod.init({"params": jax.random.PRNGKey(0)}, *a,
                                                       False))(*args), seed=6)
    pmod.load_state_dict(waffleiron_flax_to_torch(variables))
    for train in (False, True):
        want = jmod.apply(variables, *args, train, mutable=["batch_stats"])[0]
        close(pmod.train(train)(t(tok), t(args[1], torch.int64), t(mask)), want,
              f"SpatialMix past the grid, train={train}")
