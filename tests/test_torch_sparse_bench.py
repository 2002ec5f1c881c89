"""The sparse substrate in the benchmark, on the CPU at ``tiny_config``
size:

* each sparse op of the port (submanifold, strided, generative, max pool)
  against its masked dense form in the benchmark's plain reference
  (``benchmark/reference/sparse_model.py``), in f32;
* the whole ``PaSCoNet`` eval forward against the reference, rows matched
  by coordinate, with every cap raised so that none binds and with caps
  that bind at every stage; the float8 control fails the same limits;
* the program's spans and counters in a sparse forward, and its output
  bit-equal with the recorder on and off;
* the new readers and work counts on handmade inputs.

``tests/test_torch_bench_cells.py`` runs the new kind through the harness.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import program, run, scans, weights  # noqa: E402
from benchmark.flops import HBM_BYTES_S, PEAK_BF16  # noqa: E402
from benchmark.kinds import eval_scans_sparse  # noqa: E402
from benchmark.reference.compare import compare, compare_scan, follow  # noqa: E402
from benchmark.reference.control import round_fp8  # noqa: E402
from benchmark.reference.sparse_model import SparseReference  # noqa: E402
from pasco_torch.core.sparse import Box, SparseGrid  # noqa: E402
from pasco_torch.ops import sparse_conv as PC  # noqa: E402
from pasco_torch.utils import timing  # noqa: E402

torch.set_num_threads(1)

# the port in float32 against the float32 reference (the attention rounds
# to bfloat16 inside, so the transformer's numbers read more)
LIMITS = {"logit_gap": 1e-5, "sem_rel": 1e-5, "mask_rel": 0.005, "query_rel": 0.0025}
STAGES = ["featurize", "encoder", "bottleneck", "decoder.s4", "decoder.s2", "decoder.s1",
          "refiner.s4", "refiner.s2", "refiner.s1", "transformer"]
SEED = 2 ** 33 + 5


@pytest.fixture(autouse=True)
def fresh_recorder():
    timing.tracing(False)
    timing.drain()
    yield
    timing.tracing(False)
    timing.drain()


def tiny(caps=None):
    """(configuration dict, traffic dict) of a tiny sparse cell in float32."""
    from pasco_torch.core.config import tiny_config

    cfg = tiny_config(1).to_dict()
    cfg["model"]["compute_dtype"] = "float32"
    cfg["model"]["substrate"] = "sparse"
    cfg["capacity"].update(caps or {})
    cfg["limits"] = {"logit_gap": 0.02, "sem_rel": 0.01, "mask_rel": 0.005, "query_rel": 0.0025}
    traffic = dict(kind="eval_scans_sparse", pool=2, points=2000, angles_deg=[3, 12, 20, 30],
                   max_translation=[0.2, 0.2, 0.1], workers=1)
    return cfg, traffic


UNBOUND = {"dec_s4": 1024, "dec_s2": 8192, "dec_s1": 65536, "panop_s4": 1024,
           "panop_s2": 8192, "panop_s1": 65536}
BOUND = {"bottleneck": 72, "ups_s4": 300, "dec_s4": 90, "dec_s2": 500, "dec_s1": 2000,
         "enc_s2": 400, "enc_s4": 120, "panop_s4": 60, "panop_s2": 300, "panop_s1": 900}


# ---- each op against its masked dense form ------------------------------------

CORNER = (-8, 8, -16)       # a multiple of 8, as a scan's box corner is
EXTENT = (24, 16, 12)


def op_reference():
    ref = SparseReference({"model": dict(n_infers=1, n_classes=2, f=2, res_blocks=1,
                                         heavy_decoder=False)}, {})
    ref.box_min = torch.tensor(CORNER)
    ref.box_extent = EXTENT
    return ref


def random_grid(g, stride, n_cells, ch, cap):
    """A grid of ``cap`` rows: ``n_cells`` distinct cells at ``stride`` in
    the box, the last rows masked; and its dense form ``(x, mask)``."""
    ref = op_reference()
    dims = ref.dims(stride)
    flat = torch.randperm(int(np.prod(dims)), generator=g)[:n_cells]
    rel = torch.stack([flat // (dims[1] * dims[2]), (flat // dims[2]) % dims[1],
                       flat % dims[2]], 1)
    coords = torch.zeros((cap, 4), dtype=torch.int32)
    coords[:n_cells, 1:] = (rel * stride + torch.tensor(CORNER)).int()
    feats = torch.randn((cap, ch), generator=g)
    mask = torch.arange(cap) < n_cells
    x = torch.zeros((*dims, ch))
    m = torch.zeros(dims, dtype=torch.bool)
    x[rel[:, 0], rel[:, 1], rel[:, 2]] = feats[:n_cells]
    m[rel[:, 0], rel[:, 1], rel[:, 2]] = True
    return SparseGrid(coords, feats, mask, stride), x, m


def at(ref, vol, coords, stride):
    idx, inside = ref.flat(coords[:, 1:].long(), stride)
    assert inside.all()
    return vol.reshape(-1, vol.shape[-1])[idx]


def assert_close(got, want):
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item() + 1e-6, err


@pytest.mark.parametrize("op", ["submanifold", "strided", "generative", "max_pool"])
def test_sparse_op_against_masked_dense(op):
    g = torch.Generator().manual_seed(7)
    ref = op_reference()
    box = Box.create(torch.tensor(CORNER), EXTENT)
    grid, x, m = random_grid(g, 2 if op == "generative" else 1, 300, 6, 340)
    w = torch.randn((27 if op == "submanifold" else 8, 6, 5), generator=g) * 0.2
    b = torch.randn(5, generator=g)
    if op == "submanifold":
        out = PC.submanifold_conv3d(grid, box, w, b, torch.float32)
        want = ref.subm(x, m, w, b)
    elif op == "strided":
        out = PC.strided_conv3d(grid, box, w, 320, b, torch.float32)
        pooled = ref.pool_mask(m)
        assert int(out.mask.sum()) == int(pooled.sum())
        want = ref.down(x, m, pooled, w, b)
    elif op == "generative":
        out = PC.generative_deconv3d(grid, w, b, torch.float32)
        want = ref.up(x, m, w, b, ref.dims(1))
    else:
        out = PC.sparse_max_pool(grid, 2, box, 320)
        want, pooled = ref.max_pool(x, m)
        assert int(out.mask.sum()) == int(pooled.sum())
    valid = out.mask
    assert valid.any()
    assert_close(out.feats[valid], at(ref, want, out.coords[valid], out.stride))


# ---- the whole forward --------------------------------------------------------


def port_outputs(cfg, traffic, seed):
    """(the pool, the weights, the port's host copy of each scan)."""
    from benchmark.kinds.eval_scans import HostBuffers, one_scan

    pool = scans.make_pool(traffic, cfg, seed, 1)
    w = weights.make_weights(eval_scans_sparse.parameter_shapes(cfg), seed, "cpu")
    fwd = program.build_forward(cfg, w, "cpu")
    bufs = HostBuffers()
    with torch.no_grad():
        hosts = [one_scan(fwd, program.model_input(s, "cpu"), program.pick_box(fwd, s), bufs,
                          j, judged=True)[0] for j, s in enumerate(pool)]
    return pool, w, hosts


@pytest.mark.parametrize("caps", [UNBOUND, BOUND], ids=["no_cap_binds", "every_cap_binds"])
def test_forward_against_reference_and_control_fails(caps):
    cfg, traffic = tiny(caps=caps)
    pool, w, hosts = port_outputs(cfg, traffic, SEED)
    with torch.no_grad():
        for scan, host in zip(pool, hosts):
            kept = {k: int(v.sum()) for k, v in host.items() if k.endswith(".mask")}
            if caps is BOUND:
                assert all(kept[k] == host[k].shape[-1] for k in kept), kept
            else:
                assert all(kept[k] < host[k].shape[-1] for k in kept), kept
            got = compare_scan(host, SparseReference(cfg, w), scan, 1, "cpu")
            assert all(got[k] <= v for k, v in LIMITS.items()), got
            low = SparseReference(cfg, w, round_fp8).forward(scan, "cpu")
            bad = compare(low, follow(SparseReference(cfg, w), scan, low, "cpu"))
            assert any(bad[k] > cfg["limits"][k] for k in LIMITS), bad


def test_reference_records_the_found_pairs():
    cfg, traffic = tiny()
    pool, w, _ = port_outputs(cfg, traffic, SEED)
    ref = SparseReference(cfg, w)
    with torch.no_grad():
        ref.forward(pool[0], "cpu")
    convs = [c for c in ref.calls if c["kind"] == "conv3"]
    # 7 encoder convs a stage but s1's 6, 7 a decoder stage, 2 a refiner
    assert len(convs) == 6 + 3 * 7 + 3 * 7 + 3 * 2
    subm = [c for c in convs if c["taps"] == 27]
    assert len(subm) == 6 + 3 * 6 + 3 * 6 + 3 * 2
    assert all(c["cells"] <= c["pairs"] <= 27 * c["cells"] for c in subm)
    # a down conv reads each child once, an up conv each parent for 8 children
    eight = [c for c in convs if c["taps"] == 8]
    assert sorted(c["pairs"] == c["rows_in"] for c in eight) == [False] * 3 + [True] * 3
    assert all(c["pairs"] == 8 * c["rows_in"] for c in eight if c["pairs"] != c["rows_in"])


# ---- the program's spans and counters ---------------------------------------


@pytest.fixture(scope="module")
def sparse_scan():
    cfg, traffic = tiny()
    pool = scans.make_pool(traffic, cfg, SEED, 1)
    w = weights.make_weights(eval_scans_sparse.parameter_shapes(cfg), SEED, "cpu")
    fwd = program.build_forward(cfg, w, "cpu")
    return fwd, program.model_input(pool[0], "cpu"), program.pick_box(fwd, pool[0])


def test_sparse_forward_spans_and_bit_equal_outputs(sparse_scan):
    fwd, inp, box = sparse_scan
    with torch.no_grad():
        off = fwd(inp, box)
        timing.tracing(True)
        on = fwd(inp, box)
        timing.tracing(False)
    rows = timing.drain()["rows"]
    names = [r["name"] for r in rows]
    assert names[0] == "pasco.dispatch"
    stages = [r["name"][len("pasco."):] for r in rows if r["parent"] == rows[0]["id"]]
    assert stages == STAGES
    # submanifold maps of the encoder, decoder and refiners, and the three downs' maps
    assert names.count("pasco.sparse.rulebook") == 4 + 3 + 3 + 3
    assert names.count("pasco.sparse.conv") == 54
    assert all(r["forward"] == 0 for r in rows)
    for a, b in ((off.sem_logits[1], on.sem_logits[1]),
                 (off.predictor.voxel_logits, on.predictor.voxel_logits),
                 (off.panop_grids[1].coords, on.panop_grids[1].coords)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("op", ["submanifold", "strided", "generative"])
def test_counters_are_the_found_pairs(op):
    g = torch.Generator().manual_seed(3)
    box = Box.create(torch.tensor(CORNER), EXTENT)
    grid, _, m = random_grid(g, 2, 200, 4, 256)
    timing.tracing(True)
    with timing.span("dispatch"):
        if op == "submanifold":
            rb = PC.build_rulebook(grid.coords, grid.mask, box, 2, 3)
            PC.submanifold_conv3d(grid, box, torch.randn(27, 4, 4), rulebook=rb)
            want = (int(rb.found.sum()), rb.found.numel())
        elif op == "strided":
            out = PC.strided_conv3d(grid, box, torch.randn(8, 4, 4), 128)
            want = (200, 8 * 128)            # each valid row is one parent's child
            assert int(out.mask.sum()) <= 128
        else:
            PC.generative_deconv3d(grid, torch.randn(8, 4, 4))
            want = (8 * 200, 8 * 256)
    timing.tracing(False)
    d = timing.drain()
    c = d["counters"][0]
    assert (c["sparse_conv.pairs"], c["sparse_conv.rows"]) == want
    # a kernel map (a submanifold rulebook, a down conv's unique and map) is
    # timed beside, not inside, its conv's gather-GEMM-scatter
    spans = ["pasco.dispatch"] + ["pasco.sparse.rulebook"] * (op != "generative")
    assert [r["name"] for r in d["rows"]] == spans + ["pasco.sparse.conv"]
    assert all(r["parent"] == d["rows"][0]["id"] for r in d["rows"][1:])


def test_counters_off_record_nothing():
    g = torch.Generator().manual_seed(3)
    box = Box.create(torch.tensor(CORNER), EXTENT)
    grid, _, _ = random_grid(g, 1, 50, 4, 64)
    PC.submanifold_conv3d(grid, box, torch.randn(27, 4, 4))
    assert timing.drain() == {"rows": [], "counters": {}}


# ---- the new readers and work counts --------------------------------------------


def _row(name, i, parent, forward, ms):
    return dict(name=name, id=i, parent=parent, forward=forward, device_ms=ms)


def test_span_readers_on_handmade_rows():
    rows = []
    for f in range(2):
        base = len(rows)
        rows.append(_row("pasco.dispatch", base, None, f, 100.0))
        rows.append(_row("pasco.sparse.conv", base + 1, base, f, 30.0))
        rows.append(_row("pasco.sparse.conv", base + 2, base, f, 10.0 + f))
        rows.append(_row("pasco.sparse.rulebook", base + 3, base, f, 2.0))
    call = dict(kind="conv3", cells=1000, pairs=20000, ci=64, co=64, taps=27, rows_in=1000,
                skip=0, mask_cells=0)
    trace = {"program": {"rows": rows, "counters": {}}, "scans": [0, 1],
             "pool_calls": {0: [call], 1: [call, dict(kind="mm", rows=9, k=9, n=9)]}}
    read = {m: run.read_metric(m, trace) for m in
            ("sparse.conv_ms", "sparse.rulebook_ms", "sparse_conv_roofline")}
    assert read["sparse.conv_ms"] == pytest.approx(40.5)
    assert read["sparse.rulebook_ms"] == pytest.approx(2.0)
    nbytes = 2 * (1000 * 64 + 27 * 64 * 64 + 1000 * 64)
    least = max(2 * 20000 * 64 * 64 / PEAK_BF16, nbytes / HBM_BYTES_S)
    assert read["sparse_conv_roofline"] == pytest.approx(100 * least / 40.5e-3)
    empty = copy.deepcopy(trace)
    del empty["program"]
    assert all(run.read_metric(m, empty) is None for m in read)
