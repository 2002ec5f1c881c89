"""The port's tracing (``pasco_torch/utils/timing.py``) on the CPU, on a
``tiny_config`` scan through ``AdaptiveForward``, and the reduction of a
profile to the enqueue's split (``scripts_torch/profile_forward.py``) on
handmade events:

* outputs with tracing on are identical to outputs with it off;
* off, a span is one shared no-op, a counter records nothing, and no CUDA
  event is created;
* one call gives one ``forward`` id, its stage spans appear in order as
  children of ``pasco.dispatch`` and tile it (no operation but views,
  allocations and casts outside them);
* under ``torch.profiler`` the spans are host events nested in an outer
  span;
* a counter holding a tensor is read at ``drain()``, not before;
* stage spans take CUDA events from a pool, kernel spans none (a stand-in
  for ``torch.cuda.Event``);
* ``dispatch_split`` counts launches, syncs, driver ms and starved ms per
  dispatch and stage.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pasco_torch.utils import timing  # noqa: E402

STAGES = ["featurize", "encoder", "bottleneck", "decoder.s4", "decoder.s2", "decoder.s1",
          "refiner.s4", "refiner.s2", "refiner.s1", "transformer"]
# what the dispatch may run outside its stages: views, allocations, casts
OUTSIDE = {"aten::as_strided", "aten::alias", "aten::detach", "detach", "aten::empty",
           "aten::resolve_conj", "aten::resolve_neg", "aten::select", "aten::slice",
           "aten::to", "aten::unsqueeze", "aten::view", "aten::zero_", "aten::zeros",
           "aten::fill_"}


@pytest.fixture(autouse=True)
def fresh_recorder():
    timing.tracing(False)
    timing.drain()
    yield
    timing.tracing(False)
    timing.drain()


@pytest.fixture(scope="module")
def scan():
    """(AdaptiveForward over a tiny S=3 net, its input, the scan's box)."""
    from chip_smoke import eval_scene
    from pasco_torch.core.config import tiny_config
    from pasco_torch.inference.dispatch import AdaptiveForward
    from pasco_torch.models.unet import build_net, scene_to_model_input

    cfg = tiny_config(3)
    col = eval_scene(cfg, np.random.RandomState(0), n_points=1500, max_angle=10.0)
    net = build_net(cfg, device="cpu")
    net.reset_parameters(torch.Generator().manual_seed(0))
    fwd = AdaptiveForward(net)
    inp = scene_to_model_input(col, "cpu")
    return fwd, inp, fwd.box_for(inp)


def _flat(out):
    """Every tensor of a ``ModelOutput``, by path."""
    found = {}

    def walk(v, path):
        if isinstance(v, torch.Tensor):
            found[path] = v
        elif isinstance(v, dict):
            for k, x in v.items():
                walk(x, f"{path}.{k}")
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(x, f"{path}.{i}")
        elif hasattr(v, "__dataclass_fields__"):
            for k in v.__dataclass_fields__:
                walk(getattr(v, k), f"{path}.{k}")

    walk(out, "out")
    return found


class FakeEvent:
    """Stands in for ``torch.cuda.Event``: its time is the order of its
    record."""

    made = 0
    clock = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        FakeEvent.clock += 1
        self.t = FakeEvent.clock

    def elapsed_time(self, end):
        return float(end.t - self.t)


@pytest.fixture
def fake_cuda(monkeypatch):
    FakeEvent.made = FakeEvent.clock = 0
    syncs = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(1))
    return syncs


def test_outputs_identical_with_tracing_on(scan):
    fwd, inp, box = scan
    with torch.no_grad():
        off = _flat(fwd(inp, box))
        timing.tracing(True)
        on = _flat(fwd(inp, box))
        timing.tracing(False)
    assert off.keys() == on.keys() and len(off) > 20
    for k in off:
        assert off[k].dtype == on[k].dtype and torch.equal(off[k], on[k]), k
    assert len(timing.drain()["rows"]) == 1 + len(STAGES)


def test_off_records_nothing_and_makes_no_event(scan, fake_cuda):
    fwd, inp, box = scan
    assert timing.span("a") is timing.span("kernel.b", events=False)
    with timing.span("a") as inner:
        assert inner is None
        timing.count("c", torch.ones(1), 256)
    with torch.no_grad():
        fwd(inp, box)
    assert FakeEvent.made == 0
    assert timing.drain() == {"rows": [], "counters": {}}
    assert not fake_cuda        # nothing to wait for


def test_one_forward_one_id_and_the_stages_tile_it(scan):
    fwd, inp, box = scan
    timing.tracing(True)
    with torch.no_grad(), torch.profiler.profile() as prof:
        fwd(inp, box)
    timing.tracing(False)
    rows = timing.drain()["rows"]
    root = rows[0]
    assert root["name"] == "pasco.dispatch" and root["parent"] is None
    assert {r["forward"] for r in rows} == {root["forward"]}
    assert [r["name"] for r in rows[1:]] == [timing.PREFIX + s for s in STAGES]
    assert all(r["parent"] == root["id"] for r in rows[1:])
    assert all(r["device_ms"] is None for r in rows)    # no CUDA here
    # the host's time: the stages take the dispatch's but its own few ops
    assert sum(r["host_ms"] for r in rows[1:]) == pytest.approx(
        root["host_ms"] - root["self_ms"])
    assert 0 < root["self_ms"] < 0.1 * root["host_ms"]
    ev = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()]
    (d,) = [x for x in ev if x[2] == "pasco.dispatch"]
    stages = sorted(x for x in ev if x[2].startswith(timing.PREFIX) and x != d)
    assert [x[2] for x in stages] == [timing.PREFIX + s for s in STAGES]
    assert all(a[1] <= b[0] for a, b in zip(stages, stages[1:]))
    inside = [x for x in ev if d[0] <= x[0] < d[1] and not x[2].startswith(timing.PREFIX)]
    outside = {x[2] for x in inside if not any(s[0] <= x[0] < s[1] for s in stages)}
    assert len(inside) > 1000 and outside <= OUTSIDE, outside - OUTSIDE


def test_spans_nest_in_an_outer_span_under_the_profiler(scan):
    fwd, inp, box = scan
    timing.tracing(True)
    with torch.no_grad(), torch.profiler.profile() as prof:
        with torch.profiler.record_function("outer"):
            fwd(inp, box)
            fwd(inp, box)
    timing.tracing(False)
    drained = timing.drain()
    from torch.autograd import DeviceType

    ev = [e for e in prof.events() if e.name == "outer" or e.name.startswith(timing.PREFIX)]
    assert all(e.device_type == DeviceType.CPU for e in ev)
    (outer,) = [e for e in ev if e.name == "outer"]
    spans = [e for e in ev if e is not outer]
    assert len(spans) == len(drained["rows"]) == 2 * (1 + len(STAGES))
    assert all(outer.time_range.start <= e.time_range.start
               and e.time_range.end <= outer.time_range.end for e in spans)
    assert [r["forward"] for r in drained["rows"]] == [0] * 11 + [1] * 11


def test_tensor_counter_is_read_at_drain():
    t = torch.tensor([3], dtype=torch.int32)
    timing.tracing(True)
    timing.count("outside", 5)
    with timing.span("dispatch"):
        timing.count("cells", t, 256)
        timing.count("cells", 2)
        with timing.span("stage"):
            timing.count("cells", torch.tensor(1.5))
    with timing.span("dispatch"):
        timing.count("cells", t, 256)
    timing.tracing(False)
    t += 1      # the recorder holds the tensor, not its value at count()
    counters = timing.drain()["counters"]
    assert counters == {None: {"outside": 5}, 0: {"cells": 4 * 256 + 2 + 1.5},
                        1: {"cells": 4 * 256}}


def test_stage_spans_take_pooled_events_and_kernel_spans_none(fake_cuda):
    def forward():
        with timing.span("dispatch"):
            with timing.span("encoder"):
                with timing.span("kernel.masked_conv3", events=False):
                    pass
            with timing.span("transformer"):
                pass

    timing.tracing(True)
    forward()
    rows = timing.drain()["rows"]
    assert fake_cuda == [1] and FakeEvent.made == 6
    by = {r["name"]: r for r in rows}
    assert by["pasco.kernel.masked_conv3"]["device_ms"] is None
    assert by["pasco.kernel.masked_conv3"]["parent"] == by["pasco.encoder"]["id"]
    # events in record order: dispatch 1..6, encoder 2..3, transformer 4..5
    assert [by[f"pasco.{n}"]["device_ms"] for n in ("dispatch", "encoder", "transformer")] \
        == [5.0, 1.0, 1.0]
    forward()
    timing.tracing(False)
    assert len(timing.drain()["rows"]) == 4 and FakeEvent.made == 6   # the pool's


def test_drain_inside_a_span_raises():
    timing.tracing(True)
    with timing.span("dispatch"):
        with pytest.raises(RuntimeError, match="pasco.dispatch"):
            timing.drain()


def test_root_rows_keep_their_launches(monkeypatch):
    from pasco_torch import kernels

    monkeypatch.setitem(kernels.LAUNCHES, "masked_conv3", 10)
    timing.tracing(True)
    with timing.span("dispatch"):
        kernels.LAUNCHES["masked_conv3"] += 3
        with timing.span("encoder"):
            kernels.LAUNCHES["masked_conv3"] += 1
    timing.tracing(False)
    rows = timing.drain()["rows"]
    assert rows[0]["launches"] == {"masked_conv3": 4} and "launches" not in rows[1]


def _profile_forward():
    import importlib.util

    path = os.path.join(ROOT, "scripts_torch", "profile_forward.py")
    spec = importlib.util.spec_from_file_location("profile_forward", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dispatch_split_on_handmade_events():
    pf = _profile_forward()
    host = sorted([
        (0, 100, "pasco.dispatch"),
        (5, 50, "pasco.encoder"),
        (10, 20, "pasco.kernel.masked_conv3"),
        (50, 90, "pasco.transformer"),
        (1, 3, "cudaGetDevice"),                 # in the dispatch, outside its stages
        (12, 18, "cudaLaunchKernel"),            # in the kernel span: the encoder's
        (21, 22, "cuLaunchKernelEx"),
        (23, 25, "cudaMemcpyAsync"),
        (26, 27, "cudaEventRecord"),             # no launch
        (60, 80, "cudaStreamSynchronize"),
        (81, 83, "cudaMemsetAsync"),
        (200, 300, "pasco.dispatch"),
        (210, 211, "cudaLaunchKernelExC"),
        (110, 120, "cudaLaunchKernel"),          # between the dispatches
    ])
    device = [(0, 30), (25, 40), (70, 75), (95, 210), (230, 240), (250, 400)]
    first, second = pf.dispatch_split(host, device)
    assert (first["launches"], first["syncs"]) == (4, 1)
    assert first["driver_ms"] == pytest.approx((2 + 6 + 1 + 2 + 1 + 20 + 2) / 1e3)
    # gaps 40-70 (from the encoder) and 75-95 (from the transformer); 210-230
    # and 240-250 begin in the second dispatch, which has no stages
    assert first["starved_ms"] == pytest.approx(50 / 1e3)
    st = first["stages"]
    assert set(st) == {"(dispatch)", "pasco.encoder", "pasco.transformer"}
    assert (st["pasco.encoder"]["launches"], st["pasco.encoder"]["syncs"]) == (3, 0)
    assert st["pasco.encoder"]["starved_ms"] == pytest.approx(0.030)
    assert st["pasco.transformer"]["driver_ms"] == pytest.approx(0.022)
    assert st["(dispatch)"]["driver_ms"] == pytest.approx(0.002)
    assert (second["launches"], second["syncs"]) == (1, 0)
    assert second["starved_ms"] == pytest.approx(0.030)
    assert pf.idle_gaps([(5, 9), (0, 10), (12, 13)]) == [(10, 12)]


def test_span_table_and_profile_events_of_a_cpu_profile(scan):
    pf = _profile_forward()
    fwd, inp, box = scan
    timing.tracing(True)
    with torch.no_grad(), torch.profiler.profile() as prof:
        fwd(inp, box)
    timing.tracing(False)
    host, device = pf.profile_events(prof)
    assert device == []
    assert [n for _, _, n in host] == ["pasco.dispatch"] + [timing.PREFIX + s for s in STAGES]
    table = pf.span_table(timing.drain(), pf.dispatch_split(host, device))
    assert list(table)[:2] == ["pasco.dispatch", "(dispatch)"]
    assert set(table) == {"pasco.dispatch", "(dispatch)", *(timing.PREFIX + s for s in STAGES)}
    assert table["pasco.dispatch"]["launches"] == 0 and table["pasco.encoder"]["own_ms"] > 0
