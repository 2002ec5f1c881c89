"""The CUDA-graph path of ``AdaptiveForward`` (``pasco_torch/inference/
dispatch.py``) on the CPU: what a graph is keyed by, which calls take it,
when its graphs are dropped, and its counters.  Capture and replay need a
card: ``tests/test_torch_cuda.py -k graph_forward`` holds them there.

* ``graph_key`` tells boxes, input shapes and dtypes apart, and gives one
  key to the same call;
* ``graph_for`` captures once per key (a stand-in capture here);
* the CPU, training mode, a gradient, the program's tracing on and the
  sparse substrate run eagerly, counted in ``GRAPHS["eager"]``;
* a parameter's in-place update, ``load_state_dict`` (in place, and with
  ``assign=True``) and a buffer's update drop the graphs; another module
  built keeps them;
* a replay copies its input in, hands back clones, and counts in
  ``GRAPHS`` alone, never in ``kernels.LAUNCHES``;
* ``kernels.reset_launches`` zeroes ``GRAPHS``;
* ``_map`` rebuilds a ``ModelOutput`` leaf by leaf, its types kept.
"""

import dataclasses
import os
import sys
from types import SimpleNamespace

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pasco_torch import kernels  # noqa: E402
from pasco_torch.core.config import tiny_config  # noqa: E402
from pasco_torch.core.sparse import SparseGrid  # noqa: E402
from pasco_torch.inference import dispatch  # noqa: E402
from pasco_torch.models.transformer import PredictorOutput  # noqa: E402
from pasco_torch.models.unet import ModelInput, ModelOutput, build_net  # noqa: E402
from pasco_torch.utils import timing  # noqa: E402

torch.set_num_threads(1)


def _input(points=64, dtype=torch.float32, batch=()):
    def z(*shape, dt=torch.int32):
        return torch.zeros((*batch, *shape), dtype=dt)

    return ModelInput(z(points, 8, dt=dtype), z(points, 4), z(points, dt=torch.bool), z(3), z(3),
                      z(1, 3), z(1, 3))


@pytest.fixture
def net():
    n = build_net(tiny_config(), device="cpu")
    n.reset_parameters(torch.Generator().manual_seed(0))
    return n


@pytest.fixture
def fwd(net, monkeypatch):
    """An ``AdaptiveForward`` whose capture is a stand-in that records its
    keys."""
    f = dispatch.AdaptiveForward(net)
    f.captured = []

    def capture(key, inp, box):
        f.captured.append(key)
        return object()

    monkeypatch.setattr(f, "_capture", capture)
    return f


def test_graph_key_tells_calls_apart():
    box = (64, 64, 16)
    key = dispatch.graph_key(_input(), box)
    assert key == dispatch.graph_key(_input(), list(box))
    others = [dispatch.graph_key(_input(), (48, 48, 16)),
              dispatch.graph_key(_input(points=65), box),
              dispatch.graph_key(_input(dtype=torch.bfloat16), box),
              dispatch.graph_key(_input(batch=(2,)), box)]
    assert len({key, *others}) == 5


def test_graph_for_captures_once_per_key(fwd):
    a, b = _input(), _input(points=65)
    first = fwd.graph_for(a, (64, 64, 16))
    assert fwd.graph_for(_input(), (64, 64, 16)) is first
    fwd.graph_for(a, (48, 48, 16))
    fwd.graph_for(b, (64, 64, 16))
    fwd.graph_for(b, (64, 64, 16))
    assert len(fwd.captured) == 3 and len(set(fwd.captured)) == 3


def _on_card():
    return SimpleNamespace(point_feats=SimpleNamespace(is_cuda=True))


def test_graphed_only_for_the_dense_inference_on_the_card(net):
    fwd = dispatch.AdaptiveForward(net)
    with torch.no_grad():
        assert fwd.graphed(_on_card())
        assert not fwd.graphed(_input())                     # the CPU
        net.train()
        assert not fwd.graphed(_on_card())                   # training
        net.eval()
        timing.tracing(True)
        try:
            assert not fwd.graphed(_on_card())               # the recorder on
        finally:
            timing.tracing(False)
            timing.drain()
    assert not fwd.graphed(_on_card())                       # a gradient
    sparse = net.cfg.replace(model=dataclasses.replace(net.cfg.model, substrate="sparse"))
    with torch.no_grad():
        assert not dispatch.AdaptiveForward(SimpleNamespace(cfg=sparse, training=False)) \
            .graphed(_on_card())


def test_eager_calls_are_counted(net):
    import chip_smoke as cs

    inp = cs.make_scans(net.cfg, 1, "cpu")[0][1]
    fwd = dispatch.AdaptiveForward(net)
    kernels.reset_launches()
    timing.drain()
    with torch.no_grad():
        fwd(inp)
        timing.tracing(True)
        try:
            fwd(inp)
        finally:
            timing.tracing(False)
    fwd(inp)
    assert dispatch.GRAPHS == {"captures": 0, "replays": 0, "eager": 3}
    assert timing.drain()["counters"][0] == {"graphs.eager": 1}


def _bn(net):
    return net.enc_s1.res0.bn1


@pytest.mark.parametrize("change", ["in_place", "load_state_dict", "assign", "buffer"])
def test_changed_parameters_drop_the_graphs(net, fwd, change):
    inp, box = _input(), (64, 64, 16)
    fwd.graph_for(inp, box)
    fwd.graph_for(inp, box)
    assert len(fwd.captured) == 1
    other = build_net(tiny_config(), device="cpu")
    other.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        if change == "in_place":
            net.dec_s1.head_bias.add_(1.0)
        elif change == "load_state_dict":
            net.load_state_dict(other.state_dict())
        elif change == "assign":
            net.load_state_dict(other.state_dict(), assign=True)
        else:
            name = next(n for n, _ in _bn(net).named_buffers())
            getattr(_bn(net), name).mul_(2.0)
    fwd.graph_for(inp, box)
    fwd.graph_for(inp, box)
    assert len(fwd.captured) == 2


def test_an_unrelated_module_keeps_the_graphs(net, fwd):
    inp, box = _input(), (64, 64, 16)
    fwd.graph_for(inp, box)
    other = build_net(tiny_config(), device="cpu")
    other.register_buffer("extra", torch.zeros(2))
    fwd.graph_for(inp, box)
    assert len(fwd.captured) == 1


def test_replay_counts_in_graphs_alone(net, monkeypatch):
    """A replay (stand-in graph and stream here) copies the call's input
    into the key's static inputs, hands back clones of the captured
    output, and counts in ``GRAPHS["replays"]`` alone: it runs no wrapper,
    so ``kernels.LAUNCHES`` does not move."""
    fwd = dispatch.AdaptiveForward(net)
    replays = []
    out = {"logits": torch.arange(6.0)}

    def capture(key, inp, box):
        graph = SimpleNamespace(replay=lambda: replays.append(key))
        return dispatch._Captured(graph, tuple(torch.zeros_like(t) for t in inp), out)

    monkeypatch.setattr(fwd, "_capture", capture)
    monkeypatch.setattr(fwd, "graphed", lambda inp: True)
    monkeypatch.setattr(dispatch.torch.cuda, "current_stream", lambda device=None: "stream")
    kernels.reset_launches()
    kernels.LAUNCHES["masked_conv3"] = 7
    inp = _input()._replace(global_max=torch.tensor([5, 6, 7], dtype=torch.int32))
    box = (64, 64, 16)
    got = [fwd(inp, box) for _ in range(2)]
    cap = fwd.graph_for(inp, box)
    assert torch.equal(cap.inputs[4], inp.global_max)
    assert got[0]["logits"] is not out["logits"] and torch.equal(got[1]["logits"], out["logits"])
    assert len(replays) == 2
    assert dispatch.GRAPHS == {"captures": 1, "replays": 2, "eager": 0}
    assert kernels.LAUNCHES["masked_conv3"] == 7 and sum(kernels.LAUNCHES.values()) == 7


def test_reset_launches_zeroes_graphs():
    dispatch.GRAPHS.update(captures=2, replays=5, eager=1)
    kernels.LAUNCHES["masked_conv3"] = 3
    kernels.reset_launches()
    assert set(dispatch.GRAPHS.values()) == {0} and kernels.LAUNCHES["masked_conv3"] == 0


def test_map_rebuilds_a_model_output():
    t = [torch.full((2,), float(i)) for i in range(8)]
    grid = SparseGrid(t[0], t[1], t[2], 4)
    out = ModelOutput(sem_grids={4: grid}, sem_logits={1: t[3]}, panop_grids={},
                      sem_logits_pruned=t[4],
                      predictor=PredictorOutput(t[5], t[6], [(t[7], t[3])]))
    got = dispatch._map(out, lambda v: v + 10, torch.Tensor)
    assert type(got) is ModelOutput and type(got.predictor) is PredictorOutput
    g = got.sem_grids[4]
    assert type(g) is SparseGrid and g.stride == 4 and torch.equal(g.feats, t[1] + 10)
    assert isinstance(got.predictor.aux, list) and isinstance(got.predictor.aux[0], tuple)
    assert torch.equal(got.predictor.aux[0][1], t[3] + 10)
    assert torch.equal(got.sem_logits_pruned, t[4] + 10)
