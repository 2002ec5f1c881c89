"""The program's own spans (``pasco.*``, from ``pasco_torch/utils/timing.py``
when its tracing is on) in a profile of the traced window leave what
``benchmark/devtrace.py`` reads unchanged: on a stub profile of handmade
events, adding the spans on the host and their annotations on the
device's timeline moves neither ``busy_s``, ``kernel_s``,
``device_ops`` nor ``window_s``, and the gaps keep the harness's names."""

from types import SimpleNamespace

from torch.autograd import DeviceType

from benchmark import devtrace


def _event(start, end, name, device_type, annotation=False):
    return SimpleNamespace(name=name, device_type=device_type, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


class StubProfile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return list(self._events)


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
HARNESS = [
    _event(0, 1000, "bench.window", CPU),
    _event(10, 400, "bench.forward", CPU),
    _event(400, 600, "bench.copy_out", CPU),
    _event(600, 900, "bench.forward", CPU),
    _event(10, 400, "bench.forward", CUDA, annotation=True),
    _event(20, 150, "masked_conv3_kernel<64>", CUDA),
    _event(100, 300, "implicit_convolveNd_sgemm", CUDA),
    _event(350, 500, "Memcpy DtoH", CUDA),
    _event(650, 700, "masked_conv3_kernel<64>", CUDA),
]
PROGRAM = [
    _event(12, 390, "pasco.dispatch", CPU),
    _event(15, 120, "pasco.encoder", CPU),
    _event(16, 30, "pasco.kernel.masked_conv3", CPU),
    _event(120, 390, "pasco.bottleneck", CPU),
    _event(610, 890, "pasco.dispatch", CPU),
    _event(20, 390, "pasco.dispatch", CUDA, annotation=True),
    _event(20, 150, "pasco.encoder", CUDA, annotation=True),
    _event(150, 390, "pasco.bottleneck", CUDA, annotation=True),
    _event(650, 880, "pasco.dispatch", CUDA, annotation=True),
]


def test_program_spans_leave_the_reduction_unchanged():
    before = devtrace.reduce(StubProfile(HARNESS))
    after = devtrace.reduce(StubProfile(HARNESS + PROGRAM))
    assert before["busy_s"] == after["busy_s"] == 480 / 1e6
    assert before["window_s"] == after["window_s"] == 1000 / 1e6
    assert before["kernel_s"] == after["kernel_s"]
    assert before["device_ops"] == after["device_ops"]
    assert before["idle_gaps"] == after["idle_gaps"]
    assert {n for n, _ in after["idle_gaps"]} <= {
        "bench.forward", "bench.copy_out", "host, outside the harness's spans"}
