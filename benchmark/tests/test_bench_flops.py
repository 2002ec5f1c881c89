"""The work counts of benchmark/flops.py and the percentile of the scan cells."""

import torch

from benchmark import flops
from benchmark.kinds.eval_scans import p95
from benchmark.reference.model import Reference


def test_macs_of_each_kind():
    assert flops.macs(dict(kind="mm", rows=10, k=3, n=4)) == 120
    assert flops.macs(dict(kind="conv3", cells=5, pairs=17, ci=2, co=3, skip=0,
                           mask_cells=64)) == 17 * 6
    assert flops.macs(dict(kind="dense", cells=7, taps=27, ci=2, co=2)) == 7 * 27 * 4
    assert flops.macs(dict(kind="attn", q=3, n=11, d=8)) == 2 * 3 * 11 * 8
    assert flops.model_flops([dict(kind="mm", rows=1, k=1, n=1)] * 3) == 6


def _conv_record(mask):
    ref = Reference({"model": dict(n_infers=1, n_classes=2, f=2, res_blocks=1,
                                   heavy_decoder=False)}, {})
    x = torch.randn(*mask.shape, 2)
    ref.conv3(x, mask, torch.randn(27, 2, 3))
    return ref.calls[-1]


def test_conv3_counts_valid_neighbour_pairs():
    mask = torch.zeros(4, 4, 4, dtype=torch.bool)
    mask[1, 1, 1] = True
    assert _conv_record(mask)["pairs"] == 1          # the centre tap only
    mask[1, 1, 2] = True                              # a neighbour along y
    rec = _conv_record(mask)
    assert (rec["cells"], rec["pairs"], rec["mask_cells"]) == (2, 4, 64)
    mask[:] = True                                    # every cell: the taps inside the box
    per_axis = 3 * 4 - 2                              # sum over 4 cells of 2, 3, 3, 2
    assert _conv_record(mask)["pairs"] == per_axis ** 3


def test_conv3_least_time_is_the_larger_bound():
    call = dict(kind="conv3", cells=1000, pairs=27000, ci=64, co=64, skip=1, mask_cells=8000)
    ops_s = 2 * 27000 * 64 * 64 / flops.PEAK_BF16
    nbytes = 1000 * 64 * 2 + 2 * 1000 * 64 * 2 + 27 * 64 * 64 * 2 + 4 * (64 + 128) + 8000
    assert flops.conv3_bytes(call) == nbytes
    assert flops.conv3_least_s(call) == max(ops_s, nbytes / flops.HBM_BYTES_S)


def test_p95_is_over_all_samples():
    assert p95(list(range(1, 101))) == 95.05
    samples = [10.0] * 95 + [1000.0] * 5           # the tail of all, not of a subsample
    assert 10.0 < p95(samples) < 1000.0
    assert p95([5.0]) == 5.0
