"""The plain float32 reference against the port at ``tiny_config`` on the
CPU (the port runs its plain PyTorch versions of the kernels there, in
bfloat16), and the float8 control against the reference."""

import pytest
import torch

from benchmark import program, scans, weights
from benchmark.reference.compare import compare, compare_scan, follow
from benchmark.reference.control import round_fp8
from benchmark.reference.model import Reference
from conftest import TINY_LIMITS


def port_and_reference(cfg, traffic, seed):
    """(the port's readings, the control's readings) of every scan of a
    tiny pool."""
    from benchmark.kinds.eval_scans import HostBuffers, one_scan

    pool = scans.make_pool(traffic, cfg, seed, 1)
    w = weights.make_weights(program.parameter_shapes(cfg), seed, "cpu")
    fwd = program.build_forward(cfg, w, "cpu")
    bufs = HostBuffers()
    rows = []
    with torch.no_grad():
        for j, scan in enumerate(pool):
            host = one_scan(fwd, program.model_input(scan, "cpu"),
                            program.pick_box(fwd, scan), bufs, j, judged=True)[0]
            got = compare_scan(host, Reference(cfg, w), scan, cfg["model"]["n_infers"], "cpu")
            low = Reference(cfg, w, round_fp8).forward(scan, "cpu")
            rows.append((got, compare(low, follow(Reference(cfg, w), scan, low, "cpu"))))
    return rows


@pytest.mark.parametrize("seed", [5, 12, 2 ** 33 + 1])
def test_reference_holds_the_port_and_the_control_fails(cell, seed):
    cfg, traffic = cell
    for got, bad in port_and_reference(cfg, traffic, seed):
        assert all(got[k] <= v for k, v in TINY_LIMITS.items()), got
        assert got["sem_rel"] > 0            # the logits round to bfloat16: not bit-equal
        assert any(bad[k] > v for k, v in TINY_LIMITS.items()), bad


def test_reference_works_out_the_box_and_the_masks():
    from benchmark.reference.model import pick_box

    cfg = {"scene": {"box_candidates": [[64, 64, 16], [48, 48, 16]], "box_extent": [64, 64, 16]}}
    assert pick_box(cfg, [0, 0, 0], [47, 47, 15]) == (48, 48, 16)
    assert pick_box(cfg, [0, 0, 0], [48, 47, 15]) == (64, 64, 16)
    assert pick_box(cfg, [0, 0, 0], [99, 0, 0]) == (64, 64, 16)   # none covers: the largest
    m = torch.zeros(4, 2, 4, dtype=torch.bool)
    m[3, 1, 0] = True
    pooled = Reference.pool_mask(m)
    assert pooled.shape == (2, 1, 2) and pooled.sum() == 1 and pooled[1, 0, 0]
    assert Reference.up_mask(pooled).sum() == 8


def test_weights_come_from_the_seed_and_empty_reads_nothing():
    shapes = {"dec_s1.head_kernel": (3, 64, 20), "enc_s1.res0.conv1.kernel": (27, 16, 16),
              "enc_s1.res0.conv1.bias": (16,), "enc_s1.res0.bn1.scale": (16,)}
    a = weights.make_weights(shapes, 2 ** 40 + 3, "cpu")
    b = weights.make_weights(shapes, 2 ** 40 + 3, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in shapes)
    assert a["enc_s1.res0.conv1.bias"].eq(0).all() and a["enc_s1.res0.bn1.scale"].eq(1).all()
    assert a["enc_s1.res0.conv1.kernel"].abs().max() <= (1 / (27 * 16)) ** 0.5
    head = a["dec_s1.head_kernel"]
    assert head[..., 0].eq(0).all() and head[..., 1:].ne(0).all()
