"""The port's data-parallel train step with SyncBN
(``build_net(cfg, process_group=group)``) against the reference's
``dp_train_step`` with cross-replica BatchNorm (``axis_name="data"``) on
the CPU, in f32: the comparison of ``tests/test_torch_parallel_jax.py``
(two ranks against a 2-device mesh, two distinct scenes, five seeds, the
bounds of ``tests/test_torch_mimo_train.py``).

With SyncBN the statistics of every BatchNorm are sums over both ranks, so
each rank's loss depends on the other rank's activations, and the
gradient of the statistics must carry both ranks' losses (``psum``
transposes to ``psum``).  ``test_syncbn_statistics_path`` shows that the
comparison sees that path: the same step with a reduction whose backward
passes only the rank's own cotangent (``tests/torch_dp_ranks.py:
cut_all_reduce_sum``, what a plain ``dist.all_reduce`` gives) moves some
parameter's gradient by more than the 1e-1 in norm that every seed must
meet.
"""

import pytest
from test_torch_parallel_jax import check_coords, port_dp_runs, run_dp_both
from test_torch_train import (
    check_gradients_across_seeds, check_loss_terms, check_running_stats_and_update)


@pytest.fixture(scope="module")
def dp_runs():
    return run_dp_both(sync_bn=True)


def test_syncbn_coords_per_rank(dp_runs):
    for ref, got in dp_runs[1]:
        check_coords(ref, got)


def test_syncbn_loss_terms(dp_runs):
    for ref, got in dp_runs[1]:
        check_loss_terms(ref, got, 2 + 5 * 4 + 2)


def test_syncbn_gradients(dp_runs):
    check_gradients_across_seeds(dp_runs[1])


def test_syncbn_running_stats_and_update(dp_runs):
    cfg, pairs, _ = dp_runs
    for ref, got in pairs:
        check_running_stats_and_update(cfg, ref, got, only_where_grads_agree=True)


def test_syncbn_statistics_path(dp_runs):
    cfg, pairs, (sets, *rest) = dp_runs
    ref = pairs[0][0]
    cut = port_dp_runs(cfg, (sets[:1], *rest), sync_bn=True, cut_bn_grad=True)[0]
    worst = max(((cut["grads"][k] - g).norm() / g.norm()).item()
                for k, g in ref["grads"].items() if g.norm() > 0)
    assert worst > 1e-1, worst
