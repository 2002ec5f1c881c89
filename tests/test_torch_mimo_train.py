"""One MIMO train step (``n_infers = 3``) of the port against the JAX
``train_step`` on the CPU in f32 (one JAX compile), on five scenes (seeds
0-4), each holding a distinct synthetic scan of 500 points per subnet (the
training split's draw; about the S=1 test's cell count in all) with its
panoptic target slots capped at the query count.  On every seed, as in
``tests/test_torch_train.py``: identical extraction coords at every scale
of ``sem_grids`` and of every subnet's ``panop_grids``, every loss term,
the running statistics and the update.

The gradients follow a rule of their own.  The step's gradient is
discontinuous at every ReLU kink (and wherever a sort or a max changes its
order), and the two implementations' f32 forwards differ by up to ~1e-5
(summation order), so on most scenes some element falls on the other side
of a discontinuity in one of them (one was traced to a 6.2e-7
pre-activation in ``dec_s1.res2``).  Through the training-mode
BatchNorms that moves every gradient upstream of it by a few percent.
Measured on these five seeds: 0-207 of 343 parameters miss the
``tests/test_torch_train.py`` bounds per seed, by up to 5.75% in norm and
16x the per-element bound; the port against itself, with its weights
moved by 1e-7-1e-6 relative noise, moves the same parameters by as much
(up to 5.46% in norm, 16x per element).  So every parameter must meet
those bounds on at least one seed (a porting fault misses them on every
seed), and stay within 1e-1 of ``|g_ref|`` in norm on every seed; the
update is compared where the two gradients agree per element.
"""

import pytest
from test_torch_train import (
    check_gradients_across_seeds, check_loss_terms, check_running_stats_and_update,
    check_step_coords, run_both_steps, step_config, synthetic_batch)

SEEDS = range(5)


@pytest.fixture(scope="module")
def runs():
    cfg = step_config(n_infers=3)
    return cfg, [run_both_steps(cfg, synthetic_batch(cfg, seed=s, n_points=500))
                 for s in SEEDS]


@pytest.mark.parametrize("which", ["sem_grids", "panop_grids"])
def test_mimo_step_extraction_coords_identical(runs, which):
    for ref, got in runs[1]:
        check_step_coords(ref, got, which)
        if which == "panop_grids":
            assert got["out"].panop_grids[1].mask.shape[0] == 3


def test_mimo_step_loss_terms(runs):
    for ref, got in runs[1]:
        check_loss_terms(ref, got, 2 + 5 * 4 + 2)   # averaged over the 3 subnets


def test_mimo_step_gradients(runs):
    check_gradients_across_seeds(runs[1])


def test_mimo_step_running_stats_and_update(runs):
    cfg, pairs = runs
    for ref, got in pairs:
        check_running_stats_and_update(cfg, ref, got, only_where_grads_agree=True)
