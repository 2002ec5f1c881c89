"""Training on the sparse substrate: the port against ``pasco_tpu`` on the
CPU in f32 at ``tests/test_torch_sparse_net.py:sparse_config`` (every cap
at its stage's row count, so that no cap binds and the Gumbel noise of the
training-mode caps, which the two packages draw differently, only
reorders the kept rows; rows are compared keyed by coordinate).

* One ``train_step`` (n_infers 1) against the JAX ``train_step`` body on
  ``PaSCoNet`` (``tests/test_torch_train.py:run_both_steps``, one JAX
  compile) on three scenes (seeds 0-2): on each, identical kept
  coordinate sets at every scale of ``sem_grids`` and ``panop_grids``,
  every loss term within ``rtol=1e-3, atol=1e-5``, the running statistics
  and the update within ``tests/test_torch_train.py``'s bounds; the
  gradients under the rule of the MIMO step tests
  (``check_gradients_across_seeds``: each parameter within the S=1 bounds
  on at least one seed, within ``1e-1`` in norm on all).  The decoder's
  rows come in score order, and the two packages' Gumbel draws order
  them differently, so the attention sums over the voxels in another
  order; a gradient near a ReLU kink then flips on some seeds (seed 0
  moves ``decoder.block_s2.res0.conv1.kernel`` by 0.8% in norm, 4.9% of
  its largest element).

The dropouts, the trainer and the evaluation path on the sparse net are in
``tests/test_torch_sparse_dropout.py``.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch
from test_torch_sparse_net import keyed, sparse_config
from test_torch_train import (
    check_gradients_across_seeds, check_loss_terms, check_running_stats_and_update,
    run_both_steps, synthetic_batch)

from pasco_tpu.core.config import OptimConfig

torch.set_num_threads(1)

SEEDS = range(3)
# zero in exact arithmetic: a bias feeding a training-mode BatchNorm, the
# attention key biases
SPARSE_ZERO = re.compile(r"(res\d+\.conv1\.bias|SparseDownConv_0\.bias|\.up\.bias"
                         r"|cylinder_feat\.(fc[123]|bn_in)\.bias|k_proj\.bias)$")


def step_config(n_infers=1):
    """:func:`sparse_config` with the reference's ``remat=False`` and
    ``lr=1e-3`` without warmup (``tests/test_torch_train.py:step_config``)."""
    cfg = sparse_config(n_infers)
    return cfg.replace(model=dataclasses.replace(cfg.model, remat=False),
                       optim=OptimConfig(lr=1e-3, warmup_steps=0))


@pytest.fixture(scope="module")
def runs():
    cfg = step_config()
    return cfg, [run_both_steps(cfg, synthetic_batch(cfg, seed=s)) for s in SEEDS]


@pytest.mark.parametrize("which", ["sem_grids", "panop_grids"])
def test_step_kept_coords_identical(runs, which):
    for ref, got in runs[1]:
        for scale in (1, 2, 4):
            jg, tg = getattr(ref["out"], which)[scale], getattr(got["out"], which)[scale]
            jc, _ = keyed(np.asarray(jg.coords).reshape(-1, 4), np.asarray(jg.mask).reshape(-1))
            tc, _ = keyed(tg.coords.reshape(-1, 4).numpy(), tg.mask.reshape(-1).numpy())
            np.testing.assert_array_equal(tc, jc)
            assert len(tc) > 0


def test_step_loss_terms(runs):
    for ref, got in runs[1]:
        check_loss_terms(ref, got, 2 + 5 * 4 + 2)   # compl, 5 terms x 4 levels, total, norm


def test_step_gradients(runs):
    check_gradients_across_seeds(runs[1], SPARSE_ZERO)


def test_step_running_stats_and_update(runs):
    cfg, pairs = runs
    for ref, got in pairs:
        check_running_stats_and_update(cfg, ref, got, only_where_grads_agree=True)
