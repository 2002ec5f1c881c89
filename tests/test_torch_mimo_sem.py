"""The sem-only pretraining step at ``n_infers = 3``: one port step with
``is_predict_panop=False`` against the JAX ``train_step`` with the same flag
on the CPU in f32 (one JAX compile), with the tolerances of
``tests/test_torch_train.py``.  Only the sem-completion losses count; the
refiners and the transformer get no gradient and keep their running
statistics.  Then the trainer's mapping of the reference's
``pretrain_sem_epochs``.

Inputs, bounds and the gradient rule: those of
``tests/test_torch_mimo_train.py`` (the same five scenes, for the reason
given there).
"""

import numpy as np
import pytest
from test_torch_mimo_train import SEEDS
from test_torch_train import (
    check_gradients_across_seeds, check_loss_terms, check_running_stats_and_update,
    check_step_coords, run_both_steps, step_config, synthetic_batch)

from pasco_tpu.core.config import OptimConfig, tiny_config


@pytest.fixture(scope="module")
def runs():
    cfg = step_config(n_infers=3)
    return cfg, [run_both_steps(cfg, synthetic_batch(cfg, seed=s, n_points=500),
                                is_predict_panop=False) for s in SEEDS]


def test_sem_step_extraction_coords_identical(runs):
    for ref, got in runs[1]:
        check_step_coords(ref, got, "sem_grids")
        assert got["out"].panop_grids == {} and got["out"].predictor is None


def test_sem_step_loss_terms(runs):
    for ref, got in runs[1]:
        check_loss_terms(ref, got, 4)     # compl_ce, compl_lovasz, total, norm


def test_sem_step_gradients(runs):
    check_gradients_across_seeds(runs[1])
    for _, got in runs[1]:
        untouched = [k for k, g in got["grads"].items() if g is None]
        assert untouched and all(k.startswith(("voxel_feats_", "transformer."))
                                 for k in untouched)


def test_sem_step_running_stats_and_update(runs):
    cfg, pairs = runs
    for ref, got in pairs:
        check_running_stats_and_update(cfg, ref, got, only_where_grads_agree=True)


def test_trainer_pretrains_sem_first():
    """``loop.train`` at ``tiny_config(n_infers=3)``: by default the first
    epoch (one pass over the scenes) is sem-only, as the reference's
    ``pretrain_sem_epochs = 1`` at n_infers=3; an explicit step count
    overrides it.  Every step has a finite loss and a non-zero gradient."""
    from pasco_torch.training.loop import train

    cfg = tiny_config(n_infers=3).replace(optim=OptimConfig(lr=1e-3, warmup_steps=0))
    col = synthetic_batch(cfg, seed=3)
    freqs = {s: np.ones(cfg.model.n_classes) for s in (1, 2, 4)}
    state = train(cfg, [col] * 2, device="cpu", class_frequencies=freqs, log=None)
    assert [h["is_predict_panop"] for h in state.history] == [False, False]
    state = train(cfg, [col] * 2, class_frequencies=freqs, log=None, state=state,
                  pretrain_sem_steps=3)
    assert [h["is_predict_panop"] for h in state.history] == [False, False, False, True]
    assert all(np.isfinite(h["total_loss"]) and h["grad_norm"] > 0 for h in state.history)
