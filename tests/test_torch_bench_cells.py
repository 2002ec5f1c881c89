"""The benchmark's kind ``eval_scans_sparse`` on the CPU at
``tiny_config`` size, through the harness (``benchmark/run.py:run_cell``):
correct where the port is sound, not correct where an answer is altered.
The harness's check for JAX modules after the window is off here: this
suite's conftest loads JAX."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402
from benchmark.kinds import eval_scans_sparse  # noqa: E402
from test_torch_sparse_bench import tiny  # noqa: E402

torch.set_num_threads(1)

# ---- the harness ----------------------------------------------------------------


@pytest.fixture
def run_tiny(monkeypatch):
    monkeypatch.setattr(run, "close_window", lambda: None)

    def run_cell(workload, cfg, traffic, seconds=1.0):
        e2e, per = run.cell_metrics(run.manifest(), workload)
        return run.run_cell(cfg, traffic, 2 ** 31 + 11, seconds, False, "cpu", e2e, per)

    return run_cell


def test_sparse_cell_runs_and_is_correct(run_tiny):
    cfg, traffic = tiny()
    out = run_tiny("sparse_single_scan", cfg, traffic)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"scans_per_s", "scan_p95_ms", "peak_mem_gb", "setup_s"}
    fill = out["info"]["kept_of_cap"]
    assert fill["sem1.mask"][0] == fill["sem1.mask"][1]      # random init: the cap binds


def test_sparse_cell_with_an_altered_answer_is_not_correct(monkeypatch, run_tiny):
    real = eval_scans_sparse.SPARSE.host_outputs

    def altered(out):
        h = {k: v.clone() for k, v in real(out).items()}
        h["sem1.logits"][0, 0, 1] += 0.5 * h["sem1.logits"].abs().max()
        return h

    monkeypatch.setattr(eval_scans_sparse.SPARSE, "host_outputs", altered)
    cfg, traffic = tiny()
    out = run_tiny("sparse_single_scan", cfg, traffic)
    assert not out["correct"], out["checks"]
