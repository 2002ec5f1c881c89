"""A whole run of a scan cell on the CPU at ``tiny_config`` size, past the
harness's look for a card: correct where the port is sound, and not
correct where the timed path alters an answer where it is produced."""

import pytest
import torch

from benchmark import program, run
from conftest import tiny_cell

E2E, PER = run.cell_metrics(run.manifest(), "mimo3_scan")


def run_tiny(cell, seconds=3.0):
    cfg, traffic = cell
    return run.run_cell(cfg, traffic, 2 ** 31 + 11, seconds, False, "cpu", E2E, PER)


def test_sound_run_is_correct_and_reports_its_metrics(cell):
    out = run_tiny(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in E2E}
    assert out["metrics"]["scans_per_s"]["value"] > 0
    assert out["metrics"]["scan_p95_ms"]["value"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(cell[0]["limits"])


def _alter_sem_logit(h):
    h["sem1.logits"][0, 0, 0] += 0.5 * h["sem1.logits"].abs().max()


def _scale_mask_logits(h):
    h["mask_logits"] *= 1.2


def _drop_kept_cells(h):
    m = h["sem1.mask"]
    m[: max(1, int(m.sum()) // 10)] = False


def _one_subnet_takes_anothers_masks(h):
    h["mask_logits"][-1] = h["mask_logits"][0]


def _one_subnet_takes_anothers_classes(h):
    h["query_logits"][-1] = h["query_logits"][0]


def _one_query_mask_negated(h):
    h["mask_logits"][-1][:, 0] *= -1


FAULTS = [(_alter_sem_logit, 1), (_drop_kept_cells, 1), (_scale_mask_logits, 1),
          (_one_subnet_takes_anothers_masks, 3), (_one_subnet_takes_anothers_classes, 3),
          (_one_query_mask_negated, 3)]


@pytest.mark.parametrize("fault,n_infers", FAULTS, ids=[f.__name__.strip("_") for f, _ in FAULTS])
def test_altered_answer_is_not_correct(monkeypatch, fault, n_infers):
    real = program.host_outputs

    def altered(out):
        h = {k: v.clone() for k, v in real(out).items()}
        fault(h)
        return h

    monkeypatch.setattr(program, "host_outputs", altered)
    out = run_tiny(tiny_cell(n_infers))
    assert not out["correct"], out["checks"]


def test_no_card_means_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "mimo3_scan", "--seed", "1", "--seconds", "1"])
    captured = capsys.readouterr()
    assert rc != 0 and captured.out == ""
