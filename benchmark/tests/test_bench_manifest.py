"""BENCHMARK.json against the benchmark's contract: names, units, keys,
the files each entry names, and what every cell reports."""

import json
import os
import re

import pytest

from conftest import ROOT

MAN = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_paths():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert MAN["command"][1].startswith("benchmark/")
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    n_cells = 24    # later PRs may add cells up to 24 at this run length
    assert (2 + 14 * n_cells) * (MAN["run_seconds"] + 60) + n_cells * 180 + 1200 <= 43200
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names)), group
        for n in names:
            assert NAME.match(n), n
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_entry(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"].startswith("benchmark/configs/") and cfg["file"].endswith(".json")
    body = json.load(open(os.path.join(ROOT, cfg["file"])))
    assert body["model"]["compute_dtype"] == "bfloat16"
    assert cfg["reduced"] == []
    assert set(body["limits"]) and all(v > 0 for v in body["limits"].values())
    assert any(w["config"] == cfg["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("work", MAN["workloads"], ids=lambda w: w["name"])
def test_workload_entry_and_what_it_reports(work):
    assert set(work) == {"name", "config", "traffic", "chips", "why"}
    assert work["chips"] in (1, 4) and len(work["why"]) <= 200 and "\n" not in work["why"]
    assert NAME.match(work["traffic"])
    assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic", work["traffic"] + ".json"))

    def mine(m):
        return work["name"] in m.get("workloads", [work["name"]])

    e2e = {m["name"] for m in MAN["end_to_end"] if mine(m)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per = [m for m in MAN["per_layer"] if mine(m)]
    assert per and all(m["moves"] in e2e for m in per)


def test_metric_entries():
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in MAN["end_to_end"]} >= {"setup_s"}
    assert [m["bound"] for m in MAN["end_to_end"] if m["name"] == "setup_s"] == [0.25]
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in MAN["per_layer"]:
        assert set(m) == METRIC_KEYS | {"layer", "moves", "workloads"}   # the harness reads each
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_layers_are_named_alike():
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
