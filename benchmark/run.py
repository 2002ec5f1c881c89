"""The benchmark of the PyTorch/CUDA port of PaSCo (``pasco_torch``).

    python3 benchmark/run.py --workload mimo3_scan --seed 1234 --seconds 45 --trace 0

Runs one cell of ``BENCHMARK.json`` on the card of this machine and prints,
as its last line, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number that decided ``correct`` beside its limit.  The
same numbers are the last lines on standard error.

Everything is found by name: the cell in ``BENCHMARK.json``; its
configuration in the file the manifest names; its traffic in
``benchmark/traffic/<traffic>.json``, run by the loop of its ``kind``
(``benchmark/kinds/<kind>.py``); each per-layer metric by its reader
``benchmark/metrics/<metric>.py``.  A new cell, configuration, traffic mix
or metric is a new file and a new entry.

It exits with another code than 0 and prints no result where the machine
has no CUDA device or fewer than the cell asks for, and where, once the
window has closed, a module of JAX (``jax``, ``jaxlib``, ``flax``) or the
JAX package ``pasco_tpu`` is loaded.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
BANNED = ("jax", "jaxlib", "flax", "pasco_tpu")
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda"}


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(man: dict, workload: str):
    """(the workload's entry, its configuration's entry)."""
    work = {w["name"]: w for w in man["workloads"]}
    if workload not in work:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = work[workload]
    return w, {c["name"]: c for c in man["configs"]}[w["config"]]


def traffic_file(name: str) -> dict:
    return load_json(os.path.join(BENCH, "traffic", f"{name}.json"))


def cell_metrics(man: dict, workload: str):
    """(the cell's end-to-end metrics, its per-layer metrics): an
    end-to-end metric belongs to the cells its ``workloads`` lists, or to
    every cell without; a per-layer metric names its cells in
    ``workloads``, always."""
    e2e = [m for m in man["end_to_end"] if workload in m.get("workloads", [workload])]
    return e2e, [m for m in man["per_layer"] if workload in m["workloads"]]


def read_metric(name: str, trace: dict):
    """The value of per-layer metric ``name`` from its reader, or None
    where the reader finds nothing to read."""
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(trace)


def banned_modules():
    return sorted({k.split(".")[0] for k in sys.modules} & set(BANNED))


def close_window() -> None:
    """Called by a loop once its window has closed."""
    found = banned_modules()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {', '.join(found)}",
              file=sys.stderr, flush=True)
        sys.exit(3)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def run_cell(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
             device, e2e, per_layer) -> dict:
    """One run of a cell: the result object that :func:`main` prints."""
    import torch

    kind = importlib.import_module(f"benchmark.kinds.{traffic['kind']}")
    ctx = dict(config=config, traffic=traffic, seed=seed, seconds=seconds, trace=trace,
               device=torch.device(device), t0=T0, close_window=close_window)
    res = kind.run(ctx)
    limits = config["limits"]
    checks = {k: {"value": res["readings"][k], "limit": v} for k, v in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and res["failed"] == 0
    dev = torch.device(device)
    out = {"correct": bool(correct), "attempted": res["attempted"], "failed": res["failed"]}
    metrics = {}
    if trace:
        for m in per_layer:
            v = read_metric(m["name"], res["trace"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": res["end_to_end"][m["name"]], "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": res["memory_peak_bytes"],
    }
    if trace:
        fields, breakdown = kind.trace_fields(res["trace"])
        out["device"].update(fields)
        out["breakdown"] = breakdown
    out["info"] = dict(res["info"], readings=res["readings"])
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    for var, sub in CACHES.items():
        path = os.path.join(ROOT, "build", "bench_cache", sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path

    man = manifest()
    work, cfg_entry = cell(man, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {work['chips']} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    config = load_json(os.path.join(ROOT, cfg_entry["file"]))
    e2e, per = cell_metrics(man, args.workload)
    out = run_cell(config, traffic_file(work["traffic"]), args.seed, args.seconds,
                   bool(args.trace), "cuda:0", e2e, per)
    close_window()
    print(f"info: {json.dumps(out['info'])}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
