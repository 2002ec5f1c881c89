"""The readings that the limits of ``correct`` are set from, on the card,
at a cell's own size: the program's numbers on many seeds and the
control's on a few, in one process.

    python3 benchmark/calibrate.py --workload mimo3_scan --seeds 1-12 --control-seeds 1-3 \
        [--out build/calibrate_mimo3_scan.json]

For each seed it makes the cell's pool of scans and weights, runs every
scan of the pool once through the program's timed path (the same call and
host copy as the window), then holds it against the plain float32
reference; on the control seeds it also holds the control (the reference
in float8, :mod:`benchmark.reference.control`) against the reference.  It
prints one JSON line per seed and kind, then the largest program reading
and the smallest control reading of every number, and writes all of it to
``--out``.  Each program line also gives the scan's model FLOPs
(``benchmark/flops.py``) and how full each extraction is, so that work
that follows the seed shows.  The benchmark's runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seed_list(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def readings(config, traffic, seed, control: bool, dev):
    """(program readings per scan, control readings per scan or [])."""
    import torch

    from benchmark import program, scans, weights
    from benchmark.flops import model_flops
    from benchmark.kinds.eval_scans import HostBuffers, kept_of_cap, one_scan
    from benchmark.reference.compare import compare, compare_scan, follow
    from benchmark.reference.control import round_fp8
    from benchmark.reference.model import Reference

    pool = scans.make_pool(traffic, config, seed, traffic["workers"])
    shapes = program.parameter_shapes(config)
    fwd = program.build_forward(config, weights.make_weights(shapes, seed, dev), dev)
    bufs = HostBuffers()
    hosts = [one_scan(fwd, program.model_input(s, dev), program.pick_box(fwd, s), bufs, j,
                      judged=True)[0] for j, s in enumerate(pool)]
    del fwd
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = weights.make_weights(shapes, seed, dev)
    S = config["model"]["n_infers"]
    prog, ctl = [], []
    with torch.no_grad():
        for scan, host in zip(pool, hosts):
            ref = Reference(config, w)
            prog.append(compare_scan(host, ref, scan, S, dev))
            prog[-1].update(tflops=model_flops(ref.calls) / 1e12, kept_of_cap=kept_of_cap([host]))
            if control:
                low = Reference(config, w, round_fp8).forward(scan, dev)
                ctl.append(compare(low, follow(Reference(config, w), scan, low, dev)))
    return prog, ctl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="1-3")
    ap.add_argument("--out", default=None, help="JSON file of every reading "
                    "(default build/calibrate_<workload>.json)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import run
    from benchmark.reference.compare import NUMBERS

    man = run.manifest()
    work, entry = run.cell(man, args.workload)
    config = run.load_json(os.path.join(ROOT, entry["file"]))
    traffic = run.traffic_file(work["traffic"])
    print(f"card: {run.card_line()}", flush=True)
    ctl_seeds = set(seed_list(args.control_seeds))
    seeds = sorted(set(seed_list(args.seeds)) | ctl_seeds)
    rows = []
    for seed in seeds:
        prog, ctl = readings(config, traffic, seed, seed in ctl_seeds, "cuda:0")
        for kind, rs in (("program", prog), ("control", ctl)):
            for k, r in enumerate(rs):
                rows.append(dict(kind=kind, seed=seed, scan=k, **r))
                print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for k in NUMBERS:
        p = [r[k] for r in rows if r["kind"] == "program"]
        c = [r[k] for r in rows if r["kind"] == "control"]
        summary[k] = dict(program_max=max(p), control_min=min(c) if c else None,
                          limit=config["limits"].get(k))
    print(json.dumps({"summary": summary}), flush=True)
    out = args.out or os.path.join(ROOT, "build", f"calibrate_{args.workload}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump({"rows": rows, "summary": summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
