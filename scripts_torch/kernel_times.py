"""The hand-written kernels of one checkout, checked and timed at
``chip_smoke.py``'s main-path shapes, on one GPU.

    python scripts_torch/kernel_times.py [--root DIR] [--out FILE]

Runs ``chip_smoke.kernel_phases`` of this checkout (the conv at s1-s8,
the down step, the up-preamble and the extraction, each against its plain
version, with its time, the plain version's, one library call's and its
bound; the extraction also with its device time from the profiler),
``chip_smoke.column_conv_phase`` (row 7, at every occupied column and at
half of them) and ``chip_smoke.featurizer_phase`` (row 8 on the scan's
points, through a seeded net's point MLP) on the first synthetic scan, with
the ``pasco_torch`` of ``--root`` (default: this checkout).  The checks
that hold only for this checkout's kernels (row 7's TF32 guards, one
launch per extraction) run only without ``--root``.  The cases, the
checks and the yardstick (``chip_smoke.time_ms``) are this checkout's
either way, so two commits compare under one yardstick when ``--root`` is
a ``git archive`` of the other one unpacked under ``build/``; run them in
one call, alternating.
Prints the card, the phases' lines and one JSON line (also written to
``--out``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose pasco_torch is timed")
    ap.add_argument("--out", default=str(ROOT / "build" / "kernel_times.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times.py: no CUDA device")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from pasco_torch import kernels
    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.models.unet import build_net

    if not Path(kernels.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"kernel_times.py: pasco_torch from {kernels.__file__}, not {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.lib()
    cfg = PaSCoConfig()
    inp = cs.make_scans(cfg, 1, torch.device("cuda", 0))[0][1]
    dev = torch.device("cuda", 0)
    rows = cs.kernel_phases(cfg, inp, torch.Generator().manual_seed(0), own=root == ROOT)
    rows.append(cs.column_conv_phase(cs.scan_masks(cfg, inp)[1], dev, guards=root == ROOT))
    net = build_net(cfg, dev)
    net.reset_parameters(torch.Generator().manual_seed(0))
    rows.append(cs.featurizer_phase(cfg, inp, net))
    res = dict(card=card, root=str(root), kernels=rows)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
