"""Forward throughput of the port's flagship (``PaSCoConfig()``, PaSCo-single
or, with ``BENCH_INFERS=3``, the MIMO ensemble) on one GPU: the single-scan
protocols of the reference package's ``bench.py``.

    python scripts_torch/bench.py                     # pipelined, n_infers 1
    BENCH_INFERS=3 python scripts_torch/bench.py      # the MIMO ensemble
    BENCH_PER_SCAN=1 python scripts_torch/bench.py    # per-scan latency
    BENCH_FIXED_BOX=1 python scripts_torch/bench.py   # every scan at 352x352x32
    BENCH_BATCH=4 python scripts_torch/bench.py       # 4 scans per forward
    python scripts_torch/bench.py --compile-only      # the card's build gate

The scans are ``bench.py``'s (``bench.py:277-301``): ``BENCH_SCANS``
(default 6) synthetic SemanticKITTI-sized scans (120000 points) drawn with
``RandomState(0)`` under the eval augmentation (up to 30 degrees of
rotation, 0.2 m of translation), ``n_infers`` views each, in the same
order.  Each runs through :class:`AdaptiveForward` at the smallest of the
config's candidate boxes that covers it (``BENCH_FIXED_BOX=1``: the
352x352x32 box), one network, seeded random init
(``BENCH_TRAINED_CKPT=<npz>`` loads the ``params/a/b`` keys of a
``scripts_tpu/make_bench_ckpt.py`` file instead, at n_infers 1).  Every
floating output is reduced to one sum on the card, so the whole output is
computed.

Protocols (:func:`measure`): by default pipelined throughput, every scan
enqueued back to back ``BENCH_ITERS`` (default 4, at least 2) times after
one warm-up per box and one untimed pass, one synchronise at the end; with
``BENCH_PER_SCAN=1`` the median over ``BENCH_ITERS`` of each scan's latency
to its sum on the host.  Earlier lines give the card's name and power
limit, each scan's box, device ms per scan (CUDA events between scans), the
host syncs of one forward and the peak device memory; the last line is
``bench.py``'s JSON (``inference_scans_per_sec[_n3]``, ``vs_baseline``
against the original PaSCo's 0.703 / 1.193 s per scan on a V100).

``BENCH_BATCH=B > 1`` is the reference's batched protocol
(``bench.py:197-237``, :func:`measure_batch`): ``B`` distinct unaugmented
scans (``_synthetic_model_input`` at seed 0 and seeds 100 ... 100 + B - 2,
:func:`batch_scans`) stacked into one input, one forward of all ``B`` per
call at the fixed 352x352x32 box of ``PaSCoConfig()`` at n_infers 1
(``BENCH_TRAINED_CKPT`` as above), the whole output reduced on the card;
the median over ``max(BENCH_ITERS, 6)`` synchronised calls, divided by
``B``.  Earlier lines give device ms per batch (CUDA events), the peak
device memory and the host syncs of one forward; the last line is the same
``inference_scans_per_sec`` line.  It refuses ``BENCH_INFERS != 1`` (the
reference's batched branch builds ``PaSCoConfig()`` at n_infers 1) and
``BENCH_BATCH_PALLAS=0`` (the reference's switch to a path without its
kernels; the port keeps the plain versions off the card).

``--compile-only`` builds the kernels and runs one forward per candidate
box at n_infers 1 and 3 (``BENCH_COMPILE_INFERS``), checks that each output
is finite, and prints ``compile_gate_programs``.  Needs a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BASELINE_SCAN_SEC = 0.703      # the original PaSCo-single on a V100 (its README:411)
BASELINE_SCAN_SEC_N3 = 1.193   # the original PaSCo (n_infers=3), its README:449


def bench_config(n_infers: int, fixed_box: bool = False):
    from pasco_torch.core.config import PaSCoConfig

    cfg = PaSCoConfig()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, n_infers=n_infers))
    if fixed_box:
        cfg = cfg.replace(scene=dataclasses.replace(cfg.scene, box_candidates=()))
    return cfg


def draw_scans(cfg, n_scans: int, device, seed: int = 0):
    """``bench.py``'s scans: (collated scene, model input, box) each."""
    from chip_smoke import make_scans
    from pasco_torch.inference.dispatch import candidate_boxes, pick_box

    cands = candidate_boxes(cfg)
    return [(col, inp, pick_box(cands, col.global_min, col.global_max))
            for col, inp in make_scans(cfg, n_scans, device, seed)]


def batch_scenes(cfg, batch: int):
    """The reference's batched scans (``bench.py:219-228``), collated on the
    host: ``B`` distinct scans as ``_synthetic_model_input`` draws them
    (``RandomState(seed)``, ``n_infers`` views without augmentation,
    ``__graft_entry__.py:38-55``) at seed 0 and seeds 100 ... 100 + B - 2."""
    from pasco_torch.data.semantic_kitti.collate import collate
    from pasco_torch.data.semantic_kitti.dataset import process_scene
    from pasco_torch.data.synthetic import make_scene

    cols = []
    for seed in [0] + [100 + k for k in range(batch - 1)]:
        rng = np.random.RandomState(seed)
        views = [process_scene(make_scene(
            rng, scene_size=cfg.scene.scene_size,
            n_points=min(cfg.capacity.num_points, 120000),
            point_feat_dim=cfg.model.in_channels - 6), None, rng)
            for _ in range(cfg.model.n_infers)]
        cols.append(collate(views, cfg))
    return cols


def batch_scans(cfg, batch: int, device):
    """:func:`batch_scenes` stacked into one input on ``device``
    (``bench.py:226-228``)."""
    from pasco_torch.models.unet import scene_to_model_input, stack_inputs

    return stack_inputs([scene_to_model_input(c, device) for c in batch_scenes(cfg, batch)])


@torch.no_grad()
def measure_batch(net, binp, iters: int = 4):
    """The reference's batched protocol on the stacked input ``binp``: two
    untimed calls, then ``max(iters, 6)`` calls, each a forward of every
    scan with its output reduced and read on the host; returns
    ``scans_per_sec`` (1 / the median host seconds of a call over B),
    ``samples_s`` and ``device_ms`` (the median ms between CUDA events
    around a call; ``None`` on the CPU)."""
    B = binp.point_feats.shape[0]
    cuda = binp.point_feats.is_cuda
    reduced(net(binp)).item()
    reduced(net(binp)).item()
    samples, dev_ms = [], []
    for _ in range(max(iters, 6)):
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        total = reduced(net(binp))
        if cuda:
            b.record()
        total.item()
        samples.append((time.perf_counter() - t0) / B)
        if cuda:
            dev_ms.append(a.elapsed_time(b))
    dt = sorted(samples)[len(samples) // 2]
    return dict(scans_per_sec=1.0 / dt, samples_s=samples,
                device_ms=statistics.median(dev_ms) if cuda else None)


def reduced(out) -> torch.Tensor:
    """The sum of every floating tensor of a ``ModelOutput``, in f32 on its
    device (``bench.py:_reduced``)."""
    leaves = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                leaves.append(x.float().sum())
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    walk(out)
    return torch.stack(leaves).sum()


def host_syncs(fn):
    """Where ``fn()`` made the host wait for the card: for each synchronising
    call (torch's sync debug mode warns once per call), the innermost
    ``file:line`` of this repository on the stack.  ``fn`` runs without
    autograd, as the timed forwards do: with it, the forward keeps its
    activations for a backward, and a peak read across the call counts
    them."""
    sites = []

    def show(message, *args, **kwargs):
        if "synchroniz" in str(message):
            ours = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(ROOT)]
            if ours and ours[-1].name == "host_syncs":
                return            # switching the debug mode back warns too
            sites.append(f"{os.path.relpath(ours[-1].filename, ROOT)}:{ours[-1].lineno}"
                         if ours else "outside the repository")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with torch.no_grad():
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites


@torch.no_grad()
def measure(fwd, inps, boxes, per_scan: bool = False, iters: int = 4):
    """One protocol over the scans ``inps`` at their ``boxes`` through
    ``fwd`` (an :class:`AdaptiveForward`).  Returns ``scans_per_sec`` (host
    clock), ``device_ms`` per scan (CUDA events; ``None`` on the CPU), the
    boxes, ``wall_s`` and the host seconds spent enqueueing
    (``enqueue_s``, pipelined only)."""
    cuda = inps[0].point_feats.is_cuda
    dev = inps[0].point_feats.device

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def event():
        if not cuda:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    for box in sorted(set(boxes)):                     # warm every box in use
        reduced(fwd(inps[boxes.index(box)], box)).item()
    res = {"boxes": [list(b) for b in boxes]}
    if not per_scan:
        reps = max(iters, 2)
        torch.stack([reduced(fwd(s, b)) for s, b in zip(inps, boxes)]).sum().item()
        sums, events = [], [event()]
        t0 = time.perf_counter()
        for _ in range(reps):
            for s, b in zip(inps, boxes):
                sums.append(reduced(fwd(s, b)))
                events.append(event())
        t_enqueue = time.perf_counter() - t0
        torch.stack(sums).sum().item()
        wall = time.perf_counter() - t0
        res.update(scans_per_sec=len(sums) / wall, wall_s=wall, enqueue_s=t_enqueue)
        if cuda:
            per = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
            n = len(inps)
            res["device_ms"] = [statistics.median(per[i::n]) for i in range(n)]
    else:
        lat, dev_ms = [], []
        for s, b in zip(inps, boxes):
            samples, dsamples = [], []
            for _ in range(iters):
                a = event()
                t0 = time.perf_counter()
                reduced(fwd(s, b)).item()
                samples.append(time.perf_counter() - t0)
                if cuda:
                    e = event()
                    e.synchronize()
                    dsamples.append(a.elapsed_time(e))
            lat.append(statistics.median(samples))
            dev_ms.append(statistics.median(dsamples) if cuda else None)
        res.update(scans_per_sec=1.0 / float(np.mean(lat)), wall_s=float(np.sum(lat)),
                   latency_s=lat)
        if cuda:
            res["device_ms"] = dev_ms
    sync()
    if not cuda:
        res["device_ms"] = None
    return res


def result_line(scans_per_sec: float, n_infers: int) -> str:
    """``bench.py``'s last line."""
    base = BASELINE_SCAN_SEC_N3 if n_infers == 3 else BASELINE_SCAN_SEC
    name = "inference_scans_per_sec" + ("" if n_infers == 1 else f"_n{n_infers}")
    return json.dumps({"metric": name, "value": round(scans_per_sec, 3), "unit": "scans/s",
                       "vs_baseline": round(scans_per_sec * base, 3)})


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def build_forward(cfg, dev, trained: str = ""):
    """One network on ``dev`` (seeded random init, or the npz ``trained``)
    behind an :class:`AdaptiveForward`."""
    from pasco_torch.convert import flax_to_torch
    from pasco_torch.inference.evaluate import adaptive_forward
    from pasco_torch.models.unet import build_net

    net = build_net(cfg, dev)
    net.reset_parameters(torch.Generator().manual_seed(0))
    if trained:
        data = np.load(trained)
        net.load_state_dict(flax_to_torch({k: data[k] for k in data.files}), strict=True)
    return adaptive_forward(cfg, net)


def _require_card():
    if not torch.cuda.is_available():
        raise SystemExit("scripts_torch/bench.py: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def compile_only():
    """The card's build gate: build every kernel, then one forward per
    candidate box at each n_infers, each output finite."""
    from pasco_torch import kernels

    dev = _require_card()
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    kernels.lib()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    n_done = 0
    for ni in (int(v) for v in os.environ.get("BENCH_COMPILE_INFERS", "1,3").split(",")):
        cfg = bench_config(ni)
        fwd = build_forward(cfg, dev)
        _, inp, _ = draw_scans(cfg, 1, dev)[0]
        for box in fwd.cands:
            t0 = time.perf_counter()
            with torch.no_grad():
                total = reduced(fwd(inp, box)).item()
            if not np.isfinite(total):
                raise SystemExit(f"n_infers={ni} box={box}: non-finite output")
            n_done += 1
            print(f"ran n_infers={ni} box={box} in {time.perf_counter() - t0:.1f}s",
                  file=sys.stderr, flush=True)
        del fwd
        torch.cuda.empty_cache()
    print(json.dumps({"metric": "compile_gate_programs", "value": n_done,
                      "unit": "programs", "vs_baseline": 1.0}))


def run_batch(net, binp, iters: int = 4):
    """:func:`measure_batch` on the card, with the host syncs of one
    forward, the device memory in use before it (``live_gb``: the network,
    the inputs and whatever the caller holds) and the peak device memory
    (GB) of the protocol."""
    dev = binp.point_feats.device
    torch.cuda.synchronize(dev)
    live = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    syncs = host_syncs(lambda: reduced(net(binp)))
    res = measure_batch(net, binp, iters)
    res.update(syncs=syncs, live_gb=live, peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    return res


def batch_line(res, batch: int, box) -> str:
    return (f"batched, B={batch}, fixed box {tuple(box)}: {res['scans_per_sec']:.4f} scans/s, "
            f"device {res['device_ms']:.3f} ms per batch ({res['device_ms'] / batch:.3f} "
            f"ms/scan), peak {res['peak_gb']:.3f} GB ({res['live_gb']:.3f} GB in use before), "
            f"{len(res['syncs'])} host syncs per "
            f"forward {res['syncs']}")


def main_batch(batch: int, trained: str, n_iters: int):
    """``BENCH_BATCH = batch > 1``: the reference's batched protocol."""
    if int(os.environ.get("BENCH_INFERS", "1")) != 1:
        raise SystemExit("BENCH_BATCH > 1 runs PaSCoConfig() at n_infers 1, as the "
                         "reference's batched branch does; unset BENCH_INFERS")
    if os.environ.get("BENCH_BATCH_PALLAS", "1") == "0":
        raise SystemExit("BENCH_BATCH_PALLAS=0 selects the reference's path without its "
                         "kernels; the port runs its kernels on the card and has no such path")
    dev = _require_card()
    print(card_line(), flush=True)
    cfg = bench_config(1)
    net = build_forward(cfg, dev, trained).net
    res = run_batch(net, batch_scans(cfg, batch, dev), n_iters)
    print(batch_line(res, batch, cfg.scene.box_extent), flush=True)
    print(result_line(res["scans_per_sec"], 1))


def main():
    batch = int(os.environ.get("BENCH_BATCH", "1"))
    n_infers = int(os.environ.get("BENCH_INFERS", "1"))
    trained = os.environ.get("BENCH_TRAINED_CKPT", "")
    if batch > 1:
        return main_batch(batch, trained, int(os.environ.get("BENCH_ITERS", "4")))
    dev = _require_card()
    if trained and n_infers != 1:
        raise SystemExit("BENCH_TRAINED_CKPT is trained at n_infers=1; "
                         "unset it for BENCH_INFERS != 1")
    per_scan = os.environ.get("BENCH_PER_SCAN", "0") == "1"
    fixed = os.environ.get("BENCH_FIXED_BOX", "0") == "1"
    n_iters = int(os.environ.get("BENCH_ITERS", "4"))
    print(card_line(), flush=True)
    cfg = bench_config(n_infers, fixed)
    fwd = build_forward(cfg, dev, trained)
    scans = draw_scans(cfg, int(os.environ.get("BENCH_SCANS", "6")), dev)
    inps, boxes = [s[1] for s in scans], [s[2] for s in scans]
    torch.cuda.reset_peak_memory_stats(dev)
    syncs = host_syncs(lambda: reduced(fwd(inps[0], boxes[0])))
    res = measure(fwd, inps, boxes, per_scan, n_iters)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    proto = "per-scan latency" if per_scan else "pipelined"
    for i, (box, ms) in enumerate(zip(boxes, res["device_ms"])):
        print(f"scan {i}: box {box}, device {ms:.3f} ms", flush=True)
    print(f"{proto}, n_infers={n_infers}, {'fixed' if fixed else 'adaptive'} box: "
          f"{res['scans_per_sec']:.4f} scans/s, device "
          f"{statistics.mean(res['device_ms']):.3f} ms/scan, peak {peak:.3f} GB, "
          f"{len(syncs)} host syncs per forward {syncs}"
          + (f", host enqueue {res['enqueue_s']:.3f} s of {res['wall_s']:.3f} s"
             if "enqueue_s" in res else ""), flush=True)
    print(result_line(res["scans_per_sec"], n_infers))


if __name__ == "__main__":
    if "--compile-only" in sys.argv:
        compile_only()
    else:
        main()
