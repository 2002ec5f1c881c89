#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pasco_torch``) on one GPU.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the hand-written CUDA kernels from ``pasco_torch/csrc`` (nvcc,
   ``sm_90a``) and prints the build time;
3. runs each kernel at main-path shapes made from a synthetic scan of the
   flagship config and holds it against its plain PyTorch version on the
   same inputs: the conv-like kernels in bf16 at mask-valid cells within
   ``2e-2 * max|ref| + 2e-2`` (bf16 output rounding and another summation
   order) with exact zeros at invalid cells, the extraction bit-exact;
   each with its time per call (:func:`time_ms`), the plain version's,
   one library call's where one PyTorch call computes the same function,
   and the bound from this run's inputs (:func:`bound`).  The conv kernel
   runs at every main-path shape, s1/s2/s4/s8 on the scan's occupancy and
   on the near-dense decoder mask (:func:`conv_phase`); the down step at
   enc_s2/s4/s8 on the scan's occupancy (:func:`down_phase`); the
   up-preamble at dec_s4/s2/s1, near dense and sparse, each with two more
   value sets whose bounds come from the deconv path and from the
   coordinate channels near the origin, and shows that a plain run with a
   broken deconv, or coordinates one cell off, would fail them
   (:func:`up_phase`);
   the extraction also with its device time per call from the profiler
   (``device_ms``) and exactly one kernel launch per call;
   the column-sparse conv (row 7) runs through its own entry point on the
   scan's s1 occupancy against cuDNN in f32, within ``1e-5 * max|ref|``, a
   bound that one or two TF32 products break (:func:`column_conv_phase`);
4. drives the flagship forward (``PaSCoConfig()``, n_infers=1, full
   widths, seeded random init) on 3 synthetic scans after one warm-up,
   checks finite outputs of the expected shapes, kept voxels at every
   scale and that every kernel was launched, and prints scans/s,
   device ms/scan and peak device memory; the fused featurizer (row 8)
   then runs through its own entry point on the first scan's points
   against the model's featurizer chain, with its device time per call
   (:func:`featurizer_phase`);
5. runs ``run_scene_inference`` and the ``Evaluator`` on one scan;
   then the scene-adaptive box ladder (``AdaptiveForward``, the bench
   path): rows 1-5 against their plain versions at the 256, 288 and 320
   boxes, each on a scan that picks that box (every check of step 3, each
   row's main case timed: :func:`ladder_kernel_phase`); 20 extractions
   back to back alternating 352 -> 256 -> 320 -> 288, bit-exact
   (:func:`alternating_extraction`); ``scripts_torch/bench.py``'s pipelined
   protocol on ``bench.py``'s six scans through ``AdaptiveForward`` and
   through the fixed 352 box, once each, with each scan's box, scans/s,
   device ms per scan, peak memory and the launches per forward of every
   box (:func:`bench_phase`); the 288 scan through 288 and 352, kept cells
   identical and logits within the bf16 bound (:func:`two_boxes_check`);
   then the batched forward (``B`` scans per call): rows 1-3 on a batch of
   two of bench.py's scans (distinct box corners) at 352, each in one
   launch equal bit for bit to the per-scan launches and within its plain
   version's bound, ``up_preamble`` also with each scan's own box corner,
   where the plain version with the corners swapped must break the bound,
   each row timed against its per-scan launches
   (:func:`batch_kernel_phase`); the forward of that batch against each
   scan's own forward (:func:`batch_forward_check`); ``scripts_torch/
   bench.py``'s batched protocol at B = 1, 2 and 4 with scans/s, device ms
   per batch, peak memory and host syncs (0), and the launches of one
   B = 4 forward (rows 1-3 once, ``stream_extract`` once per scan:
   :func:`batch_bench_phase`); then the MIMO ensemble (n_infers=3): the first 3 of ``bench.py``'s six
   n_infers=3 scans, each 3 augmented views of one scene, through the
   forward (kept voxels for every subnet, at least 60 ``masked_conv3``
   and 12 ``stream_extract`` launches per forward), then
   ``run_scene_inference`` (4 outputs) and the ``Evaluator`` with the
   PQ, SSC mIoU and ECE of every output, and the bench protocol on the
   first three (one run: they all take the 352 box); ``scripts_torch/eval.py`` on
   the card on a fake val scan with a released-format checkpoint at full
   widths runs in a subprocess beside step 9's CLIs (:func:`start_eval_cli`);
6. training, kernel phase: the differentiable conv of every residual
   block (``MaskedConv3Fn``: forward and data gradient on the conv kernel)
   at the train box (256, 256, 32), f=64, on the scan's s1 occupancy and a
   near-dense decoder mask: forward, dx, dw and db against autograd of the
   plain version on the same inputs, within the bound above at valid
   cells, with exact zeros of the output and of dx elsewhere; kernel
   against plain time for the forward and for dx;
7. training, narrow whole step: one train step at
   ``flagship_narrow_config(n_infers=1)`` (full widths, small box; caps
   that do not bind, no point dropout, every spatial dropout at 0.2) with
   the kernels on the card and with the plain versions on the CPU, from
   the same weights, inputs and keep vectors: loss terms and
   per-parameter gradients within the bounds stated at
   :func:`narrow_step_check` (the card tests run it at zero rates too);
8. the trainer (``pasco_torch.training.loop.train``) at ``PaSCoConfig()``:
   n_infers 1 on 2 of 4 synthetic scenes an epoch with 1 validation
   scene, 2 epochs, ``accum_steps=2``, 3 worker processes, then a restore checked bit for
   bit and a resumed run in the same directory (:func:`trainer_phase`: s
   per optimizer step, ms between CUDA events per microbatch, the idle
   share between steps over the second epoch, validation s per scene,
   checkpoint size and save time); n_infers 3, 2 epochs of 1 scene, the
   first sem-only (:func:`trainer_mimo_phase`); each with
   finite losses, moved running statistics and the training conv's
   launches per microbatch;
9. MC dropout at the flagship widths with ``--net_3d_dropout 0.2`` and
   transformer dropout 0.2 (:func:`mc_dropout_phase`, after step 4), and
   the CLIs: ``scripts_torch/make_bench_ckpt.py --steps 2`` with one
   forward on its npz through ``scripts_torch/bench.py``'s loader, while
   ``scripts_torch/bench_train_step.py --steps 2`` runs in a subprocess
   (:func:`cli_phase`);
10. data parallelism at the flagship's full width (:func:`dp_phase`): two
   ranks sharing the card over gloo, on two copies of a train scene with
   SyncBN and shared draws, must take the single-card step (bit-identical
   where the kernels are deterministic) and must miss it with a
   BatchNorm reduction that cuts the statistics' gradient; on two
   distinct scenes without SyncBN it must take their accumulation's
   step on one card; ``dp_eval_step`` on two scenes gives the sum of
   their counts; then a one-rank NCCL group takes the same step;
11. the KITTI-360 preset, ``kitti360_config(n_infers=2)`` at full width on
   synthetic 2-view scans with 8 raw channels (:func:`kitti360_phase`):
   one forward through ``AdaptiveForward`` launching each kernel exactly
   ``forward_launch_floor(2)`` times, ``run_scene_inference`` and the
   ``Evaluator`` (19 classes), one panoptic train step;
12. the sparse substrate (``substrate="sparse"``, :func:`sparse_phase`),
   which launches none of the kernels: ``flagship_narrow_config(1)`` with
   every cap unbound in f32, one forward on the card against one on the
   CPU from the same weights and scan (TF32 off), the same kept cells at
   every scale and for every subnet but near ties, the semantic and query
   logits within ``1e-3 * max|ref| + 1e-4`` (:func:`compare_sparse`);
   then ``PaSCoConfig()`` on bench.py's first scan at n_infers 1 and on
   the first MIMO scan at 3 (one warm-up each; device ms, peak memory and
   host syncs per forward), ``run_scene_inference`` and the ``Evaluator``
   at n_infers 1, and one ``train_step`` at the train box (finite losses,
   every BatchNorm's running statistics moved; step time and peak
   memory), with every launch count 0 over them;
13. the WaffleIron frontend, which launches none of the kernels:
   ``scripts_torch/extract_point_features.py`` on the card (2 votes: the
   reference's 10 cut to 2) on the fake val scan, the port's
   ``KittiDataset`` reading its pickle as 283 columns and
   ``scripts_torch/eval.py`` on it at ``flagship_narrow`` in a subprocess
   beside step 10 (:func:`start_waffle_eval`); then
   (:func:`waffleiron_phase`) the Segmenter at depth 4 and 32
   channels on the card against the CPU in eval and train mode (logits,
   tokens, parked BatchNorm statistics within ``1e-4 * max|ref| + 1e-5``:
   :func:`waffle_card_check`); then ``Segmenter()`` (48 x 256) on a
   120000-point scan (device ms per forward, the host ms of its kNN and
   grid indices, peak memory, host syncs) and
   ``scripts_torch/train_waffleiron.py --synthetic`` at its defaults for 2
   epochs of 4 steps and a resumed third (s per step, peak memory, finite
   losses, both checkpoints), with every launch count 0 over the forward
   and the trainer.

Each ``run_scene_inference`` (steps 5, 11 and 12) takes its forward on the
card in its phase; its host part, the ensembling and the ``Evaluator``,
runs in a worker process beside the card's later phases
(:func:`start_scene_inference`), and its lines print after the last phase.

Prints each phase's wall time, the whole run's, and a JSON line with the
kernels' numbers (``ms``, ``plain_ms``, ``library_ms``, ``bound_ms`` and
``bound_by``, ``device_ms`` for rows 4-5 and 8; launches from the MIMO
forward, the n_infers 3 trainer and the two entry-point phases, and under
``launches_by_path`` those of every path, each counted from 0 just before
it: the MIMO forward, the n_infers 3 trainer, rank 0's data-parallel step,
the KITTI-360 forward, the batched B = 4 forward (``batch``), the
sparse substrate's steps 2-5 of :func:`sparse_phase` (``sparse``, all 0)
and the WaffleIron forward and trainer (``waffleiron``, all 0);
rows 1-5
again per smaller box, named by box, with the launches at that box in the
n_infers=1 bench run; rows 1-3 again on the batch of two, named
``(batch 2)``, with their launches in the B = 4 forward), then as its last
line
``{"ok": true, "device": {...}}``.  Any failure raises (non-zero exit, no
result line); so does a machine without a CUDA device.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import dataclasses
import json
import multiprocessing as mp
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

TOL_REL, TOL_ABS = 2e-2, 2e-2
# Peaks of one H100 SXM (NVIDIA's data sheet, dense): bf16 and TF32 tensor
# cores, f32 outside the tensor cores, HBM3.
PEAK_BF16, PEAK_TF32, PEAK_F32, HBM_BYTES_S = 989e12, 495e12, 67e12, 3.35e12
N_SCANS = 3
BENCH_SCANS = 6            # bench.py's scans (its BENCH_SCANS default)
LADDER = (256, 288, 320)   # the candidate boxes below the flagship's 352
MIMO_S = 3                 # the reference's MIMO headline config (bench.py:54)
KITTI360_S = 2             # the SSCBench-KITTI360 ensemble (SURVEY §6)
DP_WORLD = 2               # ranks sharing the one card in dp_phase
# residual-block 3^3 convs per forward: 4 encoder + 3 decoder stages x
# 3 blocks x 2 convs
RES_CONVS = 42
# Parameters whose gradient is zero in exact arithmetic: a bias feeding a
# training-mode BN (the batch mean removes it) and the attention key
# biases (softmax is shift invariant); both runs return rounding noise.
STRUCTURALLY_ZERO = re.compile(
    r"(res\d+\.conv1\.bias|down\.bias|up_bias|point_mlp\.(fc[123]|bn_in)\.bias"
    r"|k_proj\.bias)$")


def time_ms(fn, reps=5):
    """Median milliseconds per call of ``fn()``: CUDA events around 10
    back-to-back calls, ``reps`` times.  Back to back, a call's host work
    (the wrapper's checks and launch) overlaps the device work of the call
    before, as on the model's path; timed alone, a call of a small kernel
    would read as much host work as device work."""
    batch = 10
    fn()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / batch)
    return statistics.median(samples)


def profile_call(fn, reps=7):
    """The device activities (kernels, memsets, copies) of one call of
    ``fn()``, from one ``torch.profiler`` session of ``reps`` calls, each run
    alone (synchronised before and after) behind a marker kernel: a list of
    lists of (name, ms), one per call recorded whole.  The profiler on the
    card loses records now and then (a call, or a marker, so that two calls
    read as one; earlier, one session per call recorded nothing at all), so
    only the calls with the most common number of activities are kept; at
    least half of them must be, else the session is run again, up to three
    times, and then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):                   # the session's first records can be lost
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(reps):
                torch.cuda._sleep(1000)          # the marker ("spin_kernel")
                torch.cuda.synchronize()
                fn()
                torch.cuda.synchronize()
        acts = sorted((e.time_range.start, e.name, e.time_range.elapsed_us() / 1e3)
                      for e in prof.events() if e.device_type == DeviceType.CUDA)
        calls = []
        for _, name, ms in acts:
            if "spin_kernel" in name:
                calls.append([])
            elif calls:
                calls[-1].append((name, ms))
        calls = [c for c in calls if c]
        if calls:
            n = statistics.mode(len(c) for c in calls)
            calls = [c for c in calls if len(c) == n]
            if 2 * len(calls) >= reps:
                return calls
    raise AssertionError(f"profile_call: the profiler recorded {len(calls)} of {reps} calls "
                         f"whole")


def device_ms(calls, pattern=""):
    """Median over calls of the device ms of the activities whose name
    contains ``pattern`` (all of them by default)."""
    return statistics.median(sum(ms for name, ms in c if pattern in name) for c in calls)


def eval_scene(cfg, rng, n_points=120000, max_angle=30.0):
    """One synthetic scan collated for inference: ``n_infers`` views of it
    under distinct eval augmentations (as bench.py draws them; the
    reference's validation split, ``pasco_tpu/data/semantic_kitti/
    dataset.py:464-489``)."""
    from pasco_torch.data.semantic_kitti.collate import collate
    from pasco_torch.data.semantic_kitti.dataset import process_scene
    from pasco_torch.data.synthetic import make_scene
    from pasco_torch.data.transform_utils import generate_random_transformation

    scene = preset_scene(make_scene(
        rng, scene_size=cfg.scene.scene_size,
        n_points=min(cfg.capacity.num_points, n_points),
        point_feat_dim=cfg.model.in_channels - 6,
    ), cfg)
    views = []
    for _ in range(cfg.model.n_infers):
        T = generate_random_transformation(
            rng, max_angle=max_angle, scale_range=0.0,
            max_translation=(0.2, 0.2, 0.1),
        )
        views.append(process_scene(scene, T, rng, n_classes=cfg.model.n_classes,
                                   thing_ids=cfg.thing_ids))
    return collate(views, cfg, rng=rng)


def preset_scene(scene, cfg):
    """A synthetic scene (SemanticKITTI's 20 classes) in ``cfg``'s classes:
    the labels past the preset's last class folded into it (KITTI-360's 19
    classes end at other-object); unchanged at 20 classes."""
    C = cfg.model.n_classes
    sem = scene.semantic_label
    if int(sem[sem != 255].max(initial=0)) < C:
        return scene
    return scene._replace(semantic_label=np.where((sem >= C) & (sem != 255), C - 1,
                                                  sem).astype(sem.dtype))


def make_scans(cfg, n, device, seed=0):
    """``n`` synthetic scans (:func:`eval_scene`) and their model inputs."""
    from pasco_torch.models.unet import scene_to_model_input

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        col = eval_scene(cfg, rng)
        out.append((col, scene_to_model_input(col, device)))
    return out


def bound(flop, nbytes, peak=PEAK_BF16):
    """Least time on the card (ms) for ``flop`` operations at ``peak`` and
    ``nbytes`` moved through HBM, and which of the two bounds it."""
    ops, mem = flop / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def device_fields(fn, kernel):
    """``device_ms``: the device time of one call of ``fn()`` from the
    profiler (its kernel and any conversion it launches), and
    ``kernel_device_ms``: that of the activities named ``kernel`` alone."""
    calls = profile_call(fn)
    return dict(device_ms=device_ms(calls), kernel_device_ms=device_ms(calls, kernel))


def nbytes(*ts):
    """Bytes of the tensors, each read (or written) once."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def rows_bytes(t, n):
    """Bytes of ``n`` rows (cells) of the ``[..., C]`` tensor ``t``: an
    input the function needs only at ``n`` cells (the mask-valid ones)."""
    return 0 if t is None else int(n) * t.shape[-1] * t.element_size()


def timing_fields(ms, plain_ms, library_ms, flop, nbytes_, peak=PEAK_BF16):
    """The JSON fields of one timed kernel case."""
    bms, by = bound(flop, nbytes_, peak)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms, bound_by=by)


def scan_masks(cfg, inp):
    """Main-path masks of one scan: the s1 occupancy (encoder) and the
    s1 global-bbox mask (the decoder's child set at random init)."""
    from pasco_torch.core.sparse import Box
    from pasco_torch.ops.dense_ops import bbox_mask

    box = Box.create(inp.global_min, cfg.scene.box_extent)
    ex, ey, ez = box.extent
    rel = inp.point_coords[:, 1:] - box.minimum[None]
    ok = inp.point_mask & (rel >= 0).all(-1) & (rel[:, 0] < ex) \
        & (rel[:, 1] < ey) & (rel[:, 2] < ez)
    rel = rel[ok].long()
    occ = torch.zeros((ex, ez, ey), dtype=torch.bool, device=rel.device)
    occ[rel[:, 0], rel[:, 2], rel[:, 1]] = True
    return box, occ, bbox_mask(box, 1, inp.global_min, inp.global_max)


def _compare(name, got, ref, mask, region=None):
    """Conv-like check at valid cells (those in ``region`` where given);
    exact zeros at invalid cells.  Returns (max|d|, bound)."""
    g, r = got.float(), ref.float()
    sel = mask if region is None else mask & region
    err = (g - r)[sel].abs().max().item() if sel.any() else 0.0
    bound = TOL_REL * r[sel].abs().max().item() + TOL_ABS
    print(f"check {name}: max|d| {err:.4g}, bound {bound:.4g}", flush=True)
    if not err <= bound:
        raise AssertionError(f"{name}: max|d| {err} > {bound}")
    if (g[~mask] != 0).any():
        raise AssertionError(f"{name}: non-zero output at invalid cells")
    return err, bound


def conv3d_library(xm, w):
    """The library yardstick of kernel 1: one ``F.conv3d`` (bf16, TF32 off,
    ``channels_last_3d``: the layout of a ``[X, Z, Y, C]`` volume) on the
    masked, prologue-applied input, the ``[27, Ci, Co]`` taps as
    ``[Co, Ci, kX, kZ, kY]``.  The port never calls it."""
    ci, co = w.shape[1:]
    wl = w.reshape(3, 3, 3, ci, co).permute(4, 3, 0, 2, 1).contiguous(
        memory_format=torch.channels_last_3d)
    xl = (xm if xm.dim() == 5 else xm[None]).permute(0, 4, 1, 2, 3)   # a batch at N = B
    return lambda: F.conv3d(xl, wl, padding=1)


def conv_phase(cfg, inp, keep_ref, timed=True):
    """Kernel 1 (``masked_conv3``) at every main-path shape: the res-block
    conv2 form (BN affine + relu prologue; bias, skip, relu epilogue) at
    s1/s2/s4/s8 with the widths of the flagship, each on the scan's
    occupancy (the encoder's masks) and on the near-dense decoder mask (the
    global bbox at that scale: the decoder's child set at random init); then
    the other two launch forms at s1 (res-block conv1 on the occupancy,
    refiner conv1 with the mask only on a 70% keep set).  Each against the
    plain version (the bound of :func:`_compare`), with its time, the plain
    version's, the library call's (:func:`conv3d_library`) and the bound
    from this case's valid cells (without ``timed``, for the s1 near-dense
    case only).  Returns the JSON row: the numbers of the s1 near-dense
    case, every timed case under ``cases``."""
    from pasco_torch.ops import conv
    from pasco_torch.ops.dense_ops import bbox_mask, maxpool2_mask

    dev = inp.point_feats.device
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(11)
    box, occ, _ = scan_masks(cfg, inp)
    cases = []
    for i, sc in enumerate((1, 2, 4, 8)):
        if sc > 1:
            occ = maxpool2_mask(occ)
        dec = bbox_mask(box, sc, inp.global_min, inp.global_max)
        cases += [(f"s{sc} scan occupancy", occ, cfg.model.f_maps[i], "conv2"),
                  (f"s{sc} decoder, near dense", dec, cfg.model.f_maps[i], "conv2")]
    cases += [("s1 scan occupancy, res-block conv1", cases[0][1], cfg.model.f, "conv1"),
              ("s1 refiner conv1 (mask only)", keep_ref, cfg.model.f, "mask")]
    zero = torch.zeros((), dtype=bf, device=dev)
    out, errs, main = [], [], None
    for label, m, c, form in cases:
        X, Z, Y = m.shape
        mm = m[..., None]
        x = torch.where(mm, torch.randn((X, Z, Y, c), generator=g, device=dev).to(bf), zero)
        w = (torch.randn((27, c, c), generator=g, device=dev) * (27 * c) ** -0.5).to(bf)
        a = torch.rand((c,), generator=g, device=dev) + 0.5
        cc = torch.rand((c,), generator=g, device=dev) * 0.2 - 0.1
        kw = {}
        if form in ("conv1", "conv2"):
            kw = dict(bias=torch.rand((c,), generator=g, device=dev) * 0.2 - 0.1,
                      affine=(a, cc), relu_in=True)
        if form == "conv2":
            kw.update(skip=torch.where(
                mm, torch.randn((X, Z, Y, c), generator=g, device=dev).to(bf), zero),
                relu_out=True)
        tiles = conv.conv_tiles(m)
        got = conv.masked_conv3(x, m, w, tiles=tiles, **kw)
        ref = conv.masked_conv3_plain(x, m, w, **kw)
        errs.append(_compare(f"masked_conv3 {label} {(X, Z, Y, c)}", got, ref, m)[0])
        if not timed and label != "s1 decoder, near dense":
            continue
        xp = x if not kw else torch.where(mm, torch.relu(a * x.float() + cc).to(bf), zero)
        n_valid = int(m.sum())
        # bytes: x and skip at the valid cells, the mask, the weights and
        # vectors, the whole output (zeros included) written once
        t = timing_fields(
            time_ms(lambda: conv.masked_conv3(x, m, w, tiles=tiles, **kw)),
            time_ms(lambda: conv.masked_conv3_plain(x, m, w, **kw)),
            time_ms(conv3d_library(xp, w)),
            n_valid * 27 * c * c * 2,
            rows_bytes(x, n_valid) + rows_bytes(kw.get("skip"), n_valid)
            + nbytes(m, w, got, kw.get("bias"), *kw.get("affine", ())))
        kind = "compute" if t["bound_by"] == "operations" else "memory"
        print(f"masked_conv3 {label} {(X, Z, Y, c)}, {int(m.sum())} valid cells in "
              f"{int(tiles.n_active)} of {tiles.n_tiles} tiles: {t['ms']:.3f} ms, plain "
              f"{t['plain_ms']:.3f} ms, library_ms {t['library_ms']:.3f}, bound_ms "
              f"{t['bound_ms']:.3f} ({kind}), {t['bound_ms'] / t['ms']:.1%} of the bound",
              flush=True)
        if label == "s1 decoder, near dense":
            if timed:
                t.update(device_fields(lambda: conv.masked_conv3(x, m, w, tiles=tiles, **kw),
                                       "masked_conv3_kernel"))
            main = t
        out.append(dict(case=label, shape=[X, Z, Y, c], **t))
        del x, got, ref, xp, kw
    return dict(name="masked_conv3", source="pasco_torch/csrc/masked_conv3.cu",
                replaces="pasco_tpu/ops/pallas_conv.py:1159", max_abs_err=max(errs),
                **main, cases=out)


def _rand_fns(gen, dev):
    """Seeded bf16 normals, f32 uniform vectors and a masking helper, drawn
    on the card from a generator that ``gen`` seeds."""
    g = torch.Generator(device=dev).manual_seed(int(torch.randint(1 << 62, (1,), generator=gen)))

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    def vec(n, lo=-0.1, hi=0.1):
        return torch.rand((n,), generator=g, device=dev) * (hi - lo) + lo

    def masked(x, m):
        return torch.where(m[..., None], x, torch.zeros((), dtype=x.dtype, device=dev))

    return randn, vec, masked


def _report(name, label, shape, t, detail):
    kind = "compute" if t["bound_by"] == "operations" else "memory"
    print(f"{name} {label} {shape}, {detail}: {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
          f"library_ms {t['library_ms']:.3f}, bound_ms {t['bound_ms']:.3f} ({kind}), "
          f"{t['bound_ms'] / t['ms']:.1%} of the bound", flush=True)


def down_phase(cfg, inp, gen, timed=True):
    """Kernel 2 (``down2_fused``) at every main-path shape: enc_s2, s4 and
    s8 on the scan's occupancy (the encoder's masks), with the flagship
    widths.  Each against the plain version (the bound of :func:`_compare`,
    exact zeros at invalid cells), with its time, the plain version's, the
    library call's (the stride-2 ``F.conv3d`` alone, ``channels_last_3d``)
    and the bound from this case's valid cells (without ``timed``, for
    enc_s2 only).  Returns the JSON row: the numbers of enc_s2, every timed
    case under ``cases``."""
    from pasco_torch.ops import down
    from pasco_torch.ops.dense_ops import maxpool2_mask

    dev = inp.point_feats.device
    randn, vec, masked = _rand_fns(gen, dev)
    fm = cfg.model.f_maps
    _, occ, _ = scan_masks(cfg, inp)
    out, errs = [], []
    for i, sc in enumerate((2, 4, 8)):
        ci, co = fm[i], fm[i + 1]
        X, Z, Y = occ.shape
        m2 = maxpool2_mask(occ)
        x = masked(randn(X, Z, Y, ci), occ)
        w = randn(8, ci, co, scale=(8 * ci) ** -0.5)
        args = (x, occ, m2, w, vec(co), (vec(co, 0.5, 1.5), vec(co)),
                (vec(co, 0.5, 1.5), vec(co)))
        tiles = down.down_tiles(m2)
        got = down.down2_fused(*args, tiles=tiles)
        label = f"enc_s{sc} scan occupancy"
        errs.append(_compare(f"down2_fused {label}", got, down.down2_fused_plain(*args), m2)[0])
        if not timed and sc != 2:
            occ = m2
            continue
        # library: the stride-2 conv alone (taps (ix, iy, iz) -> [Co, Ci, kX, kZ, kY])
        xl = x.permute(3, 0, 1, 2)[None]
        wl = w.reshape(2, 2, 2, ci, co).permute(4, 3, 0, 2, 1).contiguous(
            memory_format=torch.channels_last_3d)
        n_valid = int(m2.sum())
        t = timing_fields(time_ms(lambda: down.down2_fused(*args, tiles=tiles)),
                          time_ms(lambda: down.down2_fused_plain(*args)),
                          time_ms(lambda: F.conv3d(xl, wl, stride=2)),
                          n_valid * 8 * ci * co * 2,
                          rows_bytes(x, occ.sum())
                          + nbytes(occ, m2, w, got, args[4], *args[5], *args[6]))
        if timed and sc == 2:
            t.update(device_fields(lambda: down.down2_fused(*args, tiles=tiles), "down2_kernel"))
        _report("down2_fused", label, (X, Z, Y, ci, co), t,
                f"{n_valid} of {m2.numel()} output cells valid")
        out.append(dict(case=label, shape=[X, Z, Y, ci, co], **t))
        occ = m2
        del x, got, args
    return dict(name="down2_fused", source="pasco_torch/csrc/down2_fused.cu",
                replaces="pasco_tpu/ops/pallas_down.py:244", max_abs_err=max(errs),
                **{k: v for k, v in out[0].items() if k not in ("case", "shape")}, cases=out)


def up_phase(cfg, inp, gen, timed=True):
    """Kernel 3 (``up_preamble``) at every main-path shape: dec_s4, s2 and
    s1 with the flagship widths, each twice: near dense (the child set
    ``upsample2(maxpool2(bbox)) & bbox``, the random-init path) and sparse
    (``parent_keep`` the scan's occupancy max-pooled to the parent scale,
    the trained regime's stand-in); the union adds the scan's occupancy at
    the child scale (the encoder's skip mask).  Each case runs three value
    sets against the plain version: "coords + skip" (the absolute
    coordinate channels, cells up to ~300 from the origin, dominate |r|, so
    its bound checks the union path but is too coarse for the deconv
    branch or a coordinate one cell off); "deconv" (wr's coordinate rows
    zero, a unit-variance deconv, so the bound comes from the deconv/BN
    path); and "coords" (the box corner moved so that a generated child
    sits at the origin, unit-variance coordinate rows of wr, the deconv and
    the skip scaled down, checked at the cells within 2 of the origin on
    every axis, where a coordinate one cell off moves r by more than the
    bound).  A plain run with the child-offset weights rolled, or the
    parent product dropped, must break the "deconv" bound, and one with the
    coordinates one cell off on any axis the "coords" bound, else the check
    is void.  Times and bounds from the "coords + skip" set; library: the
    deconv alone, one ``F.conv_transpose3d``; without ``timed``, for dec_s1
    near dense only.  Returns the JSON row: the numbers of dec_s1 near dense,
    every timed case under ``cases``."""
    from pasco_torch.core.sparse import Box
    from pasco_torch.ops import deconv
    from pasco_torch.ops.dense_ops import (bbox_mask, cell_coords, maxpool2_mask,
                                           upsample2_mask)

    dev = inp.point_feats.device
    randn, vec, masked = _rand_fns(gen, dev)
    fm = cfg.model.f_maps
    box, occ, _ = scan_masks(cfg, inp)
    occs = {1: occ}
    for sc in (2, 4, 8):
        occs[sc] = maxpool2_mask(occs[sc // 2])
    out, errs = [], []
    for i, sc in ((2, 4), (1, 2), (0, 1)):   # dec_s4, dec_s2, dec_s1
        ci, co = fm[i + 1], fm[i]
        bbox = bbox_mask(box, sc, inp.global_min, inp.global_max)
        for kind, pkeep in (("near dense", maxpool2_mask(bbox)), ("sparse", occs[2 * sc])):
            label = f"dec_s{sc} {kind}"
            child = upsample2_mask(pkeep) & bbox
            union = child | occs[sc]
            X, Z, Y = child.shape
            parent = randn(X // 2, Z // 2, Y // 2, ci)
            skip = masked(randn(X, Z, Y, co), occs[sc])
            bd, br = vec(co), vec(co)
            bn = ((vec(co, 0.5, 1.5), vec(co)), (vec(co + 3, 0.5, 1.5), vec(co + 3)))
            wr_d = randn(co + 3, co, scale=co ** -0.5)
            wr_d[co:] = 0
            wd_d = randn(8, ci, co, scale=ci ** -0.5)
            wr_c = randn(co + 3, co, scale=co ** -0.5)
            wr_c[co:] = randn(3, co)
            # "coords": the origin at a generated child, checked where
            # |u| <= 2 on every axis
            c0 = child.nonzero()[int(child.sum()) // 2]          # (x, z, y)
            box_c = Box.create(-sc * c0[[0, 2, 1]], box.extent)
            near = (cell_coords(box_c, sc).abs() <= 2 * sc).all(-1)

            def up_args(skip_, wd_, wr_, box_=box):
                return (parent, pkeep, child, union, skip_, box_, sc, wd_, bd, *bn, wr_, br)

            sets = [("coords + skip", up_args(skip, randn(8, ci, co, scale=(8 * ci) ** -0.5),
                                              randn(co + 3, co, scale=0.1)), None),
                    ("deconv", up_args(skip * 0.1, wd_d, wr_d), None),
                    ("coords", up_args(skip * 0.01, wd_d * 0.01, wr_c, box_c), near)]
            tiles = deconv.up_tiles(union)
            refs, tols = {}, {}
            for vlabel, args, region in sets:
                refs[vlabel] = deconv.up_preamble_plain(*args)
                err, tols[vlabel] = _compare(
                    f"up_preamble {label}, {vlabel}" + ("" if region is None else " (|u| <= 2)"),
                    deconv.up_preamble(*args, tiles=tiles), refs[vlabel], union, region)
                errs.append(err)
            guards = [("deconv", "child offsets rolled", None,
                       up_args(skip * 0.1, wd_d.roll(1, 0), wr_d)),
                      ("deconv", "parent product dropped", None,
                       up_args(skip * 0.1, torch.zeros_like(wd_d), wr_d))]
            for j, axis in enumerate("xyz"):
                off = torch.zeros(3, dtype=torch.int32, device=dev)
                off[j] = sc
                guards.append(("coords", f"{axis} one cell off", near, up_args(
                    skip * 0.01, wd_d * 0.01, wr_c, Box.create(box_c.minimum + off, box.extent))))
            for vlabel, glabel, region, bad_args in guards:
                bad = deconv.up_preamble_plain(*bad_args)
                sel = union if region is None else union & region
                miss = (bad.float() - refs[vlabel].float())[sel].abs().max().item()
                tol = tols[vlabel]
                print(f"check up_preamble {label} {vlabel} resolution, {glabel}: max|d| "
                      f"{miss:.4g} > bound {tol:.4g}", flush=True)
                if not miss > tol:
                    raise AssertionError(f"up_preamble check cannot see a wrong {vlabel} path "
                                         f"({label}, {glabel}: {miss} <= {tol})")
            del refs, bad
            if not timed and label != "dec_s1 near dense":
                del parent, skip, sets
                continue
            args = sets[0][1]
            got = deconv.up_preamble(*args, tiles=tiles)
            # library: the generative deconv alone, one F.conv_transpose3d
            pl = masked(parent, pkeep).permute(3, 0, 1, 2)[None]
            wtl = args[7].reshape(2, 2, 2, ci, co).permute(3, 4, 0, 2, 1).contiguous(
                memory_format=torch.channels_last_3d)
            n_child = int(child.sum())
            # the deconv and the resize at the children; the parent at
            # parent_keep, the skip at the union, the masks, the weights and
            # the whole output once
            t = timing_fields(time_ms(lambda: deconv.up_preamble(*args, tiles=tiles)),
                              time_ms(lambda: deconv.up_preamble_plain(*args)),
                              time_ms(lambda: F.conv_transpose3d(pl, wtl, stride=2)),
                              n_child * (ci + co + 3) * co * 2,
                              rows_bytes(parent, pkeep.sum()) + rows_bytes(skip, union.sum())
                              + nbytes(pkeep, child, union, got, args[7], args[-2]))
            if timed and label == "dec_s1 near dense":
                t.update(device_fields(lambda: deconv.up_preamble(*args, tiles=tiles),
                                       "up_preamble_kernel"))
            _report("up_preamble", label, (X, Z, Y, ci, co), t,
                    f"{n_child} children, {int(union.sum())} union cells, "
                    f"{int(tiles.n_active)} of {tiles.n_tiles} tiles")
            out.append(dict(case=label, shape=[X, Z, Y, ci, co], **t))
            del parent, skip, got, pl, sets, args
    main = next(c for c in out if c["case"] == "dec_s1 near dense")
    return dict(name="up_preamble", source="pasco_torch/csrc/up_preamble.cu",
                replaces="pasco_tpu/ops/pallas_deconv.py:306", max_abs_err=max(errs),
                **{k: v for k, v in main.items() if k not in ("case", "shape")}, cases=out)


def kernel_phases(cfg, inp, gen, own=True, timed=True):
    """Each kernel against its plain version at main-path shapes of the
    working box ``cfg.scene.box_extent``.  With ``own`` (the kernels of this
    checkout) each ``stream_extract`` call must also be one kernel launch on
    the card.  Without ``timed`` only each row's main case is timed, and
    nothing runs under the profiler (no ``device_ms``)."""
    from pasco_torch import kernels
    from pasco_torch.ops import extract

    dev = inp.point_feats.device
    f = cfg.model.f
    box, occ1, bbox1 = scan_masks(cfg, inp)
    X, Z, Y = occ1.shape
    randn, _, _ = _rand_fns(gen, dev)

    rows = []
    keep_ref = bbox1 & (torch.rand((X, Z, Y), generator=gen) < 0.7).to(dev)

    rows.append(conv_phase(cfg, inp, keep_ref, timed))
    rows.append(down_phase(cfg, inp, gen, timed))
    rows.append(up_phase(cfg, inp, gen, timed))

    # --- kernel 4: stream_extract, bit-exact ------------------------------
    cases = [
        ("dec_s1", bbox1, randn(X, Z, Y, cfg.model.n_classes),
         cfg.capacity.dec_s1),
        ("refiner s1", keep_ref, randn(X, Z, Y, f), cfg.capacity.panop_s1),
        ("dec_s1 rows only (training)", bbox1, None, cfg.capacity.dec_s1),
    ]
    fields = None
    for label, keep, pay, cap in cases:
        before = kernels.LAUNCHES["stream_extract"]
        got = extract.stream_extract(keep, cap, pay)
        if kernels.LAUNCHES["stream_extract"] != before + 1:
            raise AssertionError(f"stream_extract {label}: not one counted launch")
        ref = extract.stream_extract_plain(keep, cap, pay)
        for gname, g, r in zip(("vals", "src", "valid", "total"), got, ref):
            if g.shape != r.shape or not torch.equal(g, r):
                raise AssertionError(f"stream_extract {label}: {gname} differs")
        call = lambda k=keep, c=cap, p=pay: extract.stream_extract(k, c, p)  # noqa: E731
        print(f"check stream_extract {label}: bit-exact, kept {int(got[3])} of "
              f"{keep.numel()}, cap {cap}, E {0 if pay is None else pay.shape[-1]}", flush=True)
        if timed:
            calls = profile_call(call)
            dev_ms = device_ms(calls)
            print(f"stream_extract {label}: device {dev_ms:.4f} ms a call, device activities "
                  f"per call {[name for name, _ in calls[0]]}", flush=True)
            if own and any(len(c) != 1 or "extract_kernel" not in c[0][0] for c in calls):
                raise AssertionError(f"stream_extract {label}: not one kernel launch per "
                                     f"call: {calls}")
        if fields is None:
            # no library call: one PyTorch call that compacts a capped,
            # ordered payload with its source rows does not exist
            # (torch.nonzero syncs the host and leaves the gather to a 2nd)
            fields = timing_fields(
                time_ms(call), time_ms(lambda: extract.stream_extract_plain(keep, cap, pay)),
                None, 0, rows_bytes(pay, min(int(keep.sum()), cap)) + nbytes(keep, *got))
            if timed:
                fields["device_ms"] = dev_ms
    rows.append(dict(
        name="stream_extract", source="pasco_torch/csrc/stream_extract.cu",
        replaces="pasco_tpu/ops/pallas_extract.py:454", max_abs_err=0.0, **fields))
    for r in rows:
        dev_t = (f", device {r['device_ms']:.4f} ms a call"
                 + (f" (kernel {r['kernel_device_ms']:.4f})" if "kernel_device_ms" in r else "")
                 if "device_ms" in r else "")
        print(f"kernel {r['name']}: max|d| {r['max_abs_err']:.4g}, {r['ms']:.3f} ms vs plain "
              f"{r['plain_ms']:.3f} ms, library_ms {r['library_ms']}, bound_ms "
              f"{r['bound_ms']:.4f} ({r['bound_by']}){dev_t}", flush=True)
    return rows


def column_conv_phase(occ1, dev, guards=True):
    """Row 7 through its entry point, ``block_sparse_conv3``, on the scan's
    s1 occupancy as ``[X, Y, Z]``: f32 ``[X, Y, Z, 64]`` input (masked),
    ``[27, 64, 64]`` weight and a bias, once with every column listed (so
    every occupied one is visited) and once with the capacity at half the
    occupied columns.  The plain version is cuDNN ``conv3d`` in f32 (TF32
    off) zeroed outside the visited columns.  Bound ``1e-5 * max|ref|`` at
    visited cells, tight enough to tell f32 from TF32: with ``guards`` the
    plain emulations of one TF32 product and of two (``hi hi + hi lo``) on
    the same inputs must break it; elsewhere both are exactly the bias at
    mask cells and 0 at the others.  Its bound is the 3xTF32 tensor-core
    bound (three TF32 products per f32 one, :data:`PEAK_TF32`), with the f32
    FMA figure beside it.  Returns the JSON row."""
    from pasco_torch import kernels
    from pasco_torch.ops import column_conv as cc

    mask = occ1.permute(0, 2, 1).contiguous()
    X, Y, Z = mask.shape
    c = 64
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((X, Y, Z, c), generator=g, device=dev)
    x = torch.where(mask[..., None], x, torch.zeros((), device=dev))
    w = torch.randn((27, c, c), generator=g, device=dev) * (27 * c) ** -0.5
    b = torch.rand((c,), generator=g, device=dev) * 0.2 - 0.1
    n_cols = -(-X // 8) * -(-Y // 8)
    n_occ = int(cc.active_columns(mask, n_cols)[1])
    cases = [(f"every occupied column ({n_occ} of {n_cols})", n_cols),
             (f"{n_occ // 2} of {n_occ} occupied columns", n_occ // 2)]
    kernels.reset_launches()
    outs = [cc.block_sparse_conv3(x, w, mask, cap, bias=b) for _, cap in cases]
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["column_conv3"]
    errs = []
    for (label, cap), got in zip(cases, outs):
        ref = cc.block_sparse_conv3_plain(x, w, mask, cap, bias=b)
        ids, n = cc.active_columns(mask, cap)
        vis = cc.visited_cells(ids, n, X, Y)[..., None].expand(X, Y, Z)
        mag = ref[vis].abs().max().item()
        err = (got - ref)[vis].abs().max().item()
        bound = 1e-5 * mag
        rest = torch.where(mask[..., None], b, torch.zeros((), device=dev))[~vis]
        print(f"check column_conv3 ({X}, {Y}, {Z}, {c}), {label}: visited cells "
              f"{int(vis.sum())} of {vis.numel()}, max|d| {err:.4g} ({err / mag:.3g} of "
              f"max|ref|), bound {bound:.4g}", flush=True)
        if not err <= bound:
            raise AssertionError(f"column_conv3 {label}: max|d| {err} > {bound}")
        if not (torch.equal(got[~vis], rest) and torch.equal(ref[~vis], rest)):
            raise AssertionError(f"column_conv3 {label}: unvisited columns not conv-free")
        for products, name in ((1, "one TF32 product"), (2, "hi hi + hi lo")) if guards else ():
            emu = cc.block_sparse_conv3_split(x, w, mask, cap, bias=b, products=products)
            e = (emu - ref)[vis].abs().max().item()
            print(f"guard column_conv3, {label}: {name} reads max|d| {e:.4g} ({e / mag:.3g} "
                  f"of max|ref|)", flush=True)
            if e <= bound:
                raise AssertionError(f"column_conv3 {label}: the bound {bound} does not "
                                     f"see {name} ({e})")
        errs.append(err)
    # library: f32 F.conv3d alone over the whole box (TF32 off), [X, Y, Z] order
    xl = x.permute(3, 0, 1, 2)[None]
    wl = w.reshape(3, 3, 3, c, c).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    lib_ms = time_ms(lambda: F.conv3d(xl, wl, padding=1))
    fields = []
    for (label, cap), out in zip(cases, outs):
        ids, n = cc.active_columns(mask, cap)
        n_vis = int(cc.visited_cells(ids, n, X, Y).sum()) * Z
        flop = n_vis * 27 * c * c * 2
        fields.append(timing_fields(
            time_ms(lambda: cc.block_sparse_conv3(x, w, mask, cap, bias=b)),
            time_ms(lambda: cc.block_sparse_conv3_plain(x, w, mask, cap, bias=b)), lib_ms,
            3 * flop, rows_bytes(x, n_vis) + nbytes(w, mask, b, out), PEAK_TF32))
        t = fields[-1]
        if len(fields) == 1:
            t.update(device_fields(lambda: cc.block_sparse_conv3(x, w, mask, cap, bias=b),
                                   "column_"))
        print(f"kernel column_conv3, {label}: {t['ms']:.3f} ms vs plain {t['plain_ms']:.3f} ms, "
              f"library_ms {lib_ms:.3f}, bound_ms {t['bound_ms']:.3f} ({t['bound_by']}, 3xTF32 "
              f"tensor-core peak; {100 * t['bound_ms'] / t['ms']:.1f}% of it), f32 FMA figure "
              f"{flop / PEAK_F32 * 1e3:.3f} ms", flush=True)
    return dict(name="column_conv3", source="pasco_torch/csrc/column_conv3.cu",
                replaces="pasco_tpu/ops/pallas_conv.py:1348", max_abs_err=max(errs),
                launches=launches, **fields[0])


def featurizer_phase(cfg, inp, net):
    """Row 8 through its entry point, ``featurizer_fused``, on the scan's
    points: the seeded net's point-MLP features (bf16) and ``enc_in``
    weight, and a seeded random bias (the net's is zero at init, which
    would leave the kernel's bias read unchecked).  The plain version is
    the model's featurizer chain.
    Occupancy identical; values at occupied cells within the bf16 bound,
    exact zeros elsewhere.  Returns the JSON row."""
    from pasco_torch import kernels
    from pasco_torch.core.sparse import Box
    from pasco_torch.ops import featurizer as fz

    box = Box.create(inp.global_min, cfg.scene.box_extent)
    ex, ey, ez = box.extent
    with torch.no_grad():
        f = net.point_mlp(inp.point_feats, inp.point_mask)
    rel = inp.point_coords[:, 1:] - box.minimum[None]
    in_box = inp.point_mask & (rel >= 0).all(-1) & (rel[:, 0] < ex) \
        & (rel[:, 1] < ey) & (rel[:, 2] < ez)
    w = net.enc_in.kernel[0].detach()
    g = torch.Generator(device=w.device).manual_seed(8)
    b = torch.rand((w.shape[1],), generator=g, device=w.device) * 0.2 - 0.1
    args = (f, rel, in_box, w, b, box.extent, torch.bfloat16)
    kernels.reset_launches()
    x, occ = fz.featurizer_fused(*args)
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["featurizer"]
    xr, occr = fz.featurizer_fused_plain(*args)
    if not torch.equal(occ, occr):
        raise AssertionError("featurizer: occupancy differs")
    print(f"featurizer: {int(in_box.sum())} points in {int(occ.sum())} cells, "
          f"F={f.shape[1]}, C={x.shape[-1]}", flush=True)
    err, _ = _compare("featurizer", x, xr, occ)
    # no library call: a scatter-max over points followed by a 1x1 is two
    # PyTorch calls at least (scatter_reduce, then a product)
    calls = profile_call(lambda: fz.featurizer_fused(*args))
    row = dict(name="featurizer", source="pasco_torch/csrc/featurizer.cu",
               replaces="pasco_tpu/ops/pallas_featurizer.py:214", max_abs_err=err,
               launches=launches, **timing_fields(
                   time_ms(lambda: fz.featurizer_fused(*args)),
                   time_ms(lambda: fz.featurizer_fused_plain(*args)), None,
                   int(occ.sum()) * w.shape[0] * w.shape[1] * 2,
                   nbytes(f, rel, in_box, w, b, x, occ), PEAK_F32),
               device_ms=device_ms(calls), kernel_device_ms=device_ms(calls, "featurizer_kernel"))
    print(f"kernel featurizer: {row['ms']:.3f} ms vs plain {row['plain_ms']:.3f} ms, "
          f"device {row['device_ms']:.4f} ms a call (its kernel {row['kernel_device_ms']:.4f}; "
          f"activities {[name for name, _ in calls[0]]}), bound_ms {row['bound_ms']:.4f} "
          f"({row['bound_by']}), launches {launches}", flush=True)
    return row


def check_output(cfg, out):
    m, cap = cfg.model, cfg.capacity
    S, C, Q = m.n_infers, m.n_classes, m.transformer.num_queries
    shapes = {
        "sem_logits[1]": (out.sem_logits[1].shape, (cap.dec_s1, S, C)),
        "sem_grids[1].feats": (out.sem_grids[1].feats.shape, (cap.dec_s1, m.f)),
        "query_logits": (out.predictor.query_logits.shape, (S, Q, C + 1)),
        "voxel_logits": (out.predictor.voxel_logits.shape, (S, cap.panop_s1, Q)),
        "sem_logits_pruned": (out.sem_logits_pruned.shape, (S, cap.panop_s1, C)),
    }
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise AssertionError(f"{name}: shape {tuple(got)} != {want}")
    tensors = [out.sem_logits_pruned, out.predictor.query_logits,
               out.predictor.voxel_logits]
    tensors += [g.feats for g in (*out.sem_grids.values(), *out.panop_grids.values())]
    tensors += list(out.sem_logits.values())
    for t in tensors:
        if not torch.isfinite(t.float()).all():
            raise AssertionError("non-finite output")
    kept = {s: int(out.sem_grids[s].mask.sum()) for s in (1, 2, 4)}
    if min(kept.values()) <= 0:
        raise AssertionError(f"no kept voxels at some scale: {kept}")
    # every subnet keeps voxels at every scale of its panoptic grids
    sub = {s: out.panop_grids[s].mask.sum(-1).tolist() for s in (1, 2, 4)}
    if min(min(v) for v in sub.values()) <= 0:
        raise AssertionError(f"a subnet kept no voxels at some scale: {sub}")
    return kept, sub


def forward_launch_floor(S):
    """Kernel launches per inference forward at ``S`` subnets: the 42
    residual-block convs plus 2 refiner convs per scale and subnet, the
    enc_s2/s4/s8 downs, the dec_s4/s2/s1 preambles, and one extraction per
    decoder scale plus one per scale and subnet."""
    return {"masked_conv3": RES_CONVS + 6 * S, "down2_fused": 3, "up_preamble": 3,
            "stream_extract": 3 + 3 * S}


def forward_phase(cfg, scans, net, label="forward"):
    """Warm-up + timed forwards; returns launches of the timed run."""
    from pasco_torch import kernels

    dev = scans[0][1].point_feats.device
    with torch.no_grad():
        check_output(cfg, net(scans[0][1]))          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        dev_ms = []
        t0 = time.perf_counter()
        for _, inp in scans:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = net(inp)
            b.record()
            b.synchronize()
            dev_ms.append(a.elapsed_time(b))
            kept, sub = check_output(cfg, out)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"{label} (n_infers={cfg.model.n_infers}): {len(scans) / wall:.4f} scans/s, "
          f"device {statistics.mean(dev_ms):.2f} ms/scan, peak {peak:.3f} GB, "
          f"kept {kept}, kept per subnet {sub}, launches {launches}", flush=True)
    floor = forward_launch_floor(cfg.model.n_infers)
    short = {k: launches[k] for k in floor if launches[k] < floor[k] * len(scans)}
    if short:
        raise AssertionError(f"kernels of the main path launched too rarely: {short}")
    return launches


def train_conv_phase(cfg, col, gen, dev):
    """Row 6 of the kernel table at train shapes: ``MaskedConv3Fn`` (kernel
    forward and dx, plain dw and db) against autograd of the plain version
    on the same inputs.  Returns the JSON row of ``conv3_dx``."""
    from pasco_torch.models.unet import scene_to_model_input
    from pasco_torch.ops import conv
    from pasco_torch.training.loop import train_config

    tcfg = train_config(cfg)
    _, occ1, bbox1 = scan_masks(tcfg, scene_to_model_input(col, dev))
    X, Z, Y = occ1.shape
    f = cfg.model.f
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device=dev, dtype=bf)

    x = randn(X, Z, Y, f)
    w = randn(27, f, f, scale=(27 * f) ** -0.5).float()
    b = (torch.rand((f,), generator=gen) * 0.2 - 0.1).to(dev)
    dy = randn(X, Z, Y, f)
    dec = bbox1 & (torch.rand((X, Z, Y), generator=gen) < 0.9).to(dev)
    errs, times = {}, {}
    for label, m in (("s1 occupancy", occ1), ("decoder, near dense", dec)):
        tiles = conv.conv_tiles(m)
        grads = []
        for fn in (lambda *a: conv.MaskedConv3Fn.apply(*a, tiles), conv.masked_conv3_plain):
            xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
            y = fn(xs, m, ws, bs)
            y.backward(dy)
            grads.append((y.detach(), xs.grad, ws.grad, bs.grad))
        (y, gx, gw, gb), (yr, gxr, gwr, gbr) = grads
        every = torch.ones((), dtype=torch.bool, device=dev)
        for name, got, ref, valid in (("forward", y, yr, m), ("dx", gx, gxr, m),
                                      ("dw", gw, gwr, every.expand(27, f)),
                                      ("db", gb, gbr, every.expand(f))):
            errs[name] = max(errs.get(name, 0.0), _compare(
                f"MaskedConv3Fn {name}, {label}", got, ref, valid)[0])
        dym = torch.where(m[..., None], dy, torch.zeros((), dtype=bf, device=dev))
        xm = torch.where(m[..., None], x, torch.zeros((), dtype=bf, device=dev))
        w_t = w.flip(0).transpose(1, 2)
        wb, w_tb = w.to(bf), w_t.to(bf)
        n_valid = int(m.sum())
        flop = n_valid * 27 * f * f * 2
        # bytes: the input at the valid cells, the mask, the weights (and
        # bias), the whole output written once (x and dym have its shape)
        fwd = timing_fields(time_ms(lambda: conv.masked_conv3(x, m, w, b, tiles=tiles)),
                            time_ms(lambda: conv.masked_conv3_plain(x, m, w, b)),
                            time_ms(conv3d_library(xm, wb)), flop,
                            rows_bytes(x, n_valid) + nbytes(m, wb, b, x))
        dx = timing_fields(time_ms(lambda: conv.conv3_dx(dym, m, w, tiles)),
                           time_ms(lambda: conv.masked_conv3_plain(dym, m, w_t)),
                           time_ms(conv3d_library(dym, w_tb)), flop,
                           rows_bytes(dym, n_valid) + nbytes(m, wb, dym))
        if label == "decoder, near dense":
            dx.update(device_fields(lambda: conv.conv3_dx(dym, m, w, tiles),
                                    "masked_conv3_kernel"))
        times[label] = dx
        dw_ms = time_ms(lambda: conv.conv3_weight_grad(xm, dym))
        for name, t in (("forward", fwd), ("dx", dx)):
            kind = "compute" if t["bound_by"] == "operations" else "memory"
            print(f"train conv (row 6) {name} at {(X, Z, Y, f)}, {label}: {t['ms']:.3f} ms, "
                  f"plain {t['plain_ms']:.3f} ms, library_ms {t['library_ms']:.3f}, bound_ms "
                  f"{t['bound_ms']:.3f} ({kind}), {t['bound_ms'] / t['ms']:.1%} of the bound",
                  flush=True)
        print(f"train conv (row 6) dw (plain per-tap products) at {(X, Z, Y, f)}, {label}: "
              f"{dw_ms:.3f} ms", flush=True)
    return dict(name="conv3_dx", source="pasco_torch/csrc/masked_conv3.cu",
                replaces="pasco_tpu/ops/pallas_conv.py:1303", max_abs_err=errs["dx"],
                **times["decoder, near dense"])


class DecisionPins:
    """The train step's discrete decisions, shared by several runs of it.
    A kept cell (the per-subnet argmax of the bf16 decoder logits,
    ``top_class``), an attention-mask entry (a mask logit against 0,
    ``downscale_attn_allowed``) and a query-target assignment
    (``match_all``) each flip at a near-tie, which the summation order
    decides, and a flip moves every gradient downstream of it; a spatial
    dropout's keep vector (``SpatialDropout.draw``) comes from the run's
    own generator, which differs between the card and the CPU.  The first
    run under :meth:`run` records each decision, call by call; every later
    run uses the recorded ones in place of its own."""

    def __init__(self):
        self.calls = {}

    @contextlib.contextmanager
    def run(self):
        from pasco_torch.loss import criterion
        from pasco_torch.models import dense_unet, transformer

        sites = ((dense_unet.DenseDecoderStage, "_finish", 2),
                 (transformer, "downscale_attn_allowed", None),
                 (criterion, "match_all", None),
                 (dense_unet.SpatialDropout, "draw", None))
        record = not self.calls
        saved, used = [], {}
        for owner, name, idx in sites:
            fn = getattr(owner, name)
            saved.append((owner, name, fn))
            setattr(owner, name, self._pin(fn, self.calls.setdefault(name, []), record, idx,
                                           used.setdefault(name, [0])))
        try:
            yield
        finally:
            for owner, name, fn in saved:
                setattr(owner, name, fn)
        short = {k: (used[k][0], len(v)) for k, v in self.calls.items()
                 if not v and k != "draw" or not record and used[k][0] != len(v)}
        if short:
            raise AssertionError(f"pinned decisions (used, recorded) do not match: {short}")

    @staticmethod
    def _pin(fn, calls, record, idx, used):
        def pinned(*args, **kw):
            out = fn(*args, **kw)
            got = out if idx is None else out[idx]
            one = isinstance(got, torch.Tensor)
            if record:
                calls.append([t.cpu() for t in ([got] if one else got)])
                return out
            want = calls[used[0]]
            used[0] += 1
            mine = [got] if one else got
            if [t.shape for t in want] != [t.shape for t in mine]:
                raise AssertionError(f"pinned decision of another shape at call {used[0]}")
            want = [w.to(t.device) for w, t in zip(want, mine)]
            want = want[0] if one else want
            return want if idx is None else (*out[:idx], want, *out[idx + 1:])

        return pinned


def narrow_step_check(dev, n_infers=1, seed=1, dropout=0.0):
    """One train step at ``flagship_narrow_config(n_infers)`` with the
    kernels on the card (bf16) against the same step with the plain
    versions on the CPU, in bf16 and in f32, from the same weights and
    inputs (the scene from data ``seed``).  The decoder caps are raised to
    the box's cell count, so the Gumbel cap is a no-op; the config has no
    point dropout; ``dropout > 0`` sets every spatial dropout to that rate
    (the three encoder and decoder stages of ``--net_3d_dropout``'s
    schedule, and the bottleneck's), whose keep vectors the CPU steps take
    from the card step (:class:`DecisionPins`); the BN biases are drawn non-zero (at a zero bias, a
    leaky/relu between two BNs makes the first one's scale gradient
    structurally zero).  The two CPU steps take the card step's discrete
    decisions (:class:`DecisionPins`: kept cells, attention masks,
    matches), so that the three steps differ only by rounding, not by a
    near-tie that the summation order flipped (PERF.md, Findings).

    In bf16 this model's gradient at random init is far from its f32
    gradient (median 25% in norm per parameter, measured for both the
    plain CPU path and the kernels, PERF.md), and the two bf16 paths
    differ from each other about as much, so the kernels are held to the
    plain bf16 path's own accuracy: every loss term within
    ``5e-2 * |ref| + 5e-2`` of the plain bf16 step, and for every
    parameter ``|g - g_f32| <= 1.5 * |g_bf16 - g_f32| + 0.05 * |g_f32|``
    in norm, with the median over parameters of the left side at most 1.2
    times the right side's; the structurally zero gradients (rounding
    noise) stay below ``1e-2`` of the largest gradient."""
    from pasco_torch.core.config import OptimConfig, flagship_narrow_config
    from pasco_torch.models.norm import BatchNorm
    from pasco_torch.models.unet import build_net, scene_to_model_input
    from pasco_torch.training import step as tstep
    from pasco_torch.training.loop import synthetic_train_scenes

    cfg = flagship_narrow_config(n_infers=n_infers)
    ex, ey, ez = cfg.scene.box_extent
    n = ex * ey * ez
    cfg = cfg.replace(
        capacity=dataclasses.replace(cfg.capacity, dec_s4=n // 64, dec_s2=n // 8, dec_s1=n),
        optim=OptimConfig(lr=1e-3, warmup_steps=0))
    if dropout:
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, encoder_dropouts=(0.0,) * 3 + (dropout,) * 3,
            decoder_dropouts=(dropout,) * 3 + (0.0,) * 2, dense3d_dropout=dropout))
    freqs = {s: np.ones(cfg.model.n_classes) for s in (1, 2, 4)}
    lw = tstep.labelweights_for(cfg, freqs)
    cw = tstep.class_weight_vector(cfg.model.n_classes, cfg.loss.no_object_weight)
    init = build_net(cfg, device="cpu")
    init.reset_parameters(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in init.modules():
            if isinstance(m, BatchNorm):
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
    col = synthetic_train_scenes(cfg, 1, seed=seed)[0]
    runs, pins = {}, DecisionPins()
    for name, dtype, d in (("cuda", "bfloat16", dev), ("cpu", "bfloat16", torch.device("cpu")),
                           ("cpu f32", "float32", torch.device("cpu"))):
        c = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype=dtype))
        model = build_net(c, d)
        model.load_state_dict(init.state_dict())
        state = tstep.create_train_state(model, c)
        t0 = time.perf_counter()
        with pins.run():
            logs = tstep.train_step(
                state, scene_to_model_input(col, d), tstep.targets_to_device(col.targets, d),
                {s: torch.as_tensor(v, device=d) for s, v in lw.items()},
                torch.as_tensor(cw, device=d), c)
        runs[name] = ({k: float(v) for k, v in logs.items()},
                      {k: p.grad.float().cpu() for k, p in model.named_parameters()},
                      time.perf_counter() - t0)
    (logs, grads, t_gpu), (ref_logs, ref_g, t_cpu), (_, g32, _) = (
        runs["cuda"], runs["cpu"], runs["cpu f32"])
    worst = max(abs(logs[k] - v) / (5e-2 * abs(v) + 5e-2) for k, v in ref_logs.items())
    top = max(v.abs().max().item() for v in g32.values())
    err, err_plain = {}, {}
    for k, v in g32.items():
        if not STRUCTURALLY_ZERO.search(k):
            err[k] = ((grads[k] - v).norm() / v.norm().clamp(min=1e-30)).item()
            err_plain[k] = ((ref_g[k] - v).norm() / v.norm().clamp(min=1e-30)).item()
    over = {k: (err[k], err_plain[k]) for k in err if err[k] > 1.5 * err_plain[k] + 0.05}
    med, med_plain = statistics.median(err.values()), statistics.median(err_plain.values())
    zero = max(max(grads[k].abs().max().item(), v.abs().max().item())
               for k, v in ref_g.items() if STRUCTURALLY_ZERO.search(k))
    ratio = max(err[k] / max(err_plain[k], 1e-12) for k in err)
    print(f"narrow step (n_infers={n_infers}, seed {seed}, spatial dropout {dropout}, "
          f"{len(pins.calls.get('draw', []))} keep vectors pinned): total_loss {logs['total_loss']:.6g} (cuda bf16) vs "
          f"{ref_logs['total_loss']:.6g} (cpu plain bf16) vs "
          f"{runs['cpu f32'][0]['total_loss']:.6g} (cpu plain f32); worst loss term at "
          f"{worst:.3f} of its bound; gradient error against f32, median over "
          f"parameters: {med:.4g} (cuda) vs {med_plain:.4g} (cpu bf16), worst "
          f"ratio {ratio:.3f}; structurally zero max {zero:.3g} vs bound "
          f"{1e-2 * top:.3g}; step {t_gpu:.2f} s (cuda) / {t_cpu:.2f} s (cpu bf16)",
          flush=True)
    if dropout and not pins.calls.get("draw"):
        raise AssertionError("narrow step: no spatial dropout drew a keep vector")
    if not worst <= 1.0:
        raise AssertionError(f"narrow step: loss terms differ ({worst:.3f} of the bound)")
    if over or not med <= 1.2 * med_plain or not zero <= 1e-2 * top:
        raise AssertionError(f"narrow step: gradients off: {dict(list(over.items())[:5])}, "
                             f"median {med:.4g} vs {med_plain:.4g}, zero {zero:.3g}")


def _check_steps(label, recs):
    for r in recs:
        print(f"{label} step {r['step']}: is_predict_panop {r['is_predict_panop']}, "
              f"total_loss {r['total_loss']:.6g}, grad_norm {r['grad_norm']:.6g}, "
              f"{r['step_s']:.4f} s, {r['event_ms']:.2f} ms between events", flush=True)
    if not all(np.isfinite(r["total_loss"]) and np.isfinite(r["grad_norm"])
               and r["grad_norm"] > 0 for r in recs):
        raise AssertionError(f"{label}: non-finite loss or gradient: {recs}")


def _check_conv_launches(label, launches, convs):
    """``convs`` differentiable convs per step: each runs its forward twice
    (remat reruns it in backward) and its data gradient once."""
    floor = {"masked_conv3": 2 * convs, "conv3_dx": convs}
    short = {k: launches[k] for k in floor if launches[k] < floor[k]}
    if short:
        raise AssertionError(f"{label}: conv kernels launched too rarely per step: {short}")


def _synthetic_dataset(cfg, n, **kw):
    """A ``SyntheticKittiDataset`` of ``n`` flagship-sized scenes (120000
    points) for ``cfg``."""
    from pasco_torch.data.synthetic import SyntheticKittiDataset

    return SyntheticKittiDataset(
        n_scenes=n, n_subnets=cfg.model.n_infers, scene_size=cfg.scene.scene_size,
        n_points=min(cfg.capacity.num_points, 120000),
        point_feat_dim=cfg.model.in_channels - 6, **kw)


def _check_trained(label, state, launches, n_micro):
    """The trainer's run: finite losses and non-zero gradients at every
    optimizer step, every running statistic moved from its init (mean 0,
    var 1), and per microbatch two ``masked_conv3`` launches (remat reruns
    the forward) and one ``conv3_dx`` launch for every residual-block conv
    and, in a panoptic microbatch, every refiner conv."""
    from pasco_torch.models.norm import BatchNorm

    _check_steps(label, state.history)
    still = [n for n, m in state.net.named_modules() if isinstance(m, BatchNorm)
             and ((m.mean == 0).any() or (m.var == 1).any())]
    if still:
        raise AssertionError(f"{label}: running statistics did not move: {still[:5]}")
    S = state.net.cfg.model.n_infers
    convs = sum((RES_CONVS + 6 * S * r["is_predict_panop"]) * n_micro for r in state.history)
    _check_conv_launches(label, launches, convs)


def trainer_phase(dev):
    """``pasco_torch.training.loop.train`` at ``PaSCoConfig()`` (n_infers 1):
    2 of 4 synthetic scenes (120000 points) an epoch and 1 validation
    scene, 2 epochs, ``accum_steps=2``, 3 worker processes, in a temporary
    ``log_dir``.  Requires 2 optimizer steps, the checks of :func:`_check_trained`, the
    epoch and ``val/pq_dagger_all`` lines in ``metrics.jsonl`` and
    checkpoints at both epochs.  Then the latest checkpoint, restored as
    ``train()`` restores it (``CheckpointManager.restore``) into the final
    state zeroed, must give back the net (parameters and running
    statistics), both AdamW moments, the update count and the step bit for
    bit; and a second ``train()`` in that directory (one epoch of one
    scene, ``accum_steps=1``, collated in this process) must resume there
    and go on from step 2 to 3.  Prints s per optimizer step (host clock), the ms between
    CUDA events around each microbatch (host work inside the step that the
    card waits on, the matching, counts: not the card's busy time), the
    idle share between steps over the second epoch (1 - the epoch's summed
    event ms / its wall time: the time no step ran), validation s per
    scene, and the checkpoint's size and the time of one more save of the
    same state.  Returns the launches of the first run."""
    from pasco_torch import kernels
    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.training.checkpoint import CheckpointManager
    from pasco_torch.training.loop import read_metrics, train

    cfg = PaSCoConfig()
    label = "trainer (n_infers=1)"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as log_dir:
        kernels.reset_launches()
        t0 = time.perf_counter()
        state = train(cfg, _synthetic_dataset(cfg, 4),
                      _synthetic_dataset(cfg, 1, split="val", seed=50), n_epochs=2,
                      limit_train_batches=2, log_dir=log_dir, accum_steps=2, num_workers=3, device=dev)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        if state.step != 2 or len(state.history) != 2:
            raise AssertionError(f"{label}: {state.step} steps, {len(state.history)} records")
        _check_trained(label, state, launches, 2)
        metrics = read_metrics(log_dir)
        epochs = [r for r in metrics if "epoch" in r]
        val = [r for r in metrics if "val/pq_dagger_all" in r]
        ckpt = CheckpointManager(os.path.join(log_dir, "checkpoints"))
        if len(epochs) != 2 or len(val) != 2 or ckpt.all_steps() != [1, 2]:
            raise AssertionError(f"{label}: metrics {metrics}, checkpoints {ckpt.all_steps()}")
        second = [r for r in state.history if r["epoch"] == 1]
        idle = 1 - sum(r["event_ms"] for r in second) / 1e3 / epochs[1]["epoch_time"]
        micro = [ms for r in state.history for ms in r["micro_event_ms"]]
        size = os.path.getsize(os.path.join(ckpt.directory, "ckpt_2.pt")) / 1e9
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as other:
            t1 = time.perf_counter()
            CheckpointManager(other).save(2, state, {"monitor": val[-1]["val/pq_dagger_all"]})
            save_s = time.perf_counter() - t1
        print(f"{label}: {wall:.1f} s for 2 epochs; s per optimizer step "
              f"{[round(r['step_s'], 4) for r in state.history]} (median "
              f"{statistics.median(r['step_s'] for r in state.history):.4f}), "
              f"{statistics.mean(micro):.2f} ms between events per microbatch "
              f"({[round(m, 2) for m in micro]}), second epoch {epochs[1]['epoch_time']:.3f} s, "
              f"idle share between steps {idle:.4f}; "
              f"validation {[round(r['val/s_per_scene'], 3) for r in val]} s per scene, "
              f"pq_dagger {[r['val/pq_dagger_all'] for r in val]}; checkpoint {size:.3f} GB, "
              f"save {save_s:.2f} s; launches {launches}", flush=True)

        saved = {k: v.clone() for k, v in state.net.state_dict().items()}
        moments = {n: {k: v.clone() for k, v in getattr(state.opt, n).items()}
                   for n in ("mu", "nu")}
        count = state.opt.count
        for v in [*state.net.state_dict().values(), *state.opt.mu.values(),
                  *state.opt.nu.values()]:
            v.zero_()
        state.opt.count = state.step = 0
        ckpt.restore(state)
        diff = [k for k, v in state.net.state_dict().items() if not torch.equal(v, saved[k])]
        diff += [f"opt.{n}.{k}" for n, m in moments.items() for k, v in m.items()
                 if not torch.equal(getattr(state.opt, n)[k], v)]
        if diff or state.step != 2 or state.opt.count != count:
            raise AssertionError(f"{label}: restore differs: step {state.step}, count "
                                 f"{state.opt.count}, {diff[:5]}")
        n_tensors = len(saved)
        del state, saved, moments
        more = train(cfg, _synthetic_dataset(cfg, 4), n_epochs=1, log_dir=log_dir,
                     limit_train_batches=1, num_workers=0, device=dev)
        if [r["step"] for r in more.history] != [3] or ckpt.latest_step() != 3:
            raise AssertionError(f"{label}: the resumed run did not go on from step 2: "
                                 f"{more.history}, checkpoints {ckpt.all_steps()}")
        print(f"{label}: restored step 2 bit-identical ({n_tensors} tensors, both AdamW "
              f"moments, count {count}); the resumed run took step 3, "
              f"total_loss {more.history[0]['total_loss']:.6g}", flush=True)
    return launches


def trainer_mimo_phase(dev):
    """``train`` at ``PaSCoConfig()`` with n_infers 3: 2 epochs of 1 of 2
    synthetic scenes (3 augmented views each), no validation; the first
    epoch is sem-only (``{4: 2, 3: 1}``) and the second panoptic.  The
    checks of :func:`_check_trained`; prints s/step, the ms between CUDA
    events per step and peak memory.  Returns the launches."""
    from pasco_torch import kernels
    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.training.loop import train

    cfg = PaSCoConfig()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, n_infers=MIMO_S))
    label = f"trainer (n_infers={MIMO_S})"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train3_") as log_dir:
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        state = train(cfg, _synthetic_dataset(cfg, 2, data_aug=True), n_epochs=2,
                      limit_train_batches=1, log_dir=log_dir, num_workers=3, device=dev)
        launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    panop = [r["is_predict_panop"] for r in state.history]
    if panop != [False, True]:
        raise AssertionError(f"{label}: is_predict_panop per step {panop}")
    _check_trained(label, state, launches, 1)
    print(f"{label}: s/step {[round(r['step_s'], 4) for r in state.history]}, ms between "
          f"events {[round(r['event_ms'], 2) for r in state.history]} (sem-only, panoptic), "
          f"peak {peak:.3f} GB, launches {launches}", flush=True)
    return launches


def _script(name):
    """``scripts_torch/<name>.py`` as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts_torch",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"scripts_torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mc_dropout_phase(dev, inp):
    """MC dropout at ``PaSCoConfig()`` widths with ``scripts_torch/
    train.py``'s ``--net_3d_dropout 0.2`` schedule and transformer dropout
    0.2 (point dropout 0.05): two ``mc_eval_step`` forwards with different
    generators differ, each passes :func:`check_output` and launches rows
    1-5 as often as :func:`forward_launch_floor` says; a plain eval forward
    before and after is bit-identical, and the running statistics are
    untouched."""
    from pasco_torch import kernels
    from pasco_torch.models.unet import build_net
    from pasco_torch.training.step import eval_step, mc_eval_step

    cli = _script("train")
    cfg = cli.build_config(cli.parse_args(["--dataset_root", "-", "--net_3d_dropout", "0.2",
                                           "--transformer_dropout", "0.2"]))
    net = build_net(cfg, dev)
    net.reset_parameters(torch.Generator().manual_seed(0))
    drops = [n for n, _ in net.named_modules() if n.endswith("drop") or "_drop_" in n]
    before = {k: v.clone() for k, v in net.state_dict().items()}

    def flat(out):
        return [t for t in (out.predictor.query_logits, out.predictor.voxel_logits,
                            *out.sem_logits.values(),
                            *(g.feats for g in out.panop_grids.values()),
                            *(g.coords for g in out.panop_grids.values()))]

    plain = flat(eval_step(net, inp))
    floor = forward_launch_floor(1)
    samples = []
    for seed in (1, 2):
        kernels.reset_launches()
        out = mc_eval_step(net, inp, torch.Generator(device=dev).manual_seed(seed))
        launches = dict(kernels.LAUNCHES)
        check_output(cfg, out)
        short = {k: launches[k] for k in floor if launches[k] < floor[k]}
        if short:
            raise AssertionError(f"MC dropout: kernels launched too rarely: {short}")
        samples.append(flat(out))
    again = flat(eval_step(net, inp))
    torch.cuda.synchronize()
    q = [s[0].float() for s in samples]
    spread = (q[0] - q[1]).abs().max().item()
    if not spread > 0:
        raise AssertionError("MC dropout: two samples with different generators are equal")
    if not all(torch.equal(a, b) for a, b in zip(plain, again)):
        raise AssertionError("MC dropout: the eval forward changed")
    moved = [k for k, v in net.state_dict().items() if not torch.equal(v, before[k])]
    if moved:
        raise AssertionError(f"MC dropout: state moved: {moved[:5]}")
    print(f"MC dropout (dropout modules {drops}): two samples differ (query logits max|d| "
          f"{spread:.4g}), launches per forward {launches} (floors {floor}); eval forward "
          f"before and after bit-identical, state untouched", flush=True)


def _wait_logged(proc, logs, timeout=600):
    """Wait for ``proc`` (killed after ``timeout`` s) and read back its
    standard output and error from the temporary files ``logs``."""
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    return texts


def cli_phase(dev, inp):
    """``scripts_torch/bench_train_step.py --steps 2`` in a subprocess,
    whose last line must be its JSON, while this process runs
    ``scripts_torch/make_bench_ckpt.py --steps 2`` to a temporary npz,
    which ``scripts_torch/bench.py``'s loader reads with ``strict=True``
    for one finite forward.  The two share the card and the host, so
    neither's times here are its own."""
    from pasco_torch.core.config import PaSCoConfig

    bench, cfg = _script("bench"), PaSCoConfig()
    torch.cuda.empty_cache()           # the subprocess's step needs ~20 GB of the card
    t0 = time.perf_counter()
    logs = [tempfile.TemporaryFile("w+") for _ in range(2)]    # no pipe to fill unread
    proc = subprocess.Popen([sys.executable, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts_torch", "bench_train_step.py"), "--steps", "2"],
        stdout=logs[0], stderr=logs[1], text=True)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
            out = os.path.join(tmp, "bench_ckpt.npz")
            _script("make_bench_ckpt").main(["--steps", "2", "--out", out])
            t_make = time.perf_counter() - t0
            fwd = bench.build_forward(cfg, dev, trained=out)
            with torch.no_grad():
                res = check_output(cfg, fwd(inp))
        print(f"make_bench_ckpt --steps 2: {t_make:.1f} s; BENCH_TRAINED_CKPT forward: kept "
              f"{res[0]}", flush=True)
    except BaseException:
        proc.kill()
        raise
    finally:
        stdout, stderr = _wait_logged(proc, logs)
    lines = stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"bench_train_step.py exit {proc.returncode}: {stderr[-2000:]}")
    res = json.loads(lines[-1])
    if res.get("metric") != "train_sec_per_step" or not res["value"] > 0:
        raise AssertionError(f"bench_train_step.py: last line {lines[-1]}")
    print("\n".join(f"  bench_train_step.py: {line}" for line in lines), flush=True)
    print(f"bench_train_step.py --steps 2: {time.perf_counter() - t0:.1f} s from its start",
          flush=True)


def with_box(cfg, side):
    """``cfg`` with a ``side x side`` working box (the ladder's form)."""
    return cfg.replace(scene=dataclasses.replace(
        cfg.scene, box_extent=(side, side, cfg.scene.box_extent[2])))


def unaugmented_scene(cfg, seed=3):
    """One synthetic scan without augmentation, collated: the canonical
    256x256x32 extent, the smallest box of the ladder."""
    from pasco_torch.data.semantic_kitti.collate import collate
    from pasco_torch.data.semantic_kitti.dataset import process_scene
    from pasco_torch.data.synthetic import make_scene

    rng = np.random.RandomState(seed)
    scene = make_scene(rng, scene_size=cfg.scene.scene_size,
                       n_points=min(cfg.capacity.num_points, 120000),
                       point_feat_dim=cfg.model.in_channels - 6)
    return collate([process_scene(scene, None, rng)], cfg, rng=rng)


def host_scenes(kind, n_infers, n, seed, nice=0, out=None):
    """Collated scenes of ``PaSCoConfig()`` at ``n_infers``, drawn on the
    host (NumPy only, so a worker process draws them while the card works):
    ``"eval"`` the scans of :func:`make_scans`, ``"train"`` those of
    ``synthetic_train_scenes``, ``"unaugmented"`` :func:`unaugmented_scene`,
    ``"kitti360"`` the scan and the train scene of :func:`kitti360_scenes`,
    ``"batch"`` the first ``n`` scans of ``scripts_torch/bench.py``'s batched
    protocol.
    ``nice`` lowers the drawing process's priority, so that it takes the
    cores the main process leaves idle.  With ``out``, the scenes are
    pickled to that file and the path is returned: the process that waits
    for them then unpickles them when it needs them, not in the executor's
    result thread while it times kernels."""
    import pickle

    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.training.loop import synthetic_train_scenes

    if nice:
        os.nice(nice)
    cfg = PaSCoConfig()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, n_infers=n_infers))
    if kind == "eval":
        rng = np.random.RandomState(seed)
        cols = [eval_scene(cfg, rng) for _ in range(n)]
    elif kind == "train":
        cols = synthetic_train_scenes(cfg, n, seed)
    elif kind == "kitti360":
        cols = kitti360_scenes(n_infers, seed)
    elif kind == "batch":
        cols = _script("bench").batch_scenes(cfg, n)
    else:
        cols = [unaugmented_scene(cfg, seed)]
    if out is None:
        return cols
    with open(out, "wb") as fh:
        pickle.dump(cols, fh, protocol=pickle.HIGHEST_PROTOCOL)
    return out


def box_of(cfg, col):
    from pasco_torch.inference.dispatch import candidate_boxes, pick_box

    return pick_box(candidate_boxes(cfg), col.global_min, col.global_max)


def ladder_kernel_phase(cfg, box_scans, gen):
    """Rows 1-5 against their plain versions at each smaller box of the
    ladder, on a scan that picks that box: every check of
    :func:`kernel_phases`, each row's main case timed.  Returns the rows,
    named by box."""
    rows = []
    for side, (col, inp) in box_scans.items():
        if box_of(cfg, col)[0] != side:
            raise AssertionError(f"the scan for box {side} picks {box_of(cfg, col)}")
        print(f"-- kernels at box {side} (scan bbox {col.global_max - col.global_min + 1})",
              flush=True)
        for r in kernel_phases(with_box(cfg, side), inp, gen, timed=False):
            r.pop("cases", None)
            rows.append(dict(r, kernel=r["name"], name=f"{r['name']} (box {side})",
                             box=[side, side, cfg.scene.box_extent[2]]))
    return rows


def alternating_extraction(cfg, box_scans, gen, n_calls=20):
    """``stream_extract`` at dec_s1 (E = n_classes, the decoder cap) on the
    global-bbox keep of each box's scan, ``n_calls`` calls back to back that
    alternate 352 -> 256 -> 320 -> 288 (the tile count falls and rises on
    one workspace), then every output against the plain version:
    bit-exact."""
    from pasco_torch.ops import extract

    order = (352, 256, 320, 288)
    cap = cfg.capacity.dec_s1
    calls = {}
    for side in order:
        _, inp = box_scans[side]
        _, _, keep = scan_masks(with_box(cfg, side), inp)
        randn, _, _ = _rand_fns(gen, keep.device)
        pay = randn(*keep.shape, cfg.model.n_classes)
        calls[side] = (keep, cap, pay, extract.stream_extract_plain(keep, cap, pay))
    outs = [(order[i % 4], extract.stream_extract(*calls[order[i % 4]][:3]))
            for i in range(n_calls)]
    torch.cuda.synchronize()
    for i, (side, got) in enumerate(outs):
        for name, g, r in zip(("vals", "src", "valid", "total"), got, calls[side][3]):
            if g.shape != r.shape or not torch.equal(g, r):
                raise AssertionError(f"stream_extract call {i} (box {side}): {name} differs")
    tiles = {s: -(-calls[s][0].numel() // extract.TILE) for s in order}
    print(f"check stream_extract alternating boxes: {n_calls} calls back to back "
          f"({' -> '.join(map(str, order))}, tiles {tiles}), bit-exact every call", flush=True)


def counting_forward(net):
    """An ``AdaptiveForward`` over ``net`` that counts the kernel launches of
    each box's forwards (host side: no call waits for the card), its
    warm-up included."""
    from pasco_torch import kernels
    from pasco_torch.inference.dispatch import AdaptiveForward

    class CountingForward(AdaptiveForward):
        def __init__(self):
            super().__init__(net)
            self.per_box, self.calls = {}, {}

        def __call__(self, inp, box=None):
            box = box if box is not None else self.box_for(inp)
            before = dict(kernels.LAUNCHES)
            out = super().__call__(inp, box)
            acc = self.per_box.setdefault(box, dict.fromkeys(before, 0))
            for k, v in kernels.LAUNCHES.items():
                acc[k] += v - before[k]
            self.calls[box] = self.calls.get(box, 0) + 1
            return out

    return CountingForward()


def bench_phase(cfg, scans, net, label, modes=("adaptive", "fixed")):
    """``scripts_torch/bench.py``'s pipelined protocol on ``bench.py``'s
    scans through :class:`AdaptiveForward` and through the fixed 352 box, in
    turns (``modes``: adaptive, then fixed, by default), after one warm-up
    forward per candidate box.  Prints each scan's box, scans/s and device
    ms per scan of each run, the peak memory and the launches per forward of each box,
    which must reach :func:`forward_launch_floor`.  The counts are set to 0
    just before the warm-up and read after the last run.  Returns
    (results by mode, launches per box, forwards per box)."""
    from pasco_torch import kernels

    bench = _script("bench")
    dev = scans[0][1].point_feats.device
    fwd = counting_forward(net)
    inps = [inp for _, inp in scans]
    boxes = [box_of(cfg, col) for col, _ in scans]
    print(f"{label} boxes: {[b[0] for b in boxes]}", flush=True)
    syncs = bench.host_syncs(lambda: bench.reduced(net(inps[0], box_extent=boxes[0])))
    print(f"{label}: {len(syncs)} host syncs per forward {syncs}", flush=True)
    kernels.reset_launches()
    fwd.warmup(inps[0])
    res = {}
    torch.cuda.reset_peak_memory_stats(dev)
    for mode in modes:
        bx = boxes if mode == "adaptive" else [fwd.cands[-1]] * len(boxes)
        r = bench.measure(fwd, inps, bx, iters=2)
        res.setdefault(mode, []).append(r)
        print(f"{label} {mode}: {r['scans_per_sec']:.4f} scans/s, device "
              f"{statistics.mean(r['device_ms']):.3f} ms/scan "
              f"({', '.join(f'{m:.2f}' for m in r['device_ms'])}), host enqueue "
              f"{r['enqueue_s']:.3f} s of {r['wall_s']:.3f} s", flush=True)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    floor = forward_launch_floor(cfg.model.n_infers)
    per_forward = {b[0]: {k: v / fwd.calls[b] for k, v in fwd.per_box[b].items() if v}
                   for b in sorted(fwd.per_box)}
    print(f"{label}: peak {peak:.3f} GB, launches per forward by box {per_forward} "
          f"(floors {floor}), forwards by box "
          f"{ {b[0]: n for b, n in sorted(fwd.calls.items())} }", flush=True)
    short = {(b[0], k): fwd.per_box[b][k] / fwd.calls[b] for b in fwd.per_box
             for k in floor if fwd.per_box[b][k] < floor[k] * fwd.calls[b]}
    if short:
        raise AssertionError(f"{label}: kernels launched too rarely per forward: {short}")
    for mode, rs in res.items():
        print(f"{label} {mode} (both runs): scans/s {[round(r['scans_per_sec'], 4) for r in rs]}, "
              f"device ms/scan {[round(statistics.mean(r['device_ms']), 3) for r in rs]}",
              flush=True)
    return res, fwd.per_box, fwd.calls


def decoder_runs(net, calls):
    """Each of ``calls`` (a forward of ``net``) under hooks on the decoder
    stages: ``(output, dense)`` per call, ``dense[scale][b]`` the stage's
    ``(sem, top_class, msk)`` of scan ``b`` of the call."""
    runs = []
    for fn in calls:
        dense, hooks = {}, []
        for sc in (1, 2, 4):
            hooks.append(getattr(net, f"dec_s{sc}").register_forward_hook(
                lambda m, a, o, sc=sc: dense.__setitem__(
                    sc, [(o[1][b], o[2][b], o[4][b]) for b in range(o[4].shape[0])])))
        try:
            with torch.no_grad():
                out = fn()
        finally:
            for h in hooks:
                h.remove()
        runs.append((out, dense))
    return runs


def hold_runs(label, got, ref):
    """One scan's ``(output, dense)`` (of :func:`decoder_runs`, ``dense``
    per scale for this scan) against another run's of the same scan, whose
    box may be larger (compared on ``got``'s box, which it must cover): the
    valid cells of every decoder scale identical, the dense semantic logits
    at every valid cell and the query logits within the bf16 bound, the
    kept cells of every scale and subnet identical but where a cell's top
    two logits lie within that bound (printed with the margin).  Where no
    cell flipped, the extraction coords and masks are identical row by row
    at every scale and subnet (a shared box minimum keeps the flat-index
    order)."""
    (out_s, dense_s), (out_b, dense_b) = got, ref
    flips = {}
    for sc in (1, 2, 4):
        sem_s, top_s, msk_s = dense_s[sc]
        sem_b, top_b, msk_b = dense_b[sc]
        X, Z, Y = msk_s.shape
        inner = (slice(0, X), slice(0, Z), slice(0, Y))
        if msk_b.sum() != msk_b[inner].sum():
            raise AssertionError(f"{label}, s{sc}: valid cells outside the smaller box")
        if not torch.equal(msk_s, msk_b[inner]):
            raise AssertionError(f"{label}, s{sc}: the valid cells differ")
        a, b = sem_s.float(), sem_b[inner].float()
        err = (a - b)[msk_s].abs().max().item()
        tol = TOL_REL * b[msk_s].abs().max().item() + TOL_ABS
        keep_s = (top_s != 0) & msk_s[..., None]
        keep_b = (top_b[inner] != 0) & msk_s[..., None]
        flip = keep_s != keep_b
        top2 = b.topk(2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1])[flip]
        flips[sc] = int(flip.sum())
        print(f"check {label}, dec_s{sc}: {int(msk_s.sum())} valid "
              f"cells, sem logits max|d| {err:.4g} (bound {tol:.4g}), kept "
              f"{int(keep_s.sum())} / {int(keep_b.sum())}, {flips[sc]} flipped"
              + (f", margins {[round(v, 4) for v in margin.tolist()[:20]]}" if flips[sc] else ""),
              flush=True)
        if not err <= tol:
            raise AssertionError(f"{label}, dec_s{sc}: sem logits differ: {err} > {tol}")
        if flips[sc] and not margin.max().item() <= tol:
            raise AssertionError(f"{label}, dec_s{sc}: a kept cell flipped at margin "
                                 f"{margin.max().item()} > {tol}")
    q_s, q_b = out_s.predictor.query_logits.float(), out_b.predictor.query_logits.float()
    q_err = (q_s - q_b).abs().max().item()
    q_tol = TOL_REL * q_b.abs().max().item() + TOL_ABS
    print(f"check {label}: query logits max|d| {q_err:.4g} (bound {q_tol:.4g})", flush=True)
    if not q_err <= q_tol:
        raise AssertionError(f"{label}: query logits differ: {q_err} > {q_tol}")
    if not any(flips.values()):
        for which in ("sem_grids", "panop_grids"):
            for sc in (1, 2, 4):
                g, h = getattr(out_s, which)[sc], getattr(out_b, which)[sc]
                if not (torch.equal(g.coords, h.coords) and torch.equal(g.mask, h.mask)):
                    raise AssertionError(f"{label}, {which}[{sc}]: coords or masks differ")
        l_err = (out_s.sem_logits[1].float() - out_b.sem_logits[1].float()).abs().max().item()
        print(f"check {label}: extraction coords and masks identical at every scale and "
              f"subnet; extracted s1 logits max|d| {l_err:.4g}", flush=True)
    return flips


def two_boxes_check(cfg, net, scan, small):
    """One scan through the ``small`` box that covers it and through the
    largest, held by :func:`hold_runs`."""
    from pasco_torch.inference.dispatch import candidate_boxes

    _, inp = scan
    big = candidate_boxes(cfg)[-1]
    (out_s, dense_s), (out_b, dense_b) = decoder_runs(
        net, [lambda: net(inp, box_extent=small), lambda: net(inp, box_extent=big)])
    hold_runs(f"box {small[0]} against {big[0]}",
              (out_s, {sc: d[0] for sc, d in dense_s.items()}),
              (out_b, {sc: d[0] for sc, d in dense_b.items()}))


BATCH_CHECK = 2            # scans per batch in the batched kernel and forward checks
BATCH_BENCH = (1, 2, 4)    # batch sizes of the batched bench protocol


def batch_of(scans):
    """The first :data:`BATCH_CHECK` scans' inputs, which must have distinct
    box corners (``global_min``): a scan read at another scan's corner must
    show."""
    inps = [inp for _, inp in scans[:BATCH_CHECK]]
    mins = [tuple(i.global_min.tolist()) for i in inps]
    if len(set(mins)) != len(inps):
        raise AssertionError(f"the batch's scans share a box corner: {mins}")
    return inps


def _batched_case(name, label, batched, singles, ref, mask, region=None):
    """A batched launch against its per-scan launches (bit for bit: each
    scan's tiles are computed as a launch of that scan alone computes them)
    and against the plain version (the bound of :func:`_compare`).  Returns
    (max|d| against the plain version, the bound)."""
    for b, one in enumerate(singles):
        if not torch.equal(batched[b], one):
            d = (batched[b].float() - one.float()).abs().max().item()
            raise AssertionError(f"{name} {label}: scan {b} of the batched launch differs from "
                                 f"its own launch (max|d| {d})")
    print(f"check {name} {label}: the batched launch equals the {len(singles)} per-scan "
          f"launches bit for bit", flush=True)
    return _compare(f"{name} {label}, batched", batched, ref, mask, region)


def _batch_times(name, label, shape, batched_fn, singles_fn, plain_fn, library_fn, flop,
                 nbytes_, launches_key, kernel):
    """Timing fields of one batched case: the batched launch (``ms``), the
    per-scan launches it replaces (``per_scan_ms``, all of them), the plain
    version on the batch and one library call at N = B (2 repetitions
    each: the batch doubles their time), and the bound; then the device
    time of the batched launch's kernel (``kernel_device_ms``) and of the
    per-scan launches' kernels together (``per_scan_device_ms``), from the
    profiler."""
    from pasco_torch import kernels

    before = kernels.LAUNCHES[launches_key]
    batched_fn()
    if kernels.LAUNCHES[launches_key] != before + 1:
        raise AssertionError(f"{name} {label}: the batch is not one launch")
    t = timing_fields(time_ms(batched_fn), time_ms(plain_fn, reps=2),
                      time_ms(library_fn, reps=2), flop, nbytes_)
    t["per_scan_ms"] = time_ms(singles_fn)
    t.update(device_fields(batched_fn, kernel))
    t["per_scan_device_ms"] = device_ms(profile_call(singles_fn), kernel)
    _report(name, label, tuple(shape), t,
            f"one launch for the batch, the per-scan launches {t['per_scan_ms']:.3f} ms; "
            f"device: the batched kernel {t['kernel_device_ms']:.4f} ms, the per-scan kernels "
            f"{t['per_scan_device_ms']:.4f} ms")
    return t


def batch_kernel_phase(cfg, scans, gen):
    """Rows 1-3 on a batch of two of ``bench.py``'s scans (distinct box
    corners), on their real masks at 352: ``masked_conv3`` at s1 (the scans'
    occupancy and the near-dense decoder mask), ``down2_fused`` at enc_s2,
    ``up_preamble`` at dec_s1 near dense, each in one launch for the batch,
    equal bit for bit to the per-scan launches and held against its plain
    version.  ``up_preamble`` is also run on the "coords" set of
    :func:`up_phase` with each scan's own box corner (a generated child of
    each scan at its origin, two different children), where a plain run
    with the two corners swapped must break the bound.  The main case of
    each row is timed against its per-scan launches.  Returns the JSON
    rows."""
    from pasco_torch.core.sparse import Box
    from pasco_torch.ops import conv, deconv, down
    from pasco_torch.ops.dense_ops import cell_coords, maxpool2_mask, upsample2_mask

    inps = batch_of(scans)
    dev = inps[0].point_feats.device
    mins = torch.stack([i.global_min for i in inps])
    _, occs, bboxes = zip(*(scan_masks(cfg, i) for i in inps))
    occ, bbox = torch.stack(occs), torch.stack(bboxes)
    box = Box.create(mins, cfg.scene.box_extent)
    randn, vec, masked = _rand_fns(gen, dev)
    B, fm, rows = len(inps), cfg.model.f_maps, []
    print(f"-- batched kernels, B={B}, box corners {mins.tolist()}", flush=True)

    # row 1: the res-block conv2 form at s1
    c = fm[0]
    main = None
    for label, m in (("s1 scan occupancy", occ), ("s1 decoder, near dense", bbox)):
        x, skip = masked(randn(*m.shape, c), m), masked(randn(*m.shape, c), m)
        w = randn(27, c, c, scale=(27 * c) ** -0.5)
        kw = dict(bias=vec(c), affine=(vec(c, 0.5, 1.5), vec(c)), relu_in=True, relu_out=True)
        tiles = conv.conv_tiles(m)
        one = [conv.conv_tiles(m[b]) for b in range(B)]
        got = conv.masked_conv3(x, m, w, skip=skip, tiles=tiles, **kw)
        singles = [conv.masked_conv3(x[b], m[b], w, skip=skip[b], tiles=one[b], **kw)
                   for b in range(B)]
        err = _batched_case("masked_conv3", label, got, singles,
                            conv.masked_conv3_plain(x, m, w, skip=skip, **kw), m)[0]
        del singles
        if label != "s1 decoder, near dense":
            continue
        xp = masked(torch.relu(kw["affine"][0] * x.float() + kw["affine"][1]).to(x.dtype), m)
        n_valid = int(m.sum())
        main = _batch_times(
            "masked_conv3", label, (*m.shape, c),
            lambda: conv.masked_conv3(x, m, w, skip=skip, tiles=tiles, **kw),
            lambda: [conv.masked_conv3(x[b], m[b], w, skip=skip[b], tiles=one[b], **kw)
                     for b in range(B)],
            lambda: conv.masked_conv3_plain(x, m, w, skip=skip, **kw),
            conv3d_library(xp, w), n_valid * 27 * c * c * 2,
            rows_bytes(x, n_valid) + rows_bytes(skip, n_valid)
            + nbytes(m, w, got, kw["bias"], *kw["affine"]), "masked_conv3",
            "masked_conv3_kernel")
        rows.append(dict(name=f"masked_conv3 (batch {B})", source="pasco_torch/csrc/masked_conv3.cu",
                         replaces="pasco_tpu/ops/pallas_conv.py:1159", max_abs_err=err,
                         case=label, kernel="masked_conv3", **main))
        del x, skip, got, xp

    # row 2: enc_s2 on the scans' occupancy
    ci, co = fm[0], fm[1]
    m2 = maxpool2_mask(occ)
    x = masked(randn(*occ.shape, ci), occ)
    args = (x, occ, m2, randn(8, ci, co, scale=(8 * ci) ** -0.5), vec(co),
            (vec(co, 0.5, 1.5), vec(co)), (vec(co, 0.5, 1.5), vec(co)))
    tiles, one = down.down_tiles(m2), [down.down_tiles(m2[b]) for b in range(B)]

    def per_scan_down():
        return [down.down2_fused(x[b], occ[b], m2[b], *args[3:], tiles=one[b]) for b in range(B)]

    got = down.down2_fused(*args, tiles=tiles)
    err = _batched_case("down2_fused", "enc_s2 scan occupancy", got, per_scan_down(),
                        down.down2_fused_plain(*args), m2)[0]
    wl = args[3].reshape(2, 2, 2, ci, co).permute(4, 3, 0, 2, 1).contiguous(
        memory_format=torch.channels_last_3d)
    xl = x.permute(0, 4, 1, 2, 3)
    n_valid = int(m2.sum())
    t = _batch_times("down2_fused", "enc_s2 scan occupancy", (*occ.shape, ci, co),
                     lambda: down.down2_fused(*args, tiles=tiles), per_scan_down,
                     lambda: down.down2_fused_plain(*args),
                     lambda: F.conv3d(xl, wl, stride=2), n_valid * 8 * ci * co * 2,
                     rows_bytes(x, occ.sum()) + nbytes(occ, m2, args[3], got, args[4],
                                                       *args[5], *args[6]), "down2_fused",
                     "down2_kernel")
    rows.append(dict(name=f"down2_fused (batch {B})", source="pasco_torch/csrc/down2_fused.cu",
                     replaces="pasco_tpu/ops/pallas_down.py:244", max_abs_err=err,
                     case="enc_s2 scan occupancy", kernel="down2_fused", **t))
    del x, args, got, xl

    # row 3: dec_s1 near dense, each scan at its own box corner
    sc, ci, co = 1, fm[1], fm[0]
    pkeep = maxpool2_mask(bbox)
    child = upsample2_mask(pkeep) & bbox
    union = child | occ
    parent = randn(*pkeep.shape, ci)
    skip = masked(randn(*child.shape, co), occ)
    bd, br = vec(co), vec(co)
    bn = ((vec(co, 0.5, 1.5), vec(co)), (vec(co + 3, 0.5, 1.5), vec(co + 3)))
    wd = randn(8, ci, co, scale=(8 * ci) ** -0.5)
    wd_d = randn(8, ci, co, scale=ci ** -0.5)
    wr_c = randn(co + 3, co, scale=co ** -0.5)
    wr_c[co:] = randn(3, co)
    tiles, one = deconv.up_tiles(union), [deconv.up_tiles(union[b]) for b in range(B)]

    def up_args(skip_, wd_, wr_, box_, b=None):
        sel = (lambda t: t) if b is None else (lambda t: t[b])
        bx = box_ if b is None else Box(box_.minimum[b], box_.extent)
        return (sel(parent), sel(pkeep), sel(child), sel(union), sel(skip_), bx, sc, wd_, bd,
                *bn, wr_, br)

    def per_scan_up(skip_, wd_, wr_, box_):
        return [deconv.up_preamble(*up_args(skip_, wd_, wr_, box_, b), tiles=one[b])
                for b in range(B)]

    label = "dec_s1 near dense"
    sets = [("coords + skip", (skip, wd, randn(co + 3, co, scale=0.1), box))]
    # "coords": scan b's box corner puts one of its generated children (a
    # different one per scan) at the origin; checked where |u| <= 2
    corners = []
    for b in range(B):
        cells = child[b].nonzero()
        corners.append(-sc * cells[(b + 1) * len(cells) // (B + 1)][[0, 2, 1]])
    box_c = Box.create(torch.stack(corners), box.extent)
    near = (cell_coords(box_c, sc).abs() <= 2 * sc).all(-1)
    sets.append(("coords", (skip * 0.01, wd_d * 0.01, wr_c, box_c)))
    errs, refs, tols = [], {}, {}
    for vlabel, (sk, wd_, wr_, bx) in sets:
        region = near if vlabel == "coords" else None
        got = deconv.up_preamble(*up_args(sk, wd_, wr_, bx), tiles=tiles)
        refs[vlabel] = deconv.up_preamble_plain(*up_args(sk, wd_, wr_, bx))
        err, tols[vlabel] = _batched_case(
            "up_preamble", f"{label}, {vlabel}" + ("" if region is None else " (|u| <= 2)"),
            got, per_scan_up(sk, wd_, wr_, bx), refs[vlabel], union, region)
        errs.append(err)
    swapped = Box.create(box_c.minimum.flip(0), box.extent)
    bad = deconv.up_preamble_plain(*up_args(skip * 0.01, wd_d * 0.01, wr_c, swapped))
    miss = (bad.float() - refs["coords"].float())[union & near].abs().max().item()
    print(f"check up_preamble {label} per-scan box corners, the corners swapped: max|d| "
          f"{miss:.4g} > bound {tols['coords']:.4g}", flush=True)
    if not miss > tols["coords"]:
        raise AssertionError(f"up_preamble batched check cannot see a scan read at another "
                             f"scan's box corner ({miss} <= {tols['coords']})")
    del refs, bad
    a_main = up_args(*sets[0][1])
    got = deconv.up_preamble(*a_main, tiles=tiles)
    pl = masked(parent, pkeep).permute(0, 4, 1, 2, 3)
    wtl = wd.reshape(2, 2, 2, ci, co).permute(3, 4, 0, 2, 1).contiguous(
        memory_format=torch.channels_last_3d)
    n_child = int(child.sum())
    t = _batch_times("up_preamble", label, (*child.shape, ci, co),
                     lambda: deconv.up_preamble(*a_main, tiles=tiles),
                     lambda: per_scan_up(*sets[0][1]),
                     lambda: deconv.up_preamble_plain(*a_main),
                     lambda: F.conv_transpose3d(pl, wtl, stride=2),
                     n_child * (ci + co + 3) * co * 2,
                     rows_bytes(parent, pkeep.sum()) + rows_bytes(skip, union.sum())
                     + nbytes(pkeep, child, union, got, wd, a_main[-2]), "up_preamble",
                     "up_preamble_kernel")
    rows.append(dict(name=f"up_preamble (batch {B})", source="pasco_torch/csrc/up_preamble.cu",
                     replaces="pasco_tpu/ops/pallas_deconv.py:306", max_abs_err=max(errs),
                     case=label, kernel="up_preamble", **t))
    return rows


def batch_forward_check(cfg, net, scans):
    """The forward of a batch of two of ``bench.py``'s scans (distinct box
    corners) at the fixed 352 box against each scan's own forward, by
    :func:`hold_runs`: the valid cells identical, the kept cells identical
    but at bf16 near-ties of the argmax, the logits within the bf16 bound
    (cuDNN may pick another algorithm for the bottleneck at N = 2), and
    the extraction coords identical where no cell flipped."""
    from pasco_torch.models.unet import scan_output, stack_inputs

    inps = batch_of(scans)
    runs = decoder_runs(net, [lambda: net(stack_inputs(inps))]
                        + [lambda i=i: net(i) for i in inps])
    (out_b, dense_b), singles = runs[0], runs[1:]
    for b, (out_1, dense_1) in enumerate(singles):
        hold_runs(f"batch of {len(inps)}, scan {b}, against its own forward",
                  (scan_output(out_b, b), {sc: d[b] for sc, d in dense_b.items()}),
                  (out_1, {sc: d[0] for sc, d in dense_1.items()}))


def batch_bench_phase(cfg, net, cols):
    """``scripts_torch/bench.py``'s batched protocol (``BENCH_BATCH``) on the
    reference's batch scans at each of :data:`BATCH_BENCH`, B = 1 being the
    same protocol on one scan at the same fixed box: scans/s, device ms per
    batch, peak memory and host syncs (0) each.  Then one B = 4 forward
    with the launch counts set to 0 just before it: rows 1-3 once per
    forward each, as at B = 1, and ``stream_extract`` once per scan.
    Returns those counts."""
    from pasco_torch import kernels
    from pasco_torch.models.unet import scene_to_model_input, stack_inputs

    bench = _script("bench")
    dev = next(net.parameters()).device
    inps = [scene_to_model_input(c, dev) for c in cols]
    res = {}
    for B in BATCH_BENCH:
        binp = stack_inputs(inps[:B])
        res[B] = bench.run_batch(net, binp)
        print(bench.batch_line(res[B], B, cfg.scene.box_extent), flush=True)
        if res[B]["syncs"]:
            raise AssertionError(f"batched forward B={B}: host syncs {res[B]['syncs']}")
    base = res[1]["scans_per_sec"]
    print("batched protocol: scans/s by B " + ", ".join(
        f"{B}: {r['scans_per_sec']:.4f} ({r['scans_per_sec'] / base:.3f}x B=1)"
        for B, r in res.items()), flush=True)
    B = BATCH_BENCH[-1]
    kernels.reset_launches()
    with torch.no_grad():
        bench.reduced(net(binp)).item()
    launches = dict(kernels.LAUNCHES)
    want = {k: v * (B if k == "stream_extract" else 1)
            for k, v in forward_launch_floor(1).items()}
    print(f"batched forward B={B}: launches {launches} (expected {want})", flush=True)
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"batched forward B={B}: launches {launches}, expected {want}")
    return launches


def write_fake_val_scan(root):
    """The fake val scan of ``tests/test_eval_script.py`` (seq 08, frame
    000000: a 16x16x8 voxel blob and 400 points in it) under ``root``."""
    import importlib.util

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "fake_val_scan", os.path.join(here, "tests", "test_eval_script.py"))
    fake = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fake)
    fake._write_fake_val_scan(root)


def start_eval_cli(tmp, in_channels=8, preprocess_root=""):
    """``scripts_torch/eval.py`` on the card in a subprocess on the fake val
    scan under ``tmp`` (:func:`write_fake_val_scan`), its point features
    read from ``preprocess_root``'s WaffleIron pickles where one is given:
    the ``flagship_narrow`` preset (full widths) and a released-format
    ``--torch_ckpt`` from ``synthetic_reference_state_dict`` at those
    widths and ``in_channels`` input features.  Returns the process and its
    output files for :func:`finish_eval_cli`."""
    from pasco_torch.inference.evaluate import eval_config
    from pasco_torch.training.convert_torch import synthetic_reference_state_dict

    here = os.path.dirname(os.path.abspath(__file__))
    m = eval_config("flagship_narrow", 1).model
    sd = synthetic_reference_state_dict(
        np.random.RandomState(3), n_infers=1, f=m.f, n_classes=m.n_classes,
        in_channels=in_channels, hidden_dim=m.transformer.hidden_dim,
        num_queries=m.transformer.num_queries, dim_feedforward=m.transformer.dim_feedforward)
    ckpt = os.path.join(tmp, "pasco_single.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}},
               ckpt)
    logs = [tempfile.TemporaryFile("w+") for _ in range(2)]    # no pipe to fill unread
    proc = subprocess.Popen(
        [sys.executable, os.path.join(here, "scripts_torch", "eval.py"), "--dataset_root", tmp,
         "--dataset_preprocess_root", preprocess_root, "--torch_ckpt", ckpt, "--n_infers", "1",
         "--limit_batches", "1", "--config", "flagship_narrow"],
        stdout=logs[0], stderr=logs[1], text=True)
    return proc, logs


def finish_eval_cli(proc, logs):
    """Wait for :func:`start_eval_cli`'s process; it must exit 0 and print
    every table."""
    out, err = _wait_logged(proc, logs)
    print(out, flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"scripts_torch/eval.py exit {proc.returncode}: {err[-2000:]}")
    for want in ("mIoU", "Prec", "PQ", "ins ECE", "ssc ECE ne", "inference time:",
                 "ensemble time:", "subnet 0", "ensemble", "per-class PQ"):
        if want not in out:
            raise AssertionError(f"scripts_torch/eval.py printed no {want!r}")
    print("eval CLI (flagship_narrow, --torch_ckpt, on the card): every table printed",
          flush=True)


def _to_cpu(obj):
    """``obj`` (tensors in dicts, named tuples, lists) with every tensor
    copied to the host."""
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_cpu(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def start_scene_inference(pool, tmp, cfg, forward_fn, scan, name):
    """``run_scene_inference`` on one scan, split where the card's part
    ends: here the forward (``forward_fn(inp)``, timed to a synchronise),
    whose output is copied to the host and saved under ``tmp``; in a
    worker process of ``pool`` the rest, the MIMO ensembling and panoptic
    assembly on the host (``run_scene_inference`` with that output as its
    forward) and the ``Evaluator`` (:func:`scene_inference_lines`), so
    that this host work overlaps the card phases that follow.  Only what
    ``run_scene_inference`` reads is saved: scale 1's grids and logits and
    the predictor's last layer (not its auxiliary layers).  Returns the
    worker's future."""
    col, inp = scan
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = forward_fn(inp)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    out = out._replace(sem_grids={1: out.sem_grids[1]}, sem_logits={1: out.sem_logits[1]},
                       panop_grids={1: out.panop_grids[1]},
                       predictor=out.predictor._replace(aux=[]))
    path = os.path.join(tmp, f"scene_inference_{name}.pt")
    torch.save((cfg, col, _to_cpu(out)), path)
    return pool.submit(scene_inference_lines, path, forward_s)


def scene_inference_lines(path, forward_s):
    """The host part of :func:`start_scene_inference` on the saved ``(cfg,
    scan, forward output)`` at ``path``: ``run_scene_inference`` (S + 1
    outputs: the subnets, then the ensemble) and the ``Evaluator``
    against the scan's labels, whose numbers must be finite (at random
    init they mean nothing), at the lowest priority, so that it takes the
    cores the card's phases leave idle.  Returns the lines to print."""
    from pasco_torch.inference.pipeline import Evaluator, run_scene_inference
    from pasco_torch.models.unet import scene_to_model_input

    os.nice(19)
    torch.set_num_threads(1)
    cfg, col, out = torch.load(path, weights_only=False)
    S = cfg.model.n_infers
    res = run_scene_inference(lambda _inp: out, scene_to_model_input(col, "cpu"), col, cfg)
    n_seg = [len(o["segments_info"]) for o in res["outputs"]]
    lines = [f"run_scene_inference (n_infers={S}): {len(n_seg)} outputs, {n_seg} panoptic "
             f"segments, forward {forward_s:.3f} s (on the card), ensemble "
             f"{res['ensemble_time']:.3f} s (in a worker at nice 19, beside the card's "
             f"phases)"]
    if len(res["outputs"]) != S + 1:
        raise AssertionError(f"run_scene_inference: {len(res['outputs'])} outputs at S={S}")
    ev = Evaluator(cfg)
    t0 = time.perf_counter()
    ev.add_scene(res, col.semantic_label_origin, col.instance_label_origin)
    summary = ev.summary()
    names = [f"subnet {i}" for i in range(S)] + ["ensemble"]
    for name, s in zip(names, summary):
        vals = {"PQ": s["pq_all"]["pq"], "SSC mIoU": s["ssc"]["iou_ssc_mean"],
                "ECE": s["ssc"]["nonempty_ece"], "instance ECE": s["uncertainty"]["ins_ece"]}
        lines.append(f"evaluator {name} (n_infers={S}): "
                     + ", ".join(f"{k} {v:.6g}" for k, v in vals.items()))
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"evaluator {name}: non-finite summary {vals}")
    lines.append(f"evaluator (n_infers={S}): {time.perf_counter() - t0:.3f} s for "
                 f"{len(summary)} outputs")
    return lines


# ---------------------------------------------------------------------------
# data parallelism on the one card, and the KITTI-360 preset
# ---------------------------------------------------------------------------


def _card_settings():
    """The numerics every process of this run uses: no TF32 outside the
    kernels that ask for it."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _cut_all_reduce_sum(t, group):
    """The BatchNorm reduction of a plain ``dist.all_reduce``: the sum over
    the ranks forward, this rank's own cotangent backward (the other
    ranks' losses no longer reach the statistics' gradient)."""
    import torch.distributed as dist

    total = t.detach().clone()
    dist.all_reduce(total, group=group)
    return t + (total - t.detach())


def _step_record(state, logs, n):
    """What a train step left, on the card: the logs, the mean gradient
    (``.grad / n``), the parameters and the running statistics."""
    from pasco_torch.models.norm import BatchNorm

    params = dict(state.net.named_parameters())
    return {"logs": {k: float(v) for k, v in logs.items()},
            "grads": {k: (p.grad / n).float() for k, p in params.items() if p.grad is not None},
            "params": {k: p.detach().float().clone() for k, p in params.items()},
            "stats": {f"{k}.{b}": getattr(m, b).float().clone()
                      for k, m in state.net.named_modules() if isinstance(m, BatchNorm)
                      for b in ("mean", "var")}}


def _fresh_states(cfg, dev):
    """A function that returns a fresh ``loop.new_train_state(cfg, dev,
    seed=0)``: the seeded init is built once (its draws take seconds at
    full width) and each call deep-copies it."""
    import copy

    from pasco_torch.training import loop

    state0 = loop.new_train_state(cfg, dev, seed=0)
    return lambda: copy.deepcopy(state0)


def _single_card_steps(cfg, col, dev, fresh, n=2):
    """``n`` single-card ``train_step``s from the seeded init (``fresh()``,
    :func:`_fresh_states`) on ``col`` (no group; the repeats show the
    card's run-to-run noise); their records and host-clock times."""
    from pasco_torch.models.unet import scene_to_model_input
    from pasco_torch.training import loop
    from pasco_torch.training import step as tstep

    lw, cw = loop.loss_weights(cfg, None, dev)
    inp, tgt = scene_to_model_input(col, dev), tstep.targets_to_device(col.targets, dev)
    recs = []
    for _ in range(n):
        state = fresh()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logs = tstep.train_step(state, inp, tgt, lw, cw, loop.train_config(cfg), seed=0)
        torch.cuda.synchronize(dev)
        recs.append(dict(_step_record(state, logs, 1), step_s=time.perf_counter() - t0))
        del state, logs
    return recs


def _accumulated_step(cfg, cols, dev, fresh):
    """One single-card step on the mean gradient of ``cols``: ``grad_step``
    on each (every one drawing from ``step_generator(0, 0)``, the shared
    draws of ``fold_axis_rng=False``), then ``apply_grads(state,
    len(cols))``, from the seeded init (``fresh()``); its record (the logs' mean and
    ``grad_norm``, the mean gradient, the parameters), and under ``first``
    the gradient of ``cols[0]`` alone."""
    from pasco_torch.models.unet import scene_to_model_input
    from pasco_torch.training import loop
    from pasco_torch.training import step as tstep

    lw, cw = loop.loss_weights(cfg, None, dev)
    state = fresh()
    tstep.zero_grads(state)
    logs, first = [], None
    for c in cols:
        logs.append(tstep.grad_step(state, scene_to_model_input(c, dev),
                                    tstep.targets_to_device(c.targets, dev), lw, cw,
                                    loop.train_config(cfg), tstep.step_generator(0, 0, dev)))
        if first is None:
            first = {k: torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                     else p.grad.float().clone() for k, p in state.net.named_parameters()}
    mean = {k: sum(lg[k].float() for lg in logs) * (1.0 / len(cols)) for k in logs[0]}
    mean["grad_norm"] = tstep.apply_grads(state, len(cols))
    return dict(_step_record(state, mean, len(cols)), first=first)


def _noise_rel(ref, rep):
    """The relative term of the bounds of :func:`_held`: 0.05
    (``narrow_step_check``'s) where the repeat of the single-card step
    differs from it anywhere (kernels that are not deterministic), else
    1e-5, the f32 rounding of a reduction that adds in another order: far
    below what a missing or wrong reduction moves."""
    same = ref["logs"] == rep["logs"] and all(
        torch.equal(rep[part][k], v) for part in ("grads", "params", "stats")
        for k, v in ref[part].items())
    return 1e-5 if same else 0.05


def _held(label, got, ref, rep, rel):
    """``got`` against the single-card step ``ref``, whose repeat ``rep``
    shows the card's run-to-run noise: per tensor, ``|got - ref| <= 1.5 *
    |rep - ref| + rel * |ref|`` in norm (``narrow_step_check``'s rule with
    the repeat in place of the plain step, ``rel`` from
    :func:`_noise_rel`), and the median over tensors of the left side at
    most the right side's.  Prints the max|d| beside the repeat's; returns
    the names over their bound."""
    over, err, noise, worst, rep_max = [], [], [], 0.0, 0.0
    for k, r in ref.items():
        e = (got[k] - r).norm().item()
        n = 1.5 * (rep[k] - r).norm().item() + rel * r.norm().item()
        worst = max(worst, (got[k] - r).abs().max().item())
        rep_max = max(rep_max, (rep[k] - r).abs().max().item())
        err.append(e)
        noise.append(n)
        if e > n:
            over.append(k)
    if statistics.median(err) > statistics.median(noise):
        over.append("<median>")
    print(f"  {label}: max|d| {worst:.6g} (the repeat's: {rep_max:.6g}); "
          f"{len(over)} of {len(ref)} over 1.5 * |repeat - ref| + {rel:g} * |ref|", flush=True)
    return over


def _hold_step(label, got, ref, rep, rel, parts=("grads", "params", "stats")):
    """Every check of a step record against the single-card step's: each
    loss term within ``rel * (|ref| + 1)`` (``narrow_step_check``'s
    ``5e-2 * |ref| + 5e-2`` at ``rel`` 0.05), and ``parts`` by
    :func:`_held`.  Returns the names over their bound."""
    over = []
    for k, v in ref["logs"].items():
        d, bound = abs(got["logs"][k] - v), rel * (abs(v) + 1)
        if k in ("total_loss", "grad_norm"):
            print(f"  {label} {k}: {got['logs'][k]:.9g} vs {v:.9g} (|d| {d:.3g}, repeat "
                  f"|d| {abs(rep['logs'][k] - v):.3g}, bound {bound:.3g})", flush=True)
        if d > bound:
            over.append(k)
    for part in parts:
        over += _held(f"{label} {part}", got[part], ref[part], rep[part], rel)
    return over


def dp_rank(rank, world, cfg, scenes_path):
    """One rank of :func:`dp_phase` at ``cfg`` on ``cuda:0`` (gloo), from the
    pickled ``(copy_scene, scenes)`` at ``scenes_path``: three
    data-parallel steps, each from the seeded init (replicated from rank 0
    before the first): on its copy of ``copy_scene`` with SyncBN and shared
    draws, first with the cut BatchNorm reduction
    (:func:`_cut_all_reduce_sum`; the process's first step, which also
    warms it up), then with the package's; then without SyncBN on its own
    scene of ``scenes`` (one per rank, shared draws); then
    ``dp_eval_step`` of ``scenes``, one per rank.  Rank 0 then holds,
    alone, the copies' step against two single-card ``train_step``s
    (:func:`_hold_step`; the cut step must miss the gradients' bound),
    the distinct scenes' step against their accumulation on one card
    (:func:`_accumulated_step`: without the gradient's reduction each rank
    would keep its own scene's), and each scene's counts taken alone.
    Returns the times, the peak memory, the launches of the package's
    SyncBN step, the counts, the parameters' sums (to hold the ranks
    against each other) and rank 0's verdicts."""
    import pickle

    import torch.distributed as dist

    from pasco_torch import kernels
    from pasco_torch.models import norm
    from pasco_torch.models.unet import build_net, scene_to_model_input
    from pasco_torch.parallel import mesh
    from pasco_torch.training import loop

    t_rank = time.perf_counter()
    _card_settings()
    dev = torch.device("cuda", 0)
    with open(scenes_path, "rb") as fh:
        copy_scene, scenes = pickle.load(fh)
    group = dist.group.WORLD
    lw, cw = loop.loss_weights(cfg, None, dev)
    out, recs = {}, {}
    t0 = time.perf_counter()
    fresh = _fresh_states(cfg, dev)
    torch.cuda.synchronize(dev)
    out["build_s"] = time.perf_counter() - t0
    held = torch.cuda.memory_allocated(dev)     # the pristine state: not the step's
    for name in ("cut", "dp", "distinct"):
        state = fresh()
        if name == "cut":
            t0 = time.perf_counter()
            mesh.replicate_to_group(state, group)
            torch.cuda.synchronize(dev)
            out["replicate_s"] = time.perf_counter() - t0
        if name != "distinct":
            norm.set_process_group(state.net, group)
        mine = mesh.shard_scenes(scenes, rank, world) if name == "distinct" else [copy_scene]
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        saved = norm.all_reduce_sum
        norm.all_reduce_sum = _cut_all_reduce_sum if name == "cut" else saved
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        try:
            logs = mesh.dp_train_step(state, mine, 0, group=group, labelweights=lw,
                                      class_weight=cw, cfg=loop.train_config(cfg),
                                      fold_axis_rng=False)
            torch.cuda.synchronize(dev)
        finally:
            norm.all_reduce_sum = saved
        out[name] = dict(step_s=time.perf_counter() - t0, launches=dict(kernels.LAUNCHES),
                         peak_gb=(torch.cuda.max_memory_allocated(dev) - held) / 1e9)
        recs[name] = _step_record(state, logs, world)
        out[name]["sums"] = torch.stack([p.double().sum() for p in
                                         recs[name]["params"].values()]).cpu()
        del state
    net = build_net(loop.train_config(cfg), dev)
    net.reset_parameters(torch.Generator().manual_seed(0))
    C = cfg.model.n_classes
    t0 = time.perf_counter()
    out["eval"] = torch.stack(mesh.dp_eval_step(
        net, mesh.shard_scenes(scenes, rank, world), group=group, n_classes=C)).cpu()
    out["eval_s"] = time.perf_counter() - t0
    out["wall_s"] = time.perf_counter() - t_rank
    if rank:
        return out
    with torch.no_grad():
        alone = []
        for sc in scenes:
            inp = scene_to_model_input(sc, dev)
            gt = torch.as_tensor(sc.targets.semantic_dense[0]).to(dev)
            alone.append(torch.stack(mesh.ssc_counts_from_output(
                net(inp), gt, inp.subnet_min[0], C)).cpu())
    out["alone"] = alone
    del net
    torch.cuda.empty_cache()
    ref, rep = _single_card_steps(cfg, copy_scene, dev, fresh)
    out["single_s"] = [ref["step_s"], rep["step_s"]]
    rel = out["rel"] = _noise_rel(ref, rep)
    out["over"] = _hold_step(f"dp ({world} ranks, gloo)", recs["dp"], ref, rep, rel)
    out["cut_over"] = _held("dp with the cut BatchNorm reduction: grads",
                            recs["cut"]["grads"], ref["grads"], rep["grads"], 0.05)
    grad_norm = {k: r["logs"]["grad_norm"] for k, r in
                 (("single", ref), ("dp", recs["dp"]), ("cut", recs["cut"]))}
    del ref, rep
    acc = _accumulated_step(cfg, scenes, dev, fresh)
    # the running statistics are left out: the ranks average their own
    # (as the reference's pmean), where accumulation folds one scene's in
    # after the other's
    out["distinct_over"] = _hold_step(
        f"dp ({world} ranks, gloo, no SyncBN) on {world} scenes vs their accumulation",
        recs["distinct"], acc, acc, rel, parts=("grads", "params"))
    # the gradient's reduction is seen: rank 0's own scene's gradient,
    # which it would keep without it, misses the mean even at 0.05
    out["own_over"] = _held("dp without the gradient's reduction (rank 0's own scene): grads",
                            acc["first"], acc["grads"], acc["grads"], 0.05)
    grad_norm["distinct"], grad_norm["accumulated"] = (
        recs["distinct"]["logs"]["grad_norm"], acc["logs"]["grad_norm"])
    out["grad_norm"] = grad_norm
    out["checks_s"] = time.perf_counter() - t_rank - out["wall_s"]
    return out


def dp_phase(dev, train_cols, lap):
    """Data parallelism at the flagship's full width (``PaSCoConfig()``,
    f = 64, n_infers 1, the 256x256x32 train box) on the one card:

    1. two ranks on ``cuda:0`` over gloo (NCCL refuses two ranks on one
       device), a file rendezvous (:func:`~pasco_torch.parallel.mesh.
       spawn_ranks`), :func:`dp_rank`; this process holds no net while
       they run.  On two copies of the first train scene with shared draws
       and SyncBN, one ``dp_train_step`` must give the single-card step's
       logs, ``grad_norm``, gradients, parameters and running statistics
       (:func:`_hold_step`; bit-identical where the kernels are
       deterministic: the bound's relative term is then 1e-5,
       :func:`_noise_rel`), both ranks the same parameters; with the cut
       BatchNorm reduction the same step must miss the gradients' bound
       (the statistics' gradient path is live); on the two train scenes,
       one per rank, without SyncBN, the step must give the mean gradient
       and update of their accumulation on one card, which rank 0's own
       scene's gradient must miss (the gradients' reduction is live);
       ``dp_eval_step`` on the same two scenes must give the sum of each
       scene's counts taken alone;
    2. a one-rank NCCL group in this process: one ``dp_train_step`` with
       SyncBN over it against a single-card ``train_step`` (the same rules,
       the step itself as its repeat), then the group destroyed.

    Prints each step's time and peak memory per rank against the
    single-card step's.  Returns rank 0's launches of its SyncBN step."""
    import pickle

    import torch.distributed as dist

    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.models import norm
    from pasco_torch.parallel import mesh
    from pasco_torch.training import loop

    cfg = PaSCoConfig()
    col = train_cols[0]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        path = os.path.join(tmp, "scenes.pkl")
        with open(path, "wb") as fh:
            pickle.dump((col, train_cols[:DP_WORLD]), fh, protocol=pickle.HIGHEST_PROTOCOL)
        t0 = time.perf_counter()
        ranks = mesh.spawn_ranks(dp_rank, DP_WORLD, cfg, path)
        spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks:
        print(f"dp rank: cut step {r['cut']['step_s']:.3f} s (the rank's first), step "
              f"{r['dp']['step_s']:.3f} s, peak {r['dp']['peak_gb']:.3f} GB; step without "
              f"SyncBN on its own scene {r['distinct']['step_s']:.3f} s, peak "
              f"{r['distinct']['peak_gb']:.3f} GB; eval {r['eval_s']:.3f} s; launches "
              f"{r['dp']['launches']}", flush=True)
    print(f"dp: single-card step {r0['single_s'][0]:.3f} / {r0['single_s'][1]:.3f} s (rank 0, "
          f"alone); grad_norm {r0['grad_norm']}", flush=True)
    print(f"dp: {spawn_s:.1f} s from spawning the ranks to their end; rank 0 "
          f"{r0['wall_s']:.1f} s in its function before its checks (the seeded state's build "
          f"{r0['build_s']:.1f} s, the replication {r0['replicate_s']:.2f} s), then "
          f"{r0['checks_s']:.1f} s of checks alone (the counts alone, 3 single-card steps, "
          f"the comparisons)", flush=True)
    if not all(torch.equal(r[k]["sums"], r0[k]["sums"]) for r in ranks
               for k in ("cut", "dp", "distinct")):
        raise AssertionError("dp: the ranks' parameters differ after the step")
    if r0["over"]:
        raise AssertionError(f"dp: the step differs from the single-card step: "
                             f"{r0['over'][:8]}")
    if not r0["cut_over"]:
        raise AssertionError("dp: the cut reduction met the bound; the statistics' gradient "
                             "is not seen")
    print(f"dp: the cut reduction breaks the gradient bound on {len(r0['cut_over'])} "
          f"tensors", flush=True)
    if r0["distinct_over"]:
        raise AssertionError(f"dp on distinct scenes: the step differs from their "
                             f"accumulation on one card: {r0['distinct_over'][:8]}")
    if not r0["own_over"]:
        raise AssertionError("dp: rank 0's own gradient met the mean's bound; the gradient's "
                             "reduction is not seen")
    print(f"dp on distinct scenes: the step is their accumulation on one card (bound "
          f"{r0['rel']:g} * |ref|); rank 0's own gradient misses it on "
          f"{len(r0['own_over'])} tensors", flush=True)
    want = sum(r0["alone"])
    if not all(torch.equal(r["eval"], want) for r in ranks) or want.sum() <= 0:
        raise AssertionError(f"dp_eval_step: {r0['eval']} vs the scenes alone {want}")
    print(f"dp_eval_step over {DP_WORLD} ranks: tp/fp/fn totals {want.sum(1).tolist()} = the "
          f"sum of each scene's counts alone", flush=True)
    lap("data parallelism: two ranks on the card (gloo)")

    lw, cw = loop.loss_weights(cfg, None, dev)
    fresh = _fresh_states(cfg, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        group = mesh.make_group("nccl", "file://" + os.path.join(tmp, "rdv"), rank=0,
                                world_size=1)
        try:
            state = mesh.replicate_to_group(fresh(), group)
            norm.set_process_group(state.net, group)
            t0 = time.perf_counter()
            logs = mesh.dp_train_step(state, [col], 0, group=group, labelweights=lw,
                                      class_weight=cw, cfg=loop.train_config(cfg),
                                      fold_axis_rng=False)
            torch.cuda.synchronize(dev)
            step_s = time.perf_counter() - t0
            got = _step_record(state, logs, 1)
            del state, logs
        finally:
            dist.destroy_process_group()
    (ref,) = _single_card_steps(cfg, col, dev, fresh, n=1)
    over = _hold_step("dp (1 rank, NCCL)", got, ref, ref, r0["rel"])
    del got, ref, fresh
    torch.cuda.empty_cache()
    if over:
        raise AssertionError(f"dp over NCCL: the step differs from the single-card step: "
                             f"{over[:8]}")
    print(f"dp: a one-rank NCCL group took a step in {step_s:.3f} s", flush=True)
    lap("data parallelism: one-rank NCCL group")
    return r0["dp"]["launches"]


def kitti360_scenes(n_infers, seed):
    """``kitti360_config(n_infers)``'s synthetic data (8 raw channels, 19
    classes): one eval scan (``n_infers`` augmented views of one scene, as
    :func:`eval_scene`) and one train scene (a distinct scan per subnet,
    collated at the train box)."""
    from pasco_torch.core.config import kitti360_config
    from pasco_torch.data.semantic_kitti.collate import collate
    from pasco_torch.data.semantic_kitti.dataset import process_scene
    from pasco_torch.data.synthetic import make_scene
    from pasco_torch.training.loop import train_config

    cfg = kitti360_config(n_infers)
    rng = np.random.RandomState(seed)
    scan = eval_scene(cfg, rng)
    views = [process_scene(preset_scene(make_scene(
        rng, scene_size=cfg.scene.scene_size, n_points=min(cfg.capacity.num_points, 120000),
        point_feat_dim=cfg.model.in_channels - 6), cfg), None, rng,
        n_classes=cfg.model.n_classes, thing_ids=cfg.thing_ids) for _ in range(n_infers)]
    return [scan, collate(views, train_config(cfg), rng=rng)]


def kitti360_phase(dev, cols, lap, infer):
    """``kitti360_config(n_infers=2)`` at full width on synthetic 2-view
    scans with 8 raw channels: one forward through ``AdaptiveForward``
    after a warm-up (finite outputs of the expected shapes, 19 + 1 query
    classes, every kernel launched exactly ``forward_launch_floor(2)``
    times), ``run_scene_inference`` and the ``Evaluator`` (19 classes,
    things 1..6) on the scan through ``infer`` (:func:`start_scene_inference`:
    its host part overlaps what follows), then one panoptic train step at
    the train box with finite losses.  Returns the launches of the forward."""
    from pasco_torch import kernels
    from pasco_torch.core.config import kitti360_config
    from pasco_torch.data.kitti360.params import CLASS_FREQUENCIES
    from pasco_torch.inference.dispatch import AdaptiveForward, candidate_boxes, pick_box
    from pasco_torch.models.unet import build_net, scene_to_model_input
    from pasco_torch.training import loop
    from pasco_torch.training import step as tstep

    cfg = kitti360_config(n_infers=KITTI360_S)
    scan, train_col = cols
    net = build_net(cfg, dev)
    net.reset_parameters(torch.Generator().manual_seed(0))
    lw, cw = loop.loss_weights(cfg, CLASS_FREQUENCIES, dev)
    fwd = AdaptiveForward(net, lw)
    inp = scene_to_model_input(scan, dev)
    box = pick_box(candidate_boxes(cfg), scan.global_min, scan.global_max)
    with torch.no_grad():
        check_output(cfg, fwd(inp, box))                     # warm-up
        torch.cuda.synchronize(dev)
        kernels.reset_launches()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = fwd(inp, box)
        b.record()
        b.synchronize()
        launches = dict(kernels.LAUNCHES)
        kept, sub = check_output(cfg, out)
    floor = forward_launch_floor(KITTI360_S)
    print(f"kitti360 forward (n_infers={KITTI360_S}, box {box}): {a.elapsed_time(b):.3f} ms "
          f"between events, query classes {out.predictor.query_logits.shape[-1]}, kept {kept}, "
          f"kept per subnet {sub}, launches {launches}", flush=True)
    if {k: launches.get(k, 0) for k in floor} != floor:
        raise AssertionError(f"kitti360 forward: launches {launches}, want {floor}")
    if out.predictor.query_logits.shape[-1] != 19 + 1:
        raise AssertionError("kitti360 forward: not 19 + 1 query classes")
    with torch.no_grad():
        calls = profile_call(lambda: fwd(inp, box), reps=3)
    groups = {k: device_ms(calls, f"{k}_kernel") for k in
              ("masked_conv3", "down2", "up_preamble", "extract")}
    print(f"kitti360 forward device ms: {device_ms(calls):.3f} in all; by kernel "
          f"{ {k: round(v, 4) for k, v in groups.items()} }", flush=True)
    infer(cfg, lambda i: fwd(i, box), (scan, inp), "kitti360")
    lap("kitti360: forward")
    del net, fwd, out
    torch.cuda.empty_cache()
    state = loop.new_train_state(cfg, dev, seed=0)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    logs = tstep.train_step(state, scene_to_model_input(train_col, dev),
                            tstep.targets_to_device(train_col.targets, dev), lw, cw,
                            loop.train_config(cfg), seed=0)
    vals = {k: float(v) for k, v in logs.items()}
    step_s = time.perf_counter() - t0
    print(f"kitti360 train step (n_infers={KITTI360_S}, panoptic): {step_s:.3f} s (the "
          f"first at these shapes), peak {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB, "
          f"total_loss {vals['total_loss']:.6g}, grad_norm {vals['grad_norm']:.6g}, "
          f"{len(vals)} logs", flush=True)
    if not all(np.isfinite(v) for v in vals.values()) or not vals["grad_norm"] > 0:
        raise AssertionError(f"kitti360 train step: {vals}")
    del state
    torch.cuda.empty_cache()
    lap("kitti360: train step")
    return launches


# ---------------------------------------------------------------------------
# the sparse substrate (substrate="sparse"): no hand-written kernel
# ---------------------------------------------------------------------------

SPARSE_TOL = (1e-3, 1e-4)     # x max|ref|, absolute: card against CPU, f32


def sparse_config(cfg, n_infers=1, caps_unbound=False):
    """``cfg`` on the sparse substrate at ``n_infers``; with ``caps_unbound``
    each decoder and panoptic cap at its stage's row count (the box's
    cells at the scale), so that no cap binds."""
    m = dataclasses.replace(cfg.model, substrate="sparse", n_infers=n_infers)
    cfg = cfg.replace(model=m)
    if caps_unbound:
        ex, ey, ez = cfg.scene.box_extent
        n = ex * ey * ez
        cfg = cfg.replace(capacity=dataclasses.replace(
            cfg.capacity, dec_s4=n // 64, dec_s2=n // 8, dec_s1=n, panop_s4=n // 64,
            panop_s2=n // 8, panop_s1=n))
    return cfg


def _cells(grid, logits):
    """``{cell: logits row}`` of a grid's valid rows."""
    m = grid.mask.cpu().numpy()
    c = grid.coords.cpu().numpy()[m]
    v = logits.float().cpu().numpy()[m]
    return {tuple(int(x) for x in row): v[i] for i, row in enumerate(c)}


def _near_tie(logits, bound):
    """Whether some subnet's two top logits of ``logits [S, C]`` lie within
    ``bound`` (its argmax, and so the cell's keep, may flip)."""
    top = np.sort(logits, axis=-1)[..., -2:]
    return bool((top[..., 1] - top[..., 0] <= bound).any())


def compare_sparse(ref, got, tol=SPARSE_TOL):
    """Two sparse-substrate outputs of one input, rows keyed by coordinate:
    the kept cells at every scale (``sem_grids``) and of every subnet
    (``panop_grids``) are the same sets, but for cells whose two top logits
    lie within the bound in the output that keeps them; the semantic
    logits at the shared cells and the query logits within ``tol[0] *
    max|ref| + tol[1]``.  Returns ``(kept cells by scale, near-tie cells,
    max|d| of the sem logits, max|d| of the query logits)``; raises past
    the bounds."""
    kept, ties, sem_err = {}, [], 0.0
    for scale in (4, 2, 1):
        a = _cells(ref.sem_grids[scale], ref.sem_logits[scale])
        b = _cells(got.sem_grids[scale], got.sem_logits[scale])
        bound = tol[0] * max(np.abs(v).max() for v in a.values()) + tol[1]
        for cell in set(a) ^ set(b):
            row = a.get(cell, b.get(cell))
            if not _near_tie(row, bound):
                raise AssertionError(f"sparse: cell {cell} at s{scale} kept by one run only, "
                                     f"its logits {row} not near a tie")
            ties.append((scale, cell))
        shared = set(a) & set(b)
        err = max(np.abs(a[k] - b[k]).max() for k in shared)
        if err > bound:
            raise AssertionError(f"sparse: s{scale} sem logits max|d| {err} > {bound}")
        sem_err = max(sem_err, float(err))
        kept[scale] = len(a)
        for s in range(ref.panop_grids[scale].mask.shape[0]):
            pa = set(_cells(ref.panop_grids[scale].subnet(s), ref.panop_grids[scale].feats[s]))
            pb = set(_cells(got.panop_grids[scale].subnet(s), got.panop_grids[scale].feats[s]))
            if not pa or any((scale, c) not in ties for c in pa ^ pb):
                raise AssertionError(f"sparse: subnet {s} at s{scale}: {len(pa)} cells, "
                                     f"{len(pa ^ pb)} differ")
    q_ref = ref.predictor.query_logits.float().cpu().numpy()
    q_err = float(np.abs(q_ref - got.predictor.query_logits.float().cpu().numpy()).max())
    if q_err > tol[0] * np.abs(q_ref).max() + tol[1]:
        raise AssertionError(f"sparse: query logits max|d| {q_err}")
    return kept, ties, sem_err, q_err


def sparse_card_check(dev):
    """Step 1 of the sparse phase: ``flagship_narrow_config(n_infers=1)``
    on the sparse substrate (full widths, the small box, no cap binding) in
    f32, one forward on the card and one on the CPU from the same seeded
    weights and scan (TF32 off), held by :func:`compare_sparse`."""
    from pasco_torch.core.config import flagship_narrow_config
    from pasco_torch.models.unet import build_net, scene_to_model_input

    cfg = sparse_config(flagship_narrow_config(n_infers=1), caps_unbound=True)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    col = eval_scene(cfg, np.random.RandomState(0), n_points=cfg.capacity.num_points)
    net = build_net(cfg, "cpu")
    net.reset_parameters(torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = net(scene_to_model_input(col, "cpu"))
        cpu_s = time.perf_counter() - t0
        got = net.to(dev)(scene_to_model_input(col, dev))
    kept, ties, sem_err, q_err = compare_sparse(ref, got)
    print(f"sparse card vs CPU (flagship_narrow, f32, caps unbound): kept {kept}, the same "
          f"sets at every scale and subnet but {len(ties)} near-tie cells {ties[:8]}; "
          f"sem logits max|d| {sem_err:.4g}, query logits max|d| {q_err:.4g} (bound "
          f"{SPARSE_TOL[0]:g} * max|ref| + {SPARSE_TOL[1]:g}); CPU forward {cpu_s:.1f} s",
          flush=True)


def sparse_forward_phase(cfg, scan, label):
    """Steps 2-3: the full-width sparse forward on ``scan`` after one
    warm-up, with finite outputs of the reference's shapes and kept voxels
    at every scale and for every subnet (:func:`check_output`), its device
    ms between CUDA events, peak memory and host syncs.  Returns the net."""
    from pasco_torch.models.unet import build_net

    bench = _script("bench")
    dev = scan[1].point_feats.device
    net = build_net(cfg, dev)
    net.reset_parameters(torch.Generator().manual_seed(0))
    inp = scan[1]
    with torch.no_grad():
        check_output(cfg, net(inp))                     # warm-up
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = net(inp)
        b.record()
        b.synchronize()
        kept, sub = check_output(cfg, out)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    syncs = bench.host_syncs(lambda: bench.reduced(net(inp)))
    print(f"{label} (n_infers={cfg.model.n_infers}): device {a.elapsed_time(b):.3f} ms "
          f"between events, peak {peak:.3f} GB, {len(syncs)} host syncs per forward "
          f"{syncs}, kept {kept}, kept per subnet {sub}", flush=True)
    return net


def sparse_phase(dev, scan, scan3, train_col, lap, infer):
    """The sparse substrate on the card: the card against the CPU
    (:func:`sparse_card_check`), the full-width forward at n_infers 1 on
    bench.py's first scan and at 3 on the first MIMO scan
    (:func:`sparse_forward_phase`), ``run_scene_inference`` and the
    ``Evaluator`` at n_infers 1 (:func:`start_scene_inference` through
    ``infer``), and one ``train_step`` at the train box.  The path
    launches none of rows 1-8: the launches are counted from 0 over steps
    2-5 and must all be 0.  Returns them."""
    from pasco_torch import kernels
    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.data.semantic_kitti.params import CLASS_FREQUENCIES
    from pasco_torch.models.norm import BatchNorm
    from pasco_torch.models.unet import scene_to_model_input
    from pasco_torch.training import loop
    from pasco_torch.training import step as tstep

    sparse_card_check(dev)
    lap("sparse: card against CPU")
    kernels.reset_launches()
    cfg = sparse_config(PaSCoConfig())
    net = sparse_forward_phase(cfg, scan, "sparse forward")
    infer(cfg, net, scan, "sparse_n_infers_1")
    del net
    torch.cuda.empty_cache()
    lap("sparse: forward, n_infers 1")
    sparse_forward_phase(sparse_config(PaSCoConfig(), MIMO_S), scan3, "sparse MIMO forward")
    torch.cuda.empty_cache()
    lap("sparse: forward, n_infers 3")
    lw, cw = loop.loss_weights(cfg, CLASS_FREQUENCIES, dev)
    state = loop.new_train_state(cfg, dev, seed=0)
    stats = {n: m.mean.clone() for n, m in state.net.named_modules() if isinstance(m, BatchNorm)}
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    logs = tstep.train_step(state, scene_to_model_input(train_col, dev),
                            tstep.targets_to_device(train_col.targets, dev), lw, cw,
                            loop.train_config(cfg), seed=0)
    vals = {k: float(v) for k, v in logs.items()}
    step_s = time.perf_counter() - t0
    moved = sum(not torch.equal(m.mean, stats[n]) for n, m in state.net.named_modules()
                if isinstance(m, BatchNorm))
    launches = dict(kernels.LAUNCHES)
    print(f"sparse train step (n_infers=1, box {loop.train_config(cfg).scene.box_extent}): "
          f"{step_s:.3f} s (the first at these shapes), peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB, total_loss "
          f"{vals['total_loss']:.6g}, grad_norm {vals['grad_norm']:.6g}, running statistics "
          f"moved in {moved} of {len(stats)} BatchNorms", flush=True)
    if not all(np.isfinite(v) for v in vals.values()) or not vals["grad_norm"] > 0:
        raise AssertionError(f"sparse train step: {vals}")
    if moved != len(stats):
        raise AssertionError(f"sparse train step: running statistics moved in {moved} of "
                             f"{len(stats)} BatchNorms")
    print(f"sparse path launches of rows 1-8: {launches}", flush=True)
    if any(launches.values()):
        raise AssertionError(f"sparse path launched kernels: {launches}")
    del state
    torch.cuda.empty_cache()
    lap("sparse: train step")
    return launches


# ---------------------------------------------------------------------------

WAFFLE_TOL = (1e-4, 1e-5)     # x max|ref|, absolute: card against CPU, f32
WAFFLE_POINTS = 120000        # a SemanticKITTI scan's points
WAFFLE_NARROW = dict(n_classes=19, channels=32, depth=4, in_channels=5,
                     grids_shape=((64, 64), (64, 8), (64, 8)))


def waffle_scan(n, seed, grids_shape=None):
    """A synthetic LiDAR-like scan of ``n`` points in the extractor's layout
    ``[intensity, x, y, z, |xyz|]`` (a ground plane and scattered
    obstacles, 2-50 m away), with its host indices: ``(feats [n, 5],
    neighbors [16, n], cells [3, n], host ms of knn_indices +
    grid_cell_indices)``."""
    from pasco_torch.models.waffleiron import GRIDS, grid_cell_indices, knn_indices

    r = np.random.RandomState(seed)
    rng_ = 2 + 48 * r.rand(n) ** 2
    az = r.rand(n) * 2 * np.pi
    ground = r.rand(n) < 0.6
    z = np.where(ground, -1.73 + 0.05 * r.randn(n), r.uniform(-1.7, 1.5, n))
    xyz = np.stack([rng_ * np.cos(az), rng_ * np.sin(az), z], 1)
    feats = np.concatenate([r.rand(n, 1), xyz, np.linalg.norm(xyz, axis=1, keepdims=True)],
                           1).astype(np.float32)
    t0 = time.perf_counter()
    nbrs = knn_indices(xyz, 16)
    cells = grid_cell_indices(xyz, grids_shape or GRIDS)
    return feats, nbrs, cells, (time.perf_counter() - t0) * 1e3


def waffle_args(scan, dev):
    feats, nbrs, cells = scan[:3]
    return (torch.from_numpy(feats).to(dev), torch.from_numpy(nbrs).to(dev, torch.int64),
            torch.from_numpy(cells).to(dev, torch.int64),
            torch.ones(len(feats), dtype=torch.bool, device=dev))


def _waffle_close(what, got, ref):
    """max|got - ref| over its bound ``WAFFLE_TOL[0] * max|ref| +
    WAFFLE_TOL[1]``; raises past 1."""
    got, ref = got.detach().float().cpu(), ref.detach().float()
    err = (got - ref).abs().max().item()
    bound = WAFFLE_TOL[0] * ref.abs().max().item() + WAFFLE_TOL[1]
    if not err <= bound:
        raise AssertionError(f"waffleiron card vs CPU: {what} max|d| {err} > {bound}")
    return err / bound


def waffle_card_check(dev):
    """Step 2: the Segmenter at ``WAFFLE_NARROW`` (depth 4, 32 channels)
    on a 4000-point scan, on the card and on the CPU from the same seeded
    weights, f32 (TF32 off), in eval mode (logits, tokens) and in train
    mode (logits, tokens and every BatchNorm's parked statistics), within
    ``WAFFLE_TOL[0] * max|ref| + WAFFLE_TOL[1]``."""
    from pasco_torch.models.norm import BatchNorm
    from pasco_torch.models.waffleiron import Segmenter

    scan = waffle_scan(4000, seed=1, grids_shape=WAFFLE_NARROW["grids_shape"])
    cpu = Segmenter(**WAFFLE_NARROW)
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    card = Segmenter(**WAFFLE_NARROW).to(dev)
    card.load_state_dict(cpu.state_dict())
    errs = {}
    for mode in ("eval", "train"):
        cpu.train(mode == "train")
        card.train(mode == "train")
        with torch.no_grad():
            want = cpu(*waffle_args(scan, "cpu"))
            got = card(*waffle_args(scan, dev))
        errs[f"{mode} logits"] = _waffle_close(f"{mode} logits", got[0], want[0])
        errs[f"{mode} tokens"] = _waffle_close(f"{mode} tokens", got[1], want[1])
    stats = [(n, m.pending[None], dict(cpu.named_modules())[n].pending[None])
             for n, m in card.named_modules() if isinstance(m, BatchNorm)]
    if len(stats) != 3 + 2 * WAFFLE_NARROW["depth"]:
        raise AssertionError(f"waffleiron card vs CPU: {len(stats)} parked statistics")
    errs["parked statistics"] = max(_waffle_close(f"{n} {k}", g, w) for n, got, want in stats
                                    for k, g, w in zip(("mean", "var"), got, want))
    print(f"waffleiron card vs CPU (depth 4, 32 channels, 4000 points, f32): max|d| over "
          f"its bound {WAFFLE_TOL[0]:g} * max|ref| + {WAFFLE_TOL[1]:g}: "
          + ", ".join(f"{k} {v:.4g}" for k, v in errs.items()), flush=True)


def waffle_forward_phase(dev, scan):
    """Step 1: ``Segmenter()`` (48 x 256, seeded init) in eval mode on one
    ``WAFFLE_POINTS``-point scan: device ms per forward between CUDA events
    after one warm-up (three forwards), peak memory, host syncs, finite
    logits and tokens of the expected shapes."""
    from pasco_torch.models.waffleiron import Segmenter

    bench = _script("bench")
    net = Segmenter()
    net.reset_parameters(torch.Generator().manual_seed(0))
    net = net.to(dev).eval()
    args = waffle_args(scan, dev)
    times = []
    with torch.no_grad():
        net(*args)                                      # warm-up
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(3):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            logits, tokens = net(*args)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    syncs = bench.host_syncs(lambda: net(*args))
    n = len(scan[0])
    if logits.shape != (n, 19) or tokens.shape != (n, 256):
        raise AssertionError(f"waffleiron forward: logits {tuple(logits.shape)}, tokens "
                             f"{tuple(tokens.shape)}")
    if not (torch.isfinite(logits).all() and torch.isfinite(tokens).all()):
        raise AssertionError("waffleiron forward: non-finite outputs")
    print(f"waffleiron forward (Segmenter(), 48 x 256, {n} points, eval): device "
          f"{statistics.median(times):.3f} ms between events (median of "
          f"{', '.join(f'{t:.3f}' for t in times)}), host {scan[3]:.1f} ms for knn_indices + "
          f"grid_cell_indices, peak {peak:.3f} GB, {len(syncs)} host syncs per forward {syncs}; "
          f"logits {tuple(logits.shape)}, tokens {tuple(tokens.shape)} finite", flush=True)
    if syncs:
        raise AssertionError(f"waffleiron forward: host syncs {syncs}")


def waffle_extract(dev, root):
    """Step 3, first half: ``scripts_torch/extract_point_features.py`` on the
    card (``--num_votes 2 --frame_interval 1``) on the fake val scan under
    ``root``, into ``root/pre``; the port's ``KittiDataset`` must read the
    pickle as the flagship's 283 input channels.  Returns the preprocess
    root."""
    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.data.semantic_kitti.collate import collate
    from pasco_torch.data.semantic_kitti.dataset import KittiDataset

    pre = os.path.join(root, "pre")
    t0 = time.perf_counter()
    _script("extract_point_features").main(
        ["--dataset_root", root, "--output_root", pre, "--num_votes", "2",
         "--frame_interval", "1", "--device", str(dev)])
    extract_s = time.perf_counter() - t0
    cfg = PaSCoConfig()
    width = collate(KittiDataset(root=root, preprocess_root=pre, split="val")[0],
                    cfg).point_feats.shape[-1]
    print(f"waffleiron extraction CLI (2 votes, on the card): {extract_s:.2f} s; the port's "
          f"KittiDataset reads point_feats of {width} columns", flush=True)
    if width != cfg.model.in_channels:
        raise AssertionError(f"waffleiron extraction: point_feats of {width} columns, not "
                             f"{cfg.model.in_channels}")
    return pre


def waffle_trainer_phase(dev, out):
    """Step 4: ``scripts_torch/train_waffleiron.py --synthetic`` at full
    width with its defaults (batch 2, 20000 points) for 2 epochs of 4 steps,
    then ``--resume --epochs 3``: s per step (median after the first), peak
    memory, finite losses, both checkpoints, the resumed run at epoch 2."""
    main = _script("train_waffleiron").main
    argv = ["--synthetic", "--steps_per_epoch", "4", "--out", out, "--device", str(dev)]
    t0 = time.perf_counter()
    trainer = main([*argv, "--epochs", "2"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    steps = list(trainer.step_sec)
    if trainer.current_epoch != 2 or trainer.state.step != 8:
        raise AssertionError(f"waffleiron trainer: epoch {trainer.current_epoch}, step "
                             f"{trainer.state.step}")
    if sorted(f for f in os.listdir(out) if f.endswith(".pkl")) != ["ckpt_best.pkl",
                                                                    "ckpt_last.pkl"]:
        raise AssertionError(f"waffleiron trainer: checkpoints {os.listdir(out)}")
    resumed = main([*argv, "--epochs", "3", "--resume"])
    with open(os.path.join(out, "log.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    if [r["epoch"] for r in logs] != [0, 0, 1, 1, 2, 2] or resumed.state.step != 12:
        raise AssertionError(f"waffleiron trainer: resumed run logged epochs "
                             f"{[r['epoch'] for r in logs]}, step {resumed.state.step}")
    if not all(np.isfinite(r["loss"]) for r in logs):
        raise AssertionError(f"waffleiron trainer: losses {[r['loss'] for r in logs]}")
    losses = ", ".join(f"{r['tag']} {r['loss']:.4f}" for r in logs)
    print(f"waffleiron trainer (48 x 256, batch 2 x 20000 points): {len(steps)} steps, median "
          f"{statistics.median(steps[1:]):.4f} s per step after the first ({steps[0]:.3f} s "
          f"the first; all {', '.join(f'{t:.4f}' for t in steps)}), peak {peak:.3f} GB, "
          f"2 epochs {wall:.1f} s with validation; losses {losses}; ckpt_best.pkl and "
          f"ckpt_last.pkl written; the resumed run started at epoch 2 (step 8 -> 12, "
          f"{statistics.median(resumed.step_sec[1:]):.4f} s per step)", flush=True)


def start_waffle_eval(dev, root):
    """Step 3: the fake val scan under ``root``, :func:`waffle_extract` on
    the card, and ``scripts_torch/eval.py`` on its pickle started in a
    subprocess (:func:`start_eval_cli` with 283 input channels), to run
    beside the data-parallel phase.  Returns the process and its output
    files for :func:`waffleiron_phase`."""
    os.makedirs(root)
    write_fake_val_scan(root)
    pre = waffle_extract(dev, root)
    return start_eval_cli(root, in_channels=283, preprocess_root=pre)


def waffleiron_phase(dev, lap, eval_job):
    """The WaffleIron frontend on the card: ``scripts_torch/eval.py`` on
    the extraction's pickle (``eval_job``, from :func:`start_waffle_eval`)
    must have exited 0 with every table; the card against the CPU at a
    narrow width (:func:`waffle_card_check`); the timed full-width forward
    on a 120000-point scan (:func:`waffle_forward_phase`) and the trainer
    CLI with its resume (:func:`waffle_trainer_phase`).  The frontend
    launches none of rows 1-8: the launches over the forward and the
    trainer must all be 0.  Returns them."""
    from pasco_torch import kernels

    finish_eval_cli(*eval_job)
    waffle_card_check(dev)
    scan = waffle_scan(WAFFLE_POINTS, seed=0)
    lap("waffleiron: card against CPU, a scan's host indices")
    kernels.reset_launches()
    waffle_forward_phase(dev, scan)
    launches = dict(kernels.LAUNCHES)
    del scan
    torch.cuda.empty_cache()
    lap("waffleiron: forward, 120000 points")
    kernels.reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_waffle_") as out:
        waffle_trainer_phase(dev, out)
    launches = {k: v + kernels.LAUNCHES[k] for k, v in launches.items()}
    torch.cuda.empty_cache()
    lap("waffleiron: trainer CLI and resume")
    print(f"waffleiron path launches of rows 1-8 (forward and trainer): {launches}",
          flush=True)
    if any(launches.values()):
        raise AssertionError(f"waffleiron path launched kernels: {launches}")
    return launches


def run_phases(jobs, dev, lap, pool, tmp):
    """Every phase after the build (see the module docstring), on the
    scenes of ``jobs`` (futures of :func:`host_scenes`).  Returns the
    kernel rows at 352, the rows of the smaller boxes and of the batch of
    two, the launches by box of the n_infers=1 bench run, those of the MIMO forward, the training
    conv's row, the launches of the n_infers 3 trainer and the launches
    of every path by name (the data-parallel step's and the KITTI-360
    forward's among them).  The host part of each ``run_scene_inference``
    runs in a worker of ``pool`` (:func:`start_scene_inference`, its
    files in ``tmp``), and its lines are printed after the last phase."""
    from pasco_torch.core.config import PaSCoConfig
    from pasco_torch.models.unet import build_net, scene_to_model_input

    def cols_of(name):
        import pickle

        t0 = time.perf_counter()
        cols = jobs[name].result()
        if time.perf_counter() - t0 > 1:
            print(f"waited {time.perf_counter() - t0:.1f} s for the {name} scenes", flush=True)
        if isinstance(cols, str):
            with open(cols, "rb") as fh:
                cols = pickle.load(fh)
        return cols

    def scans_of(name):
        return [(col, scene_to_model_input(col, dev)) for col in cols_of(name)]

    inferences = []

    def infer(cfg, forward_fn, scan, name):
        inferences.append((name, start_scene_inference(pool, tmp, cfg, forward_fn, scan, name)))

    cfg = PaSCoConfig()
    # bench.py's six scans (RandomState(0)); the first N_SCANS drive the
    # forward phase
    scans = scans_of("scans")
    gen = torch.Generator().manual_seed(0)
    rows = kernel_phases(cfg, scans[0][1], gen)
    rows.append(column_conv_phase(scan_masks(cfg, scans[0][1])[1], dev))
    lap("kernels at box 352")

    net = build_net(cfg, dev)
    net.reset_parameters(torch.Generator().manual_seed(0))
    forward_phase(cfg, scans[:N_SCANS], net)
    rows.append(featurizer_phase(cfg, scans[0][1], net))
    infer(cfg, net, scans[0], "n_infers_1")
    lap("forward, n_infers 1")
    mc_dropout_phase(dev, scans[0][1])
    lap("MC dropout")

    # The box ladder (this slice): rows 1-5 at every smaller box, the
    # extraction alternating between boxes, the bench protocol through
    # AdaptiveForward against the fixed box, one scan at two boxes.
    by_box = {box_of(cfg, col)[0]: (col, inp) for col, inp in reversed(scans)}
    box_scans = {256: scans_of("box256")[0], **{b: by_box[b] for b in LADDER[1:]}}
    box_rows = ladder_kernel_phase(cfg, box_scans, gen)
    alternating_extraction(cfg, {352: scans[0], **box_scans}, gen)
    lap("kernels at boxes 256, 288, 320")
    # adaptive and fixed once each (four runs before the batched phases)
    _, per_box, _ = bench_phase(cfg, scans, net, "bench n_infers=1")
    two_boxes_check(cfg, net, by_box[288], box_of(cfg, by_box[288][0]))
    lap("bench protocol, n_infers 1")

    # The batched forward (this slice): rows 1-3 on a batch in one launch,
    # the batched forward against the per-scan ones, bench.py's BENCH_BATCH.
    batch_rows = batch_kernel_phase(cfg, scans, gen)
    batch_forward_check(cfg, net, scans)
    lap(f"batched kernels and forward, B={BATCH_CHECK}")
    batch_launches = batch_bench_phase(cfg, net, cols_of("batch"))
    lap(f"batched bench protocol, B={', '.join(map(str, BATCH_BENCH))}")
    first = scans[0][1]
    sparse_scan = scans[0]
    del net, scans, box_scans, by_box     # the MIMO forward's peak holds only its own state
    torch.cuda.empty_cache()

    # The MIMO ensemble, on bench.py's six n_infers=3 scans (the first
    # N_SCANS drive the forward phase).
    cfg3 = cfg.replace(model=dataclasses.replace(cfg.model, n_infers=MIMO_S))
    net3 = build_net(cfg3, dev)
    net3.reset_parameters(torch.Generator().manual_seed(0))
    scans3 = scans_of("scans3")
    sparse_scan3 = scans3[0]
    launches = forward_phase(cfg3, scans3[:N_SCANS], net3, "MIMO forward")
    infer(cfg3, net3, scans3[0], "n_infers_3")
    lap("forward, n_infers 3")
    # one run: every n_infers=3 scan takes the 352 box, so the fixed runs
    # would repeat the adaptive one; on three of the six scans, to pay for
    # the sparse phase
    bench_phase(cfg3, scans3[:N_SCANS], net3, "bench n_infers=3", modes=("adaptive",))
    lap("bench protocol, n_infers 3")
    del net3, scans3
    torch.cuda.empty_cache()

    dx_row = train_conv_phase(cfg, cols_of("train")[0], gen, dev)
    narrow_step_check(dev, dropout=0.2)
    lap("training conv and narrow step")
    trainer_phase(dev)
    lap("trainer, n_infers 1")
    train_launches = trainer_mimo_phase(dev)
    lap("trainer, n_infers 3")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as eval_tmp:
        write_fake_val_scan(eval_tmp)
        proc, logs = start_eval_cli(eval_tmp)    # beside the CLI phase, on the card too
        try:
            cli_phase(dev, first)
        except BaseException:
            proc.kill()
            _wait_logged(proc, logs)
            raise
        finish_eval_cli(proc, logs)
    lap("CLIs")
    by_path = {"mimo_forward": launches, "trainer_n_infers_3": train_launches,
               "batch": batch_launches}
    by_path["kitti360_s2_forward"] = kitti360_phase(dev, cols_of("kitti360"), lap, infer)
    # the WaffleIron extraction's eval.py runs beside the data-parallel
    # phase (a correctness check of two ranks sharing the card)
    waffle_eval = start_waffle_eval(dev, os.path.join(tmp, "waffle"))
    lap("waffleiron: extraction CLI, eval.py started")
    try:
        by_path["dp_step_rank0"] = dp_phase(dev, cols_of("train"), lap)
        by_path["sparse"] = sparse_phase(dev, sparse_scan, sparse_scan3, cols_of("train")[0],
                                         lap, infer)
        by_path["waffleiron"] = waffleiron_phase(dev, lap, waffle_eval)
    except BaseException:
        if waffle_eval[0].poll() is None:
            waffle_eval[0].kill()
            waffle_eval[0].wait()
        raise
    for name, fut in inferences:
        t0 = time.perf_counter()
        lines = fut.result()
        print("\n".join(lines), flush=True)
        print(f"run_scene_inference and the Evaluator ({name}): waited "
              f"{time.perf_counter() - t0:.1f} s for the worker", flush=True)
    lap("run_scene_inference and the Evaluator at n_infers 1, 3 and 2 (the rest of them)")
    return rows, box_rows + batch_rows, per_box, launches, dx_row, train_launches, by_path


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pasco_torch import kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # The scenes (the draws of make_scans and train_scenes) are drawn on the
    # host while the kernels build (bench.py's n_infers=1 scans) and, by
    # worker processes at the lowest priority, while the card works.
    pool = cf.ProcessPoolExecutor(max_workers=4, mp_context=mp.get_context("spawn"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        jobs = {name: pool.submit(host_scenes, *args, 19, os.path.join(tmp, f"{name}.pkl"))
                for name, args in (
            ("scans3", ("eval", MIMO_S, BENCH_SCANS, 0)),
            ("box256", ("unaugmented", 1, 1, 3)),
            ("train", ("train", 1, 2, 0)),
            ("kitti360", ("kitti360", KITTI360_S, 1, 0)),
            ("batch", ("batch", 1, BATCH_BENCH[-1], 0)))}
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(1) as build_pool:
            build = build_pool.submit(kernels.lib)     # nvcc in subprocesses
            jobs["scans"] = cf.Future()
            jobs["scans"].set_result(host_scenes("eval", 1, BENCH_SCANS, 0))
            print(f"bench scans drawn: {time.perf_counter() - t0:.1f} s", flush=True)
            build.result()
        print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
        t_lap = [time.perf_counter()]

        def lap(name):
            now = time.perf_counter()
            print(f"phase {name}: {now - t_lap[0]:.1f} s", flush=True)
            t_lap[0] = now

        rows, box_rows, per_box, launches, dx_row, train_launches, by_path = run_phases(
            jobs, dev, lap, pool, tmp)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)

    for r in rows:
        r.setdefault("launches", launches[r["name"]])
    dx_row["launches"] = train_launches["conv3_dx"]
    rows.append(dx_row)
    for r in rows:
        r["launches_by_path"] = {path: n.get(r["name"], 0) for path, n in by_path.items()}
    for r in box_rows:
        if "box" in r:        # launches at that box in the bench run (warm-up included)
            r["launches"] = per_box[tuple(r.pop("box"))][r.pop("kernel")]
        else:                 # a batched case: launches in the batched B=4 forward
            r["launches"] = by_path["batch"][r.pop("kernel")]
    rows += box_rows
    for r in rows:
        r["route"] = "cuda"
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
