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
   each with its median time and the plain version's (CUDA events).  The
   up-preamble runs a second case whose bound comes from the deconv path,
   and shows that a plain run with a broken deconv would fail it;
   the column-sparse conv (row 7) runs through its own entry point on the
   scan's s1 occupancy against cuDNN in f32 (:func:`column_conv_phase`);
4. drives the flagship forward (``PaSCoConfig()``, n_infers=1, full
   widths, seeded random init) on 3 synthetic scans after one warm-up,
   checks finite outputs of the expected shapes, kept voxels at every
   scale and that every kernel was launched, and prints scans/s,
   device ms/scan and peak device memory; the fused featurizer (row 8)
   then runs through its own entry point on the first scan's points
   against the model's featurizer chain (:func:`featurizer_phase`);
5. runs ``run_scene_inference`` and the ``Evaluator`` on one scan;
   then the same for the MIMO ensemble (n_infers=3, the slice's main
   path): 3 scans, each 3 augmented views of one scene, through the
   forward (kept voxels for every subnet, at least 60 ``masked_conv3``
   and 12 ``stream_extract`` launches per forward), then
   ``run_scene_inference`` (4 outputs) and the ``Evaluator`` with the
   PQ, SSC mIoU and ECE of every output;
6. training, kernel phase: the differentiable conv of every residual
   block (``MaskedConv3Fn``: forward and data gradient on the conv kernel)
   at the train box (256, 256, 32), f=64, on the scan's s1 occupancy and a
   near-dense decoder mask: forward, dx, dw and db against autograd of the
   plain version on the same inputs, within the bound above at valid
   cells, with exact zeros of the output and of dx elsewhere; kernel
   against plain time for the forward and for dx;
7. training, narrow whole step: one train step at
   ``flagship_narrow_config(n_infers=1)`` (full widths, small box; caps
   that do not bind, no point dropout) with the kernels on the card and
   with the plain versions on the CPU, from the same weights and inputs:
   loss terms and per-parameter gradients within the bounds stated at
   :func:`narrow_step_check`;
8. training, flagship: ``PaSCoConfig()`` on the train box with seeded
   random init, one warm-up and 3 timed steps through
   ``pasco_torch.training.loop.train`` on synthetic scenes with targets;
   prints s/step, device ms/step, peak device memory, ``total_loss`` and
   ``grad_norm`` per step and the launches per step, and requires finite
   losses, ``grad_norm > 0``, running statistics that moved, and per step
   two ``masked_conv3`` launches (remat reruns the forward) and one
   ``conv3_dx`` launch for every residual-block and refiner conv;
9. training, MIMO: the same at n_infers=3 on a distinct scan per subnet:
   one sem-only step (``is_predict_panop=False``), one warm-up and 2
   timed panoptic steps.

Prints the whole run's wall time and a JSON line with the kernels'
numbers (launches from the MIMO forward, the MIMO train steps and the two
entry-point phases), then as its last line
``{"ok": true, "device": {...}}``.  Any failure raises (non-zero exit, no
result line); so does a machine without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TOL_REL, TOL_ABS = 2e-2, 2e-2
N_SCANS = 3
N_TRAIN_STEPS = 3
MIMO_S = 3                 # the reference's MIMO headline config (bench.py:54)
N_MIMO_TRAIN_STEPS = 2
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
    """Median milliseconds of ``fn()`` from CUDA events."""
    fn()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b))
    return statistics.median(samples)


def eval_scene(cfg, rng, n_points=120000, max_angle=30.0):
    """One synthetic scan collated for inference: ``n_infers`` views of it
    under distinct eval augmentations (as bench.py draws them; the
    reference's validation split, ``pasco_tpu/data/semantic_kitti/
    dataset.py:464-489``)."""
    from pasco_tpu.data.semantic_kitti.collate import collate
    from pasco_tpu.data.semantic_kitti.dataset import process_scene
    from pasco_tpu.data.synthetic import make_scene
    from pasco_tpu.data.transform_utils import generate_random_transformation

    scene = make_scene(
        rng, scene_size=cfg.scene.scene_size,
        n_points=min(cfg.capacity.num_points, n_points),
        point_feat_dim=cfg.model.in_channels - 6,
    )
    views = []
    for _ in range(cfg.model.n_infers):
        T = generate_random_transformation(
            rng, max_angle=max_angle, scale_range=0.0,
            max_translation=(0.2, 0.2, 0.1),
        )
        views.append(process_scene(scene, T, rng))
    return collate(views, cfg, rng=rng)


def make_scans(cfg, n, device, seed=0):
    """``n`` synthetic scans (:func:`eval_scene`) and their model inputs."""
    from pasco_torch.models.unet import scene_to_model_input

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        col = eval_scene(cfg, rng)
        out.append((col, scene_to_model_input(col, device)))
    return out


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


def _compare(name, got, ref, mask):
    """Conv-like check at valid cells; exact zeros at invalid cells.
    Returns (max|d|, bound)."""
    g, r = got.float(), ref.float()
    err = (g - r)[mask].abs().max().item() if mask.any() else 0.0
    bound = TOL_REL * r[mask].abs().max().item() + TOL_ABS
    print(f"check {name}: max|d| {err:.4g}, bound {bound:.4g}", flush=True)
    if not err <= bound:
        raise AssertionError(f"{name}: max|d| {err} > {bound}")
    if (g[~mask] != 0).any():
        raise AssertionError(f"{name}: non-zero output at invalid cells")
    return err, bound


def kernel_phases(cfg, inp, gen):
    """Each kernel against its plain version at main-path shapes."""
    from pasco_torch.ops import conv, deconv, down, extract
    from pasco_torch.ops.dense_ops import maxpool2_mask, upsample2_mask

    dev = inp.point_feats.device
    bf = torch.bfloat16
    f = cfg.model.f
    box, occ1, bbox1 = scan_masks(cfg, inp)
    X, Z, Y = occ1.shape

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device=dev, dtype=bf)

    def vec(n, lo=-0.1, hi=0.1):
        return (torch.rand((n,), generator=gen) * (hi - lo) + lo).to(dev)

    def masked(x, m):
        return torch.where(m[..., None], x, torch.zeros((), dtype=x.dtype, device=dev))

    rows = []
    keep_ref = bbox1 & (torch.rand((X, Z, Y), generator=gen) < 0.7).to(dev)

    # --- kernel 1: masked_conv3 at the s1 shape, three forms ----------------
    w = randn(27, f, f, scale=(27 * f) ** -0.5)
    b = vec(f)
    aff = (vec(f, 0.5, 1.5), vec(f))
    x = masked(randn(X, Z, Y, f), bbox1)
    skip = masked(randn(X, Z, Y, f), bbox1)
    forms = [
        ("res-block conv2 (affine, relu, skip)", bbox1,
         dict(bias=b, affine=aff, relu_in=True, skip=skip, relu_out=True)),
        ("res-block conv1 (affine, relu)", occ1,
         dict(bias=b, affine=aff, relu_in=True)),
        ("refiner conv1 (mask only)", keep_ref, {}),
    ]
    errs, times = [], None
    for label, m, kw in forms:
        tiles = conv.conv_tiles(m)
        got = conv.masked_conv3(x, m, w, tiles=tiles, **kw)
        ref = conv.masked_conv3_plain(x, m, w, **kw)
        errs.append(_compare(f"masked_conv3 {label}", got, ref, m)[0])
        if times is None:
            times = (
                time_ms(lambda: conv.masked_conv3(x, m, w, tiles=tiles, **kw)),
                time_ms(lambda: conv.masked_conv3_plain(x, m, w, **kw)),
            )
    rows.append(dict(
        name="masked_conv3", source="pasco_torch/csrc/masked_conv3.cu",
        replaces="pasco_tpu/ops/pallas_conv.py:1159", max_abs_err=max(errs),
        ms=times[0], plain_ms=times[1]))

    # --- kernel 2: down2_fused at enc_s2 ---------------------------------
    xd = masked(randn(X, Z, Y, f), occ1)
    m2 = maxpool2_mask(occ1)
    wd = randn(8, f, 2 * f, scale=(8 * f) ** -0.5)
    args = (xd, occ1, m2, wd, vec(2 * f), (vec(2 * f, 0.5, 1.5), vec(2 * f)),
            (vec(2 * f, 0.5, 1.5), vec(2 * f)))
    tiles = down.down_tiles(m2)
    err, _ = _compare("down2_fused", down.down2_fused(*args, tiles=tiles),
                      down.down2_fused_plain(*args), m2)
    rows.append(dict(
        name="down2_fused", source="pasco_torch/csrc/down2_fused.cu",
        replaces="pasco_tpu/ops/pallas_down.py:244", max_abs_err=err,
        ms=time_ms(lambda: down.down2_fused(*args, tiles=tiles)),
        plain_ms=time_ms(lambda: down.down2_fused_plain(*args))))

    # --- kernel 3: up_preamble at dec_s1, two cases ------------------------
    # "coords + skip": the absolute-coordinate channels (cells up to ~300
    # from the origin) dominate |r|, so this bound checks the coordinate
    # and union paths but is too coarse for the deconv branch.
    # "deconv": wr's coordinate rows are zero and the deconv has unit
    # variance, so the bound comes from the deconv/BN path; a plain run with
    # the child-offset weights rolled, or with the parent product dropped,
    # must break that bound, else the check is void.
    pkeep = maxpool2_mask(bbox1)
    parent = randn(X // 2, Z // 2, Y // 2, 2 * f)
    child = upsample2_mask(pkeep) & bbox1
    union = child | occ1
    skip = masked(randn(X, Z, Y, f), occ1)
    skip_d = skip * 0.1
    bd, br = vec(f), vec(f)
    bn = ((vec(f, 0.5, 1.5), vec(f)), (vec(f + 3, 0.5, 1.5), vec(f + 3)))
    wr_d = randn(f + 3, f, scale=f ** -0.5)
    wr_d[f:] = 0

    def up_args(skip_, wd_, wr_):
        return (parent, pkeep, child, union, skip_, box, 1, wd_, bd, *bn, wr_, br)

    wd_d = randn(8, 2 * f, f, scale=(2 * f) ** -0.5)
    up_cases = [
        ("coords + skip", up_args(skip, randn(8, 2 * f, f, scale=(16 * f) ** -0.5),
                                  randn(f + 3, f, scale=0.1))),
        ("deconv", up_args(skip_d, wd_d, wr_d)),
    ]
    tiles = deconv.up_tiles(union)
    errs = []
    for label, args in up_cases:
        ref = deconv.up_preamble_plain(*args)
        err, bound = _compare(f"up_preamble {label}",
                              deconv.up_preamble(*args, tiles=tiles), ref, union)
        errs.append(err)
    for label, wd_bad in (("child offsets rolled", wd_d.roll(1, 0)),
                          ("parent product dropped", torch.zeros_like(wd_d))):
        bad = deconv.up_preamble_plain(*up_args(skip_d, wd_bad, wr_d))
        miss = (bad.float() - ref.float())[union].abs().max().item()
        print(f"check up_preamble deconv resolution, {label}: max|d| "
              f"{miss:.4g} > bound {bound:.4g}", flush=True)
        if not miss > bound:
            raise AssertionError(f"up_preamble check cannot see a wrong deconv "
                                 f"({label}: {miss} <= {bound})")
    args = up_cases[0][1]
    rows.append(dict(
        name="up_preamble", source="pasco_torch/csrc/up_preamble.cu",
        replaces="pasco_tpu/ops/pallas_deconv.py:306", max_abs_err=max(errs),
        ms=time_ms(lambda: deconv.up_preamble(*args, tiles=tiles)),
        plain_ms=time_ms(lambda: deconv.up_preamble_plain(*args))))

    # --- kernel 4: stream_extract, bit-exact ------------------------------
    cases = [
        ("dec_s1", bbox1, randn(X, Z, Y, cfg.model.n_classes),
         cfg.capacity.dec_s1),
        ("refiner s1", keep_ref, randn(X, Z, Y, f), cfg.capacity.panop_s1),
    ]
    times = None
    for label, keep, pay, cap in cases:
        got = extract.stream_extract(keep, cap, pay)
        ref = extract.stream_extract_plain(keep, cap, pay)
        for gname, g, r in zip(("vals", "src", "valid", "total"), got, ref):
            if g.shape != r.shape or not torch.equal(g, r):
                raise AssertionError(f"stream_extract {label}: {gname} differs")
        if times is None:
            times = (time_ms(lambda: extract.stream_extract(keep, cap, pay)),
                     time_ms(lambda: extract.stream_extract_plain(keep, cap, pay)))
    rows.append(dict(
        name="stream_extract", source="pasco_torch/csrc/stream_extract.cu",
        replaces="pasco_tpu/ops/pallas_extract.py:454", max_abs_err=0.0,
        ms=times[0], plain_ms=times[1]))
    for r in rows:
        print(f"kernel {r['name']}: max|d| {r['max_abs_err']:.4g}, "
              f"{r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms", flush=True)
    return rows


def column_conv_phase(occ1, dev):
    """Row 7 through its entry point, ``block_sparse_conv3``, on the scan's
    s1 occupancy as ``[X, Y, Z]``: f32 ``[X, Y, Z, 64]`` input (masked),
    ``[27, 64, 64]`` weight and a bias, once with every 8x8 column listed and
    once with the capacity at half the occupied columns.  The plain version
    is cuDNN ``conv3d`` in f32 (TF32 off) zeroed outside the visited
    columns.  Bound ``1e-3 * max|ref| + 1e-3`` at visited cells; elsewhere
    both are exactly the bias at mask cells and 0 at the others.  Returns
    the JSON row."""
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
    cases = [(f"all {n_cols} columns", n_cols), (f"{n_occ // 2} of {n_occ} occupied columns",
                                                  n_occ // 2)]
    kernels.reset_launches()
    outs = [cc.block_sparse_conv3(x, w, mask, cap, bias=b) for _, cap in cases]
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["column_conv3"]
    errs = []
    for (label, cap), got in zip(cases, outs):
        ref = cc.block_sparse_conv3_plain(x, w, mask, cap, bias=b)
        ids, n = cc.active_columns(mask, cap)
        vis = cc.visited_cells(ids, n, X, Y)[..., None].expand(X, Y, Z)
        err = (got - ref)[vis].abs().max().item()
        bound = 1e-3 * ref[vis].abs().max().item() + 1e-3
        rest = torch.where(mask[..., None], b, torch.zeros((), device=dev))[~vis]
        print(f"check column_conv3 ({X}, {Y}, {Z}, {c}), {label}: visited cells "
              f"{int(vis.sum())} of {vis.numel()}, max|d| {err:.4g}, bound {bound:.4g}",
              flush=True)
        if not err <= bound:
            raise AssertionError(f"column_conv3 {label}: max|d| {err} > {bound}")
        if not (torch.equal(got[~vis], rest) and torch.equal(ref[~vis], rest)):
            raise AssertionError(f"column_conv3 {label}: unvisited columns not conv-free")
        errs.append(err)
    times = [(time_ms(lambda: cc.block_sparse_conv3(x, w, mask, cap, bias=b)),
              time_ms(lambda: cc.block_sparse_conv3_plain(x, w, mask, cap, bias=b)))
             for _, cap in cases]
    for (label, _), (ms, plain_ms) in zip(cases, times):
        print(f"kernel column_conv3, {label}: {ms:.3f} ms vs plain {plain_ms:.3f} ms",
              flush=True)
    return dict(name="column_conv3", source="pasco_torch/csrc/column_conv3.cu",
                replaces="pasco_tpu/ops/pallas_conv.py:1348", max_abs_err=max(errs),
                launches=launches, ms=times[0][0], plain_ms=times[0][1])


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
    row = dict(name="featurizer", source="pasco_torch/csrc/featurizer.cu",
               replaces="pasco_tpu/ops/pallas_featurizer.py:214", max_abs_err=err,
               launches=launches, ms=time_ms(lambda: fz.featurizer_fused(*args)),
               plain_ms=time_ms(lambda: fz.featurizer_fused_plain(*args)))
    print(f"kernel featurizer: {row['ms']:.3f} ms vs plain {row['plain_ms']:.3f} ms, "
          f"launches {launches}", flush=True)
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


def train_scenes(cfg, n, seed=0):
    """Synthetic training scenes with targets, collated at the train box:
    a distinct scan per subnet, as the reference's training split draws
    them (``pasco_tpu/data/semantic_kitti/dataset.py:464-489``)."""
    from pasco_tpu.data.semantic_kitti.collate import collate
    from pasco_tpu.data.semantic_kitti.dataset import process_scene
    from pasco_tpu.data.synthetic import make_scene
    from pasco_torch.training.loop import train_config

    tcfg = train_config(cfg)
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        views = []
        for _ in range(cfg.model.n_infers):
            scene = make_scene(
                rng, scene_size=cfg.scene.scene_size,
                n_points=min(cfg.capacity.num_points, 120000),
                point_feat_dim=cfg.model.in_channels - 6,
            )
            views.append(process_scene(scene, None, rng))
        out.append(collate(views, tcfg, rng=rng))
    return out


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
        t = times[label] = dict(
            fwd=time_ms(lambda: conv.masked_conv3(x, m, w, b, tiles=tiles)),
            fwd_plain=time_ms(lambda: conv.masked_conv3_plain(x, m, w, b)),
            dx=time_ms(lambda: conv.conv3_dx(dym, m, w, tiles)),
            dx_plain=time_ms(lambda: conv.masked_conv3_plain(dym, m, w_t)),
            dw=time_ms(lambda: conv.conv3_weight_grad(xm, dym)),
        )
        print(f"train conv (row 6) at {(X, Z, Y, f)}, {label}: forward {t['fwd']:.3f} ms "
              f"vs plain {t['fwd_plain']:.3f} ms; dx {t['dx']:.3f} ms vs plain "
              f"{t['dx_plain']:.3f} ms; dw (plain per-tap products) {t['dw']:.3f} ms",
              flush=True)
    t = times["decoder, near dense"]
    return dict(name="conv3_dx", source="pasco_torch/csrc/masked_conv3.cu",
                replaces="pasco_tpu/ops/pallas_conv.py:1303", max_abs_err=errs["dx"],
                ms=t["dx"], plain_ms=t["dx_plain"])


def narrow_step_check(dev, n_infers=1):
    """One train step at ``flagship_narrow_config(n_infers)`` with the
    kernels on the card (bf16) against the same step with the plain
    versions on the CPU, in bf16 and in f32, from the same weights and
    inputs.  The decoder caps are raised to the box's cell count, so the
    Gumbel cap is a no-op; the config has no point dropout; the BN biases
    are drawn non-zero (at a zero bias, a leaky/relu between two BNs makes
    the first one's scale gradient structurally zero).

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
    from pasco_tpu.core.config import OptimConfig, flagship_narrow_config
    from pasco_torch.models.norm import BatchNorm
    from pasco_torch.models.unet import build_net, scene_to_model_input
    from pasco_torch.training import step as tstep

    cfg = flagship_narrow_config(n_infers=n_infers)
    ex, ey, ez = cfg.scene.box_extent
    n = ex * ey * ez
    cfg = cfg.replace(
        capacity=dataclasses.replace(cfg.capacity, dec_s4=n // 64, dec_s2=n // 8, dec_s1=n),
        optim=OptimConfig(lr=1e-3, warmup_steps=0))
    col = train_scenes(cfg, 1, seed=1)[0]
    freqs = {s: np.ones(cfg.model.n_classes) for s in (1, 2, 4)}
    lw = tstep.labelweights_for(cfg, freqs)
    cw = tstep.class_weight_vector(cfg.model.n_classes, cfg.loss.no_object_weight)
    init = build_net(cfg)
    init.reset_parameters(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in init.modules():
            if isinstance(m, BatchNorm):
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
    runs = {}
    for name, dtype, d in (("cuda", "bfloat16", dev), ("cpu", "bfloat16", torch.device("cpu")),
                           ("cpu f32", "float32", torch.device("cpu"))):
        c = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype=dtype))
        model = build_net(c)
        model.load_state_dict(init.state_dict())
        state = tstep.create_train_state(model.to(d), c)
        t0 = time.perf_counter()
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
    print(f"narrow step: total_loss {logs['total_loss']:.6g} (cuda bf16) vs "
          f"{ref_logs['total_loss']:.6g} (cpu plain bf16) vs "
          f"{runs['cpu f32'][0]['total_loss']:.6g} (cpu plain f32); worst loss term at "
          f"{worst:.3f} of its bound; gradient error against f32, median over "
          f"parameters: {med:.4g} (cuda) vs {med_plain:.4g} (cpu bf16), worst "
          f"ratio {ratio:.3f}; structurally zero max {zero:.3g} vs bound "
          f"{1e-2 * top:.3g}; step {t_gpu:.2f} s (cuda) / {t_cpu:.2f} s (cpu bf16)",
          flush=True)
    if not worst <= 1.0:
        raise AssertionError(f"narrow step: loss terms differ ({worst:.3f} of the bound)")
    if over or not med <= 1.2 * med_plain or not zero <= 1e-2 * top:
        raise AssertionError(f"narrow step: gradients off: {dict(list(over.items())[:5])}, "
                             f"median {med:.4g} vs {med_plain:.4g}, zero {zero:.3g}")


def _check_steps(label, recs):
    for r in recs:
        print(f"{label} step {r['step']}: is_predict_panop {r['is_predict_panop']}, "
              f"total_loss {r['total_loss']:.6g}, grad_norm {r['grad_norm']:.6g}, "
              f"{r['step_s']:.4f} s, device {r['device_ms']:.2f} ms", flush=True)
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


def train_phase(cfg, cols, dev, n_sem=0, label="train"):
    """The flagship train step through the trainer: ``n_sem`` sem-only
    steps (``is_predict_panop=False``), one warm-up step, then the timed
    ones on the remaining scenes.  Returns the launches of the timed
    steps."""
    from pasco_torch import kernels
    from pasco_torch.models.norm import BatchNorm
    from pasco_torch.training.loop import train

    S = cfg.model.n_infers
    state = None
    if n_sem:
        kernels.reset_launches()
        state = train(cfg, cols[:n_sem], device=dev, log=None, pretrain_sem_steps=n_sem)
        launches = {k: v / n_sem for k, v in kernels.LAUNCHES.items()}
        recs = state.history
        _check_steps(f"{label} sem-only", recs)
        print(f"{label} sem-only: launches per step {launches}", flush=True)
        if any(r["is_predict_panop"] for r in recs):
            raise AssertionError(f"{label}: the pretraining steps predicted panoptic")
        _check_conv_launches(f"{label} sem-only", launches, RES_CONVS)
    n_timed = len(cols) - n_sem - 1
    state = train(cfg, cols[n_sem:n_sem + 1], device=dev, log=None, state=state,
                  pretrain_sem_steps=n_sem)                              # warm-up
    stats0 = {k: v.clone() for k, v in state.net.state_dict().items()
              if k.endswith((".mean", ".var"))}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    state = train(cfg, cols[n_sem + 1:], state=state, log=None, pretrain_sem_steps=n_sem)
    wall = time.perf_counter() - t0
    launches = {k: v / n_timed for k, v in kernels.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    recs = state.history[n_sem + 1:]
    _check_steps(label, recs)
    print(f"{label} (n_infers={S}): {wall / n_timed:.4f} s/step (host clock), device "
          f"{statistics.mean(r['device_ms'] for r in recs):.2f} ms/step, peak "
          f"{peak:.3f} GB, launches per step {launches}", flush=True)
    if not all(r["is_predict_panop"] for r in recs):
        raise AssertionError(f"{label}: a timed step skipped the panoptic losses")
    n_bn = sum(isinstance(m, BatchNorm) for m in state.net.modules())
    still = [k for k, v in stats0.items() if torch.equal(v, state.net.state_dict()[k])]
    if len(stats0) != 2 * n_bn or still:
        raise AssertionError(f"{label}: running statistics did not move: {still[:5]}")
    _check_conv_launches(label, launches, RES_CONVS + 6 * S)
    return dict(kernels.LAUNCHES)


def scene_inference_phase(cfg, net, scan):
    """``run_scene_inference`` on one scan (S + 1 outputs: the subnets,
    then the ensemble) and the ``Evaluator`` against the scan's
    labels; the summary's numbers must be finite (at random init they mean
    nothing)."""
    from pasco_torch.inference.pipeline import Evaluator, run_scene_inference

    col, inp = scan
    S = cfg.model.n_infers
    res = run_scene_inference(net, inp, col, cfg)
    n_seg = [len(o["segments_info"]) for o in res["outputs"]]
    print(f"run_scene_inference (n_infers={S}): {len(n_seg)} outputs, {n_seg} panoptic "
          f"segments, forward {res['inference_time']:.3f} s, ensemble "
          f"{res['ensemble_time']:.3f} s", flush=True)
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
        print(f"evaluator {name}: " + ", ".join(f"{k} {v:.6g}" for k, v in vals.items()),
              flush=True)
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"evaluator {name}: non-finite summary {vals}")
    print(f"evaluator: {time.perf_counter() - t0:.3f} s for {len(summary)} outputs",
          flush=True)


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pasco_tpu.core.config import PaSCoConfig
    from pasco_torch import kernels
    from pasco_torch.models.unet import build_net

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    kernels.lib()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)

    cfg = PaSCoConfig()
    scans = make_scans(cfg, N_SCANS, dev)
    gen = torch.Generator().manual_seed(0)
    rows = kernel_phases(cfg, scans[0][1], gen)
    rows.append(column_conv_phase(scan_masks(cfg, scans[0][1])[1], dev))

    net = build_net(cfg)
    net.reset_parameters(torch.Generator().manual_seed(0))
    net = net.to(dev)
    forward_phase(cfg, scans, net)
    rows.append(featurizer_phase(cfg, scans[0][1], net))
    scene_inference_phase(cfg, net, scans[0])
    del net, scans          # the MIMO forward's peak holds only its own state
    torch.cuda.empty_cache()

    # The MIMO ensemble: the slice's main path.
    cfg3 = cfg.replace(model=dataclasses.replace(cfg.model, n_infers=MIMO_S))
    net3 = build_net(cfg3)
    net3.reset_parameters(torch.Generator().manual_seed(0))
    net3 = net3.to(dev)
    scans3 = make_scans(cfg3, N_SCANS, dev, seed=1)
    launches = forward_phase(cfg3, scans3, net3, "MIMO forward")
    scene_inference_phase(cfg3, net3, scans3[0])
    del net3, scans3

    train_cols = train_scenes(cfg, 1 + N_TRAIN_STEPS)
    dx_row = train_conv_phase(cfg, train_cols[0], gen, dev)
    narrow_step_check(dev)
    train_phase(cfg, train_cols, dev)
    del train_cols
    train_launches = train_phase(cfg3, train_scenes(cfg3, 2 + N_MIMO_TRAIN_STEPS, seed=2),
                                 dev, n_sem=1, label="MIMO train")

    for r in rows:
        r.setdefault("launches", launches[r["name"]])
    dx_row["launches"] = train_launches["conv3_dx"]
    rows.append(dx_row)
    for r in rows:
        r["route"] = "cuda"
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
