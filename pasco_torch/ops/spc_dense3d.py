"""Kernel 9: ``spc_dense3d``, the dense bottleneck ``SPCDense3D`` at
inference (replaces no TPU kernel: the reference runs its eleven convs as
XLA convolutions, ``pasco_tpu/models/bottleneck.py:zfold_conv3d``).

Each branch is ``v = relu(a * conv(input) + c)``, the eval BatchNorm folded
to a per-channel f32 affine ``(a, c)`` on the f32 conv sum; operands are
bf16, sums f32.  The eleven convs run in four launches, one per input
volume (:data:`GROUPS`):

    x1 = v_a1(x);  P = ((x1 + v_r1(x)) + v_r2(x)) + v_r3(x)
    t  = (v_a2(x1) + v_a3(x1)) + v_a4(x1);  S = x1 + t
    s  = S + ((v_a5(t) + v_a6(t)) + v_a7(t))
    out = v_ch1(s) + P

where ``x1``, ``t`` and ``s`` are read by the next launch as bf16.  A CPU
tensor takes :func:`spc_dense3d_plain`; a CUDA tensor launches
``csrc/spc_dense3d.cu`` four times or raises.  A batch of scans is in every
launch.  The kernel note is at the top of the CUDA source.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from pasco_torch import kernels
from pasco_torch.utils import timing

Pair = Tuple[torch.Tensor, torch.Tensor]

# The convs of each launch, by the input they read: x, x1, t, s.
GROUPS = (("a1", "r1", "r2", "r3"), ("a2", "a3", "a4"), ("a5", "a6", "a7"), ("ch1",))
WIDTHS = (64, 128, 192, 256)   # Ci = Co the kernel takes


def pack_affines(affines: Dict[str, Pair]) -> Tuple[torch.Tensor, ...]:
    """The f32 ``(a, c)`` affines by conv name as the kernel reads them: one
    ``[G, 2, C]`` tensor a launch, in :data:`GROUPS` order."""
    return tuple(torch.stack([torch.stack([affines[n][0], affines[n][1]]) for n in group])
                 .float().contiguous() for group in GROUPS)


def _conv(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'Same' conv of ``v [B, X, Z, Y, C]`` (f32) by ``w [kx, ky, kz, C, D]``
    (f32) as one f32 product a tap, in f32.  A tap whose z offset reaches
    only the padding for an output plane is not computed for it."""
    B, X, Z, Y, _ = v.shape
    kx, ky, kz = w.shape[:3]
    rx, ry, rz = kx // 2, ky // 2, kz // 2
    vp = torch.nn.functional.pad(v, (0, 0, ry, ry, 0, 0, rx, rx))
    acc = torch.zeros((B, X, Z, Y, w.shape[-1]), dtype=torch.float32, device=v.device)
    for iz in range(kz):
        dz = iz - rz
        lo, hi = max(0, -dz), min(Z, Z - dz)
        if lo >= hi:
            continue
        for ix in range(kx):
            for iy in range(ky):
                acc[:, :, lo:hi] += vp[:, ix:ix + X, lo + dz:hi + dz, iy:iy + Y] @ w[ix, iy, iz]
    return acc


def spc_dense3d_plain(x: torch.Tensor, weights: Dict[str, torch.Tensor],
                      affines: Tuple[torch.Tensor, ...], dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """The same function in plain PyTorch with the kernel's arithmetic:
    ``x [B, X, Z, Y, C]``, the ``[kx, ky, kz, C, C]`` kernels by conv name
    and the :func:`pack_affines` affines; every conv operand rounded to
    ``dtype`` (bf16 as in the kernel; float32 rounds nothing), f32 products
    and sums in the kernel's order.  Returns f32 ``[B, X, Z, Y, C]``."""
    where = {n: (i, j) for i, group in enumerate(GROUPS) for j, n in enumerate(group)}

    def rnd(t):
        return t.to(dtype).float()

    def cbr(v, name):
        i, j = where[name]
        a, c = affines[i][j].to(v.device)
        return torch.relu(a * _conv(v, rnd(weights[name])) + c)

    xr = rnd(x)
    x1 = cbr(xr, "a1")
    p = x1 + cbr(xr, "r1")
    p = p + cbr(xr, "r2")
    p = p + cbr(xr, "r3")
    x1r = rnd(x1)
    t = cbr(x1r, "a2")
    t = t + cbr(x1r, "a3")
    t = t + cbr(x1r, "a4")
    tr = rnd(t)
    u = cbr(tr, "a5")
    u = u + cbr(tr, "a6")
    u = u + cbr(tr, "a7")
    s = rnd((x1 + t) + u)
    return cbr(s, "ch1") + p


def spc_dense3d(x: torch.Tensor, weights: Dict[str, torch.Tensor],
                affines: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """``SPCDense3D`` at inference on ``x [B, X, Z, Y, C]``: bf16 and
    contiguous on the card, ``C`` in :data:`WIDTHS`; the kernels ``[kx, ky,
    kz, C, C]`` by conv name in any float dtype (cast to bf16 a launch at a
    time) and the :func:`pack_affines` affines.  Returns f32 ``[B, X, Z, Y,
    C]``."""
    if not x.is_cuda:
        return spc_dense3d_plain(x, weights, affines)
    if x.dim() != 5:
        raise ValueError(f"spc_dense3d takes [B, X, Z, Y, C], got {tuple(x.shape)}")
    B, X, Z, Y, ch = x.shape
    dev = x.device
    kernels.require(x, "x", torch.bfloat16)
    if ch not in WIDTHS:
        raise ValueError(f"spc_dense3d takes C in {WIDTHS}, got {ch}")
    for name in (n for g in GROUPS for n in g):
        k = weights[name]
        if k.dim() != 5 or tuple(k.shape[3:]) != (ch, ch) or not all(s % 2 for s in k.shape[:3]):
            raise ValueError(f"spc_dense3d: {name} kernel {tuple(k.shape)} is not "
                             f"[kx, ky, kz, {ch}, {ch}] with odd extents")
    if x.data_ptr() % 16:
        raise ValueError("spc_dense3d needs a 16-byte aligned x")
    lib = kernels.lib()
    for group in GROUPS:
        rx = max(weights[n].shape[0] // 2 for n in group)
        ry = max(weights[n].shape[1] // 2 for n in group)
        if lib.pasco_spc_dense3d_smem(X, Y, ch, len(group), rx, ry) == 0:
            raise ValueError(f"spc_dense3d: a {X} x {Y} plane is too wide for the "
                             f"kernel's halo at C = {ch}")

    def empty(dtype):
        return torch.empty(x.shape, dtype=dtype, device=dev)

    x1b, t_b, s_b = (empty(torch.bfloat16) for _ in range(3))
    s_f, p_f, scr, out = (empty(torch.float32) for _ in range(4))
    # (input, first_b, first_f, addend, sum_b, res_f, res_b, scratch) of
    # each launch; the scratch holds a launch's running sum
    outputs = ((x, x1b, s_f, None, None, p_f, None, scr),
               (x1b, None, None, s_f, t_b, s_f, None, scr),
               (t_b, None, None, s_f, None, None, s_b, scr),
               (s_b, None, None, p_f, None, out, None, None))
    for group, aff, (inp, *bufs) in zip(GROUPS, affines, outputs):
        with timing.span("kernel.spc_dense3d", events=False):
            _launch(lib, inp, group, weights, aff, bufs)
        kernels.LAUNCHES["spc_dense3d"] += 1
    return out


def _launch(lib, x, group, weights, aff, bufs):
    """One launch over the convs of ``group`` (the caller counts it)."""
    B, X, Z, Y, ch = x.shape
    dev = x.device
    ws = [weights[n].to(device=dev, dtype=torch.bfloat16).contiguous() for n in group]
    kernels.require(aff, "affine", torch.float32, (len(group), 2, ch), dev)
    ks = [e for w in ws for e in w.shape[:3]] + [1, 1, 1] * (4 - len(ws))
    ptrs = [w.data_ptr() for w in ws] + [None] * (4 - len(ws))
    err = lib.pasco_spc_dense3d(
        x.data_ptr(), *ptrs, aff.data_ptr(), *(kernels.ptr(b) for b in bufs),
        len(group), *ks, B, X, Z, Y, ch, kernels.stream_ptr(x))
    kernels.check(err, "spc_dense3d")
