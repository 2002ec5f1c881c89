"""The dense bottleneck's kernel arithmetic on the CPU
(``pasco_torch/ops/spc_dense3d.py:spc_dense3d_plain``, the plain version of
``csrc/spc_dense3d.cu``: BN folded to an affine on the f32 conv sum, f32
branch sums in the kernel's order, the taps that reach only the z padding
skipped) against ``SPCDense3D``'s composition (``F.conv3d``, BatchNorm,
ReLU) and against the JAX reference's ``SPCDense3D`` / ``zfold_conv3d`` in
float32, at small widths and at Z = 1, 2 and 4, where the (5, 5, 3) and
(7, 7, 5) kernels overhang the padding; and the module's affine cache
after ``load_state_dict``.

Tolerances: float32 on both sides holds at ``1e-4 * max|ref| + 1e-5``
(same math, another summation order); bf16 operands against the
composition, which also rounds every conv's output to bf16 before its BN,
at ``2e-2 * max|ref| + 2e-2``.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import spc_module, spc_weights
from pasco_tpu.models import bottleneck as jb
from pasco_torch.models.bottleneck import SPCDense3D
from pasco_torch.ops import spc_dense3d as sd

torch.set_num_threads(1)

# [B, X, Y, Z] grids: the stride-8 z extents 4 (the flagship box), 2 (the
# narrow test box) and 1, with x and y ragged against the kernel's tiles.
GRIDS = [(1, 6, 5, 4), (2, 4, 7, 2), (1, 5, 3, 1)]


def _input(grid, ch, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed + 100)
    return torch.randn((*grid, ch), generator=g).to(dtype).float()   # [B, X, Y, Z, C]


def _plain(m, x, dtype):
    """The plain version on the module's parameters: ``x [B, X, Y, Z, C]``
    in the kernel's ``[B, X, Z, Y, C]`` layout and back."""
    out = sd.spc_dense3d_plain(x.permute(0, 1, 3, 2, 4), spc_weights(m), m.affines(), dtype)
    return out.permute(0, 1, 3, 2, 4)


def _close(got, ref, rel, ab):
    err = (got.double() - ref.double()).abs().max().item()
    assert err <= rel * ref.abs().max().item() + ab, err


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("kernel", [(3, 3, 1), (5, 5, 3), (7, 7, 5), (1, 1, 1), (3, 5, 5)])
def test_conv_skipping_padding_taps_equals_conv3d(grid, kernel):
    """A conv with the padding-only taps skipped is the zero-padded
    ``F.conv3d`` (those taps add exact zeros)."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn((*grid, 8), generator=g)                 # [B, X, Y, Z, C]
    w = torch.randn((*kernel, 8, 6), generator=g)
    ref = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                   padding=tuple(k // 2 for k in kernel)).permute(0, 2, 3, 4, 1)
    got = sd._conv(x.permute(0, 1, 3, 2, 4), w).permute(0, 1, 3, 2, 4)
    _close(got, ref, 1e-5, 1e-5)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("ch", [8, 16])
def test_plain_matches_composition_f32(grid, ch):
    """At float32 operands the kernel's arithmetic is the composition's."""
    m = spc_module(ch, 2)
    x = _input(grid, ch, 2)
    with torch.no_grad():
        ref = m(x, torch.float32)
    _close(_plain(m, x, torch.float32), ref, 1e-4, 1e-5)


@pytest.mark.parametrize("grid", GRIDS)
def test_plain_matches_composition_bf16(grid):
    """At bf16 operands: the composition also rounds each conv's sum to
    bf16 before its BN; the kernel's sums stay f32."""
    m = spc_module(16, 3)
    x = _input(grid, 16, 3, torch.bfloat16)
    with torch.no_grad():
        ref = m(x, torch.bfloat16)
        got = _plain(m, x, torch.bfloat16)
    _close(got, ref, 2e-2, 2e-2)
    assert got.dtype == torch.float32


def _jax_variables(m):
    params, stats = {}, {}
    for name in m.KERNELS:
        params[f"{name}_conv"] = {"kernel": getattr(m, f"{name}_conv").kernel.detach().numpy()}
        bn = getattr(m, f"{name}_bn")
        params[f"{name}_bn"] = {"scale": bn.scale.detach().numpy(),
                                "bias": bn.bias.detach().numpy()}
        stats[f"{name}_bn"] = {"mean": bn.mean.numpy(), "var": bn.var.numpy()}
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("grid", GRIDS)
def test_plain_matches_jax_reference_f32(grid):
    """The reference's ``SPCDense3D`` (its convs through ``zfold_conv3d``
    at Z <= 8, the (3, 3, 1) ones by x-y taps) in float32 at eval."""
    ch = 8
    m = spc_module(ch, 4)
    x = _input(grid, ch, 4)
    ref = jb.SPCDense3D().apply(_jax_variables(m), jnp.asarray(x.numpy()), False)
    with torch.no_grad():
        got = _plain(m, x, torch.float32)
    _close(got, torch.from_numpy(np.asarray(ref)), 1e-4, 1e-5)


def test_zfold_conv3d_matches_plain_conv():
    """One (7, 7, 5) conv at Z = 4 (taps two planes past either face):
    the reference's ``zfold_conv3d`` against the plain version's conv."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((1, 6, 5, 4, 8), generator=g)
    w = torch.randn((7, 7, 5, 8, 8), generator=g) * 0.05
    ref = jb.zfold_conv3d(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()))
    got = sd._conv(x.permute(0, 1, 3, 2, 4), w).permute(0, 1, 3, 2, 4)
    _close(got, torch.from_numpy(np.asarray(ref)), 1e-4, 1e-5)


def test_kernel_route_follows_load_state_dict(monkeypatch):
    """The module's kernel route (forced on the CPU, where the wrapper takes
    the plain version): after a forward, ``load_state_dict`` of other BN
    statistics and kernels changes the next forward's output to that of a
    fresh module holding them, so no affine or weight copy goes stale."""
    monkeypatch.setattr(SPCDense3D, "takes_kernel", lambda self, x, cd: True)
    m = spc_module(8, 6)
    other = spc_module(8, 7)
    x = _input(GRIDS[0], 8, 6, torch.bfloat16)
    with torch.no_grad():
        before = m(x, torch.bfloat16)
        assert torch.equal(m(x, torch.bfloat16), before)
        m.load_state_dict(other.state_dict())
        after = m(x, torch.bfloat16)
        want = other(x, torch.bfloat16)
        assert not torch.equal(after, before)
        assert torch.equal(after, want)
        # one BN's running variance updated in place
        m.a4_bn.var.mul_(2.0)
        moved = m(x, torch.bfloat16)
    assert not torch.equal(moved, after)


def test_takes_kernel_only_at_inference():
    """The route: a CUDA input in eval mode at bf16 operands with no
    gradient required takes the kernel; a CPU input, training mode, float32
    operands or a required gradient keep the composition."""
    m = SPCDense3D(8).eval()
    cuda = SimpleNamespace(is_cuda=True, requires_grad=False)
    with torch.no_grad():
        assert m.takes_kernel(cuda, torch.bfloat16)
        assert not m.takes_kernel(SimpleNamespace(is_cuda=False, requires_grad=False),
                                  torch.bfloat16)
        assert not m.takes_kernel(cuda, torch.float32)
        assert not m.train().takes_kernel(cuda, torch.bfloat16)
    m.eval()
    assert not m.takes_kernel(cuda, torch.bfloat16)    # the parameters require a gradient
    m.requires_grad_(False)
    assert m.takes_kernel(cuda, torch.bfloat16)
    assert not m.takes_kernel(SimpleNamespace(is_cuda=True, requires_grad=True), torch.bfloat16)
