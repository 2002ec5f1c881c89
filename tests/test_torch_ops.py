"""The port's kernel modules (their plain versions, on the CPU) against the
JAX reference: the XLA compositions in f32, and the Pallas entries in
interpret mode for one small shape each.

Tolerances: f32 comparisons hold at ``1e-4 * max|ref| + 1e-5`` at valid
cells (same math, another summation order); extraction is exact.  The
Pallas up-preamble rounds to bf16 inside the kernel whatever its inputs,
so that one comparison holds at the bf16 bound ``2e-2 * max|ref| + 2e-2``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pasco_tpu.core.sparse import Box as JBox
from pasco_tpu.ops import dense_ops as jd
from pasco_torch.core.sparse import Box
from pasco_torch.ops import dense_ops as td
from pasco_torch.ops.conv import masked_conv3
from pasco_torch.ops.deconv import up_preamble, up_tiles
from pasco_torch.ops.down import down2_fused, down_tiles
from pasco_torch.ops.extract import stream_extract

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def close_f32(got, ref, valid):
    """f32 bound at valid cells; ``got`` must be exact zero elsewhere."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    bound = 1e-4 * np.abs(ref[valid]).max() + 1e-5
    err = np.abs(got[valid] - ref[valid]).max()
    assert err <= bound, (err, bound)
    assert np.all(got[~valid] == 0)


def rand_affine(r, n):
    return ((r.rand(n) + 0.5).astype(np.float32), (r.randn(n) * 0.1).astype(np.float32))


# --------------------------------------------------------------------------
# plain twins of dense_ops
# --------------------------------------------------------------------------


def test_mask_and_coord_twins_match_jax():
    r = np.random.RandomState(0)
    mask = r.rand(8, 6, 10) < 0.3
    np.testing.assert_array_equal(
        td.maxpool2_mask(T(mask)).numpy(), np.asarray(jd.maxpool2_mask(mask)))
    np.testing.assert_array_equal(
        td.upsample2_mask(T(mask)).numpy(), np.asarray(jd.upsample2_mask(mask)))
    gmin = np.array([-8, 16, -4], np.int32)
    for stride in (1, 2, 4):
        box_t = Box.create(T(gmin), (32, 24, 16))
        box_j = JBox.create(gmin, (32, 24, 16))
        bmin, bmax = np.array([-2, 20, 0], np.int32), np.array([9, 31, 5], np.int32)
        np.testing.assert_array_equal(
            td.bbox_mask(box_t, stride, T(bmin), T(bmax)).numpy(),
            np.asarray(jd.bbox_mask(box_j, stride, bmin, bmax, "xzy")))
        np.testing.assert_array_equal(
            td.cell_coords(box_t, stride).numpy(),
            np.asarray(jd.cell_coords(box_j, stride, "xzy")))


def test_conv_down_deconv_twins_match_jax():
    r = np.random.RandomState(1)
    x = r.randn(4, 6, 8, 5).astype(np.float32)
    w27 = r.randn(27, 5, 3).astype(np.float32)
    w8 = r.randn(8, 5, 3).astype(np.float32)
    b = r.randn(3).astype(np.float32)
    ones = np.ones(x.shape[:3], bool)
    close_f32(td.conv3_dense(T(x), T(w27), T(b)).numpy(),
              jd.conv3_dense(x, w27, b, axis_order="xzy"), ones)
    close_f32(td.down2_dense(T(x), T(w8), T(b)).numpy(),
              jd.down2_dense(x, w8, b, axis_order="xzy"), ones[::2, ::2, ::2])
    close_f32(td.deconv2_dense(T(x), T(w8), T(b)).numpy(),
              jd.deconv2_dense(x, w8, b, axis_order="xzy"),
              np.ones((8, 12, 16), bool))


def test_scatter_max_rows_matches_jax():
    r = np.random.RandomState(2)
    f = r.randn(300, 4).astype(np.float32)
    idx = r.randint(0, 41, 300).astype(np.int32)   # 40 == dump row
    got = td.scatter_max_rows(T(f), T(idx), 40, -1e30).numpy()
    ref = np.asarray(jd.scatter_max_rows(f, idx, 40, np.float32(-1e30)))
    np.testing.assert_array_equal(got[:40], ref[:40])


# --------------------------------------------------------------------------
# kernel 1: masked_conv3
# --------------------------------------------------------------------------

CONV_FORMS = {
    "res_conv2": dict(bias=True, affine=True, relu_in=True, skip=True, relu_out=True),
    "res_conv1": dict(bias=True, affine=True, relu_in=True, skip=False, relu_out=False),
    "refiner_conv1": dict(bias=False, affine=False, relu_in=False, skip=False, relu_out=False),
}


@pytest.mark.parametrize("form", sorted(CONV_FORMS))
def test_masked_conv3_matches_xla(form):
    opt = CONV_FORMS[form]
    r = np.random.RandomState(3)
    X, Z, Y, ci, co = 6, 8, 10, 4, 5
    x = r.randn(X, Z, Y, ci).astype(np.float32)
    mask = r.rand(X, Z, Y) < 0.5
    w = (r.randn(27, ci, co) * 0.2).astype(np.float32)
    b = r.randn(co).astype(np.float32) if opt["bias"] else None
    a, c = rand_affine(r, ci)
    skip = r.randn(X, Z, Y, co).astype(np.float32) if opt["skip"] else None

    y = x * a + c if opt["affine"] else x
    y = np.maximum(y, 0) if opt["relu_in"] else y
    y = np.where(mask[..., None], y, 0)
    ref = jd.conv3_dense(jnp.asarray(y), w, b, axis_order="xzy")
    if skip is not None:
        ref = ref + skip
    if opt["relu_out"]:
        ref = jnp.maximum(ref, 0)

    got = masked_conv3(
        T(x), T(mask), T(w), None if b is None else T(b),
        affine=(T(a), T(c)) if opt["affine"] else None, relu_in=opt["relu_in"],
        skip=None if skip is None else T(skip), relu_out=opt["relu_out"])
    close_f32(got.numpy(), ref, np.broadcast_to(mask[..., None], got.shape))


def test_masked_conv3_matches_pallas_interpret():
    """A residual block (two chained convs) against fused_packed_conv."""
    from pasco_tpu.ops.pallas_conv import (
        active_tiles_xy, fused_packed_conv, pad_stage, stage_mask8)

    r = np.random.RandomState(5)
    X, Z, Y, C = 16, 8, 32, 4
    x = r.randn(X, Z, Y, C).astype(np.float32)
    mask = r.rand(X, Z, Y) > 0.5
    mask[8:] = False
    w1, w2 = ((r.randn(27, C, C) * 0.3).astype(np.float32) for _ in range(2))
    b1, b2 = (r.randn(C).astype(np.float32) for _ in range(2))
    (a1, c1), (a2, c2) = rand_affine(r, C), rand_affine(r, C)
    xp = jd.pack_z2(jnp.asarray(x))
    with pltpu.force_tpu_interpret_mode():
        m8 = stage_mask8(jnp.asarray(mask), 2 * C)
        ids, n = active_tiles_xy(jnp.asarray(mask).any(axis=1), 8, 16)
        xpad = pad_stage(xp)
        tile2 = lambda v: jnp.asarray(np.concatenate([v, v]))   # noqa: E731
        o1 = fused_packed_conv(xpad, w1, m8, ids, n, affine=(tile2(a1), tile2(c1)),
                               relu=True, bias=b1, out_padded=True)
        o2 = fused_packed_conv(o1, w2, m8, ids, n, affine=(tile2(a2), tile2(c2)),
                               relu=True, bias=b2, skip=xpad, out_padded=False)
    ref = np.asarray(jd.unpack_z2(o2[:, :, :Y]))

    xt, mt = T(x), T(mask)
    f = masked_conv3(xt, mt, T(w1), T(b1), affine=(T(a1), T(c1)), relu_in=True)
    got = masked_conv3(f, mt, T(w2), T(b2), affine=(T(a2), T(c2)), relu_in=True,
                       skip=xt, relu_out=True)
    close_f32(got.numpy(), np.where(mask[..., None], ref, 0),
              np.broadcast_to(mask[..., None], got.shape))


# --------------------------------------------------------------------------
# kernel 2: down2_fused
# --------------------------------------------------------------------------


def _down_inputs(r, X, Z, Y, ci, co):
    x = r.randn(X, Z, Y, ci).astype(np.float32)
    mask = r.rand(X, Z, Y) < 0.4
    x = np.where(mask[..., None], x, 0).astype(np.float32)   # producer-masked
    wd = (r.randn(8, ci, co) * 0.3).astype(np.float32)
    bd = (r.randn(co) * 0.1).astype(np.float32)
    return x, mask, wd, bd


def test_down2_fused_matches_xla():
    """Against the flax ``DenseDown`` module's XLA form at inference."""
    from pasco_tpu.models.dense_unet import DenseDown

    r = np.random.RandomState(6)
    X, Z, Y, ci, co = 8, 6, 10, 4, 6
    x, mask, wd, bd = _down_inputs(r, X, Z, Y, ci, co)
    bn = {k: dict(scale=(r.rand(co) + 0.5).astype(np.float32),
                  bias=(r.randn(co) * 0.1).astype(np.float32)) for k in ("bn1", "bn2")}
    stats = {k: dict(mean=(r.randn(co) * 0.1).astype(np.float32),
                     var=(r.rand(co) + 0.5).astype(np.float32)) for k in ("bn1", "bn2")}
    variables = {"params": dict(kernel=wd, bias=bd, **bn), "batch_stats": stats}
    ref, new_mask = DenseDown(co).apply(variables, jnp.asarray(x), jnp.asarray(mask), False)

    def affine(k):
        inv = bn[k]["scale"] / np.sqrt(stats[k]["var"] + 1e-5)
        return T(inv), T(bn[k]["bias"] - stats[k]["mean"] * inv)

    m2 = td.maxpool2_mask(T(mask))
    np.testing.assert_array_equal(m2.numpy(), np.asarray(new_mask))
    got = down2_fused(T(x), T(mask), m2, T(wd), T(bd), affine("bn1"), affine("bn2"))
    close_f32(got.numpy(), ref, np.broadcast_to(m2.numpy()[..., None], got.shape))


def test_down2_fused_matches_pallas_interpret():
    from pasco_tpu.ops.pallas_conv import pad_stage, stage_mask8
    from pasco_tpu.ops.pallas_down import down_padded_to_padded

    r = np.random.RandomState(7)
    X, Z, Y, ci, co = 32, 8, 64, 8, 16
    x, mask, wd, bd = _down_inputs(r, X, Z, Y, ci, co)
    (a1, c1), (a2, c2) = rand_affine(r, co), rand_affine(r, co)
    new_mask = np.asarray(jd.maxpool2_mask(mask))
    tile2 = lambda v: jnp.asarray(np.concatenate([v, v]))   # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        out = down_padded_to_padded(
            pad_stage(jd.pack_z2(jnp.asarray(x))), stage_mask8(jnp.asarray(mask), 2 * ci),
            jnp.asarray(new_mask.any(axis=1)), wd, bd, (tile2(a1), tile2(c1)),
            (tile2(a2), tile2(c2)), Y // 2, compute_dtype=jnp.float32)
    ref = np.asarray(jd.unpack_z2(out[1 : 1 + X // 2, 1 : 1 + Z // 4, 16 : 16 + Y // 2]))
    got = down2_fused(T(x), T(mask), T(new_mask), T(wd), T(bd), (T(a1), T(c1)),
                      (T(a2), T(c2)))
    valid = np.broadcast_to(new_mask[..., None], got.shape)
    close_f32(got.numpy(), np.where(valid, ref, 0), valid)


@pytest.mark.parametrize("p", [0.0, 1.0, 0.037])
def test_down_tiles_compacts_valid_cells(p):
    """The down kernel's product rows, compacted on the device: the valid
    output cells' flat indices first, ascending, and their count, against
    numpy on seeded masks (empty, full, and the 3.7% of valid cells of the
    scan's occupancy at enc_s2)."""
    m = np.random.RandomState(10).rand(12, 8, 22) < p
    tiles = down_tiles(T(m))
    want = np.flatnonzero(m)
    assert tiles.ids.dtype == torch.int32 and tiles.n_tiles == m.size
    assert int(tiles.n_active) == want.size
    np.testing.assert_array_equal(tiles.ids[: want.size].numpy(), want)


@pytest.mark.parametrize("p", [0.0, 1.0, 0.01])
def test_up_tiles_lists_active_tiles_first(p):
    """The up kernel's tiles of 64 flat parents: those with a child in the
    union first, ascending, then the rest, and the active count."""
    union = np.random.RandomState(11).rand(10, 6, 44) < p     # 330 parents
    tiles = up_tiles(T(union))
    par = union.reshape(5, 2, 3, 2, 22, 2).any(axis=(1, 3, 5)).ravel()
    active = np.pad(par, (0, (-par.size) % 64)).reshape(-1, 64).any(axis=1)
    n = int(tiles.n_active)
    ids = tiles.ids.numpy()
    assert tiles.n_tiles == active.size == ids.size and n == active.sum()
    np.testing.assert_array_equal(ids[:n], np.flatnonzero(active))
    np.testing.assert_array_equal(np.sort(ids[n:]), np.flatnonzero(~active))


# --------------------------------------------------------------------------
# kernel 3: up_preamble
# --------------------------------------------------------------------------


def _up_inputs(r, X2, Z2, Y2, ci, co):
    return dict(
        parent=r.randn(X2, Z2, Y2, ci).astype(np.float32),
        parent_keep=r.rand(X2, Z2, Y2) < 0.6,
        skip_mask=r.rand(2 * X2, 2 * Z2, 2 * Y2) < 0.3,
        skip=r.randn(2 * X2, 2 * Z2, 2 * Y2, co).astype(np.float32),
        wd=(r.randn(8, ci, co) * 0.3).astype(np.float32),
        bd=(r.randn(co) * 0.1).astype(np.float32),
        up=rand_affine(r, co), resize=rand_affine(r, co + 3),
        wr=(r.randn(co + 3, co) * 0.3).astype(np.float32),
        br=(r.randn(co) * 0.1).astype(np.float32),
    )


def _up_port(d, box, scale, child, union):
    skip = np.where(d["skip_mask"][..., None], d["skip"], 0).astype(np.float32)
    return up_preamble(
        T(d["parent"]), T(d["parent_keep"]), T(child), T(union), T(skip), box,
        scale, T(d["wd"]), T(d["bd"]), tuple(map(T, d["up"])),
        tuple(map(T, d["resize"])), T(d["wr"]), T(d["br"]))


@pytest.mark.parametrize("scale", [1, 2])
def test_up_preamble_matches_xla(scale):
    """Against the decoder preamble composed from the reference's XLA ops,
    with a negative box corner (absolute coords)."""
    r = np.random.RandomState(8)
    X2, Z2, Y2, ci, co = 3, 2, 4, 5, 6
    d = _up_inputs(r, X2, Z2, Y2, ci, co)
    gmin = np.array([-16, -8, -24], np.int32)
    extent = (2 * X2 * scale, 2 * Y2 * scale, 2 * Z2 * scale)
    box_j = JBox.create(gmin, extent)
    child = np.asarray(jd.upsample2_mask(d["parent_keep"])) & (r.rand(2 * X2, 2 * Z2, 2 * Y2) < 0.8)
    union = child | d["skip_mask"]

    xm = np.where(d["parent_keep"][..., None], d["parent"], 0)
    x = jd.deconv2_dense(jnp.asarray(xm), d["wd"], d["bd"], axis_order="xzy")
    x = x * d["up"][0] + d["up"][1]
    x = jnp.where(x > 0, x, 0.01 * x)
    coords = jd.cell_coords(box_j, scale, "xzy").astype(jnp.float32) / scale
    xc = jnp.concatenate([x, coords], axis=-1) * d["resize"][0] + d["resize"][1]
    res = jnp.dot(xc, d["wr"]) + d["br"]
    skip = np.where(d["skip_mask"][..., None], d["skip"], 0)
    ref = jnp.where(child[..., None], res, 0) + skip

    got = _up_port(d, Box.create(T(gmin), extent), scale, child, union)
    close_f32(got.numpy(), ref, np.broadcast_to(union[..., None], got.shape))


def test_up_preamble_matches_pallas_interpret():
    from pasco_tpu.ops.pallas_deconv import up_preamble_padded

    r = np.random.RandomState(9)
    X2, Z2, Y2, ci, co = 8, 2, 32, 4, 4
    d = _up_inputs(r, X2, Z2, Y2, ci, co)
    d["parent_keep"][:] = True    # the TPU kernel reads a pre-masked parent
    X, Z, Y = 2 * X2, 2 * Z2, 2 * Y2
    child = r.rand(X, Z, Y) < 0.7
    union = child | d["skip_mask"]
    gmin = np.array([-8, 4, 2], np.int32)
    box = Box.create(T(gmin), (X, Y, Z))
    skip = np.where(d["skip_mask"][..., None], d["skip"], 0).astype(np.float32)
    # packed lanes: [co | co] for up_bn, [co, 3 coords | co, 3 coords] for resize_bn
    tile2 = lambda v: jnp.asarray(np.concatenate([v, v]))   # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        out = up_preamble_padded(
            jd.pack_z2(jnp.asarray(d["parent"], jnp.bfloat16)),
            jd.pack_z2(jnp.asarray(skip, jnp.bfloat16)),
            jnp.asarray(union.any(axis=1)), jnp.asarray(gmin), 1, d["wd"], d["bd"],
            (tile2(d["up"][0]), tile2(d["up"][1])),
            (tile2(d["resize"][0]), tile2(d["resize"][1])),
            d["wr"], d["br"], child_m8=_child_m8(child, co))
    ref = np.asarray(jd.unpack_z2(out[1 : 1 + X, 1 : 1 + Z // 2, 16 : 16 + Y])
                     .astype(jnp.float32))
    d["parent"] = np.asarray(jnp.asarray(d["parent"], jnp.bfloat16).astype(jnp.float32))
    d["skip"] = np.asarray(jnp.asarray(d["skip"], jnp.bfloat16).astype(jnp.float32))
    got = _up_port(d, box, 1, child, union).numpy()
    valid = np.broadcast_to(union[..., None], got.shape)
    ref = np.where(valid, ref, 0)
    err = np.abs(got - ref)[valid].max()
    assert err <= 2e-2 * np.abs(ref[valid]).max() + 2e-2, err
    assert np.all(got[~valid] == 0)


def _child_m8(child, co):
    """The padded int8 child mask of the TPU kernel for a logical
    [X, Z, Y] child set: lanes [z even | z odd] per packed row."""
    X, Z, Y = child.shape
    ypad = Y + (-Y) % 16 + 32
    m = np.zeros((X + 2, Z // 2 + 2, ypad, 2 * co), np.int8)
    m[1 : 1 + X, 1 : 1 + Z // 2, 16 : 16 + Y, :co] = child[:, 0::2, :, None]
    m[1 : 1 + X, 1 : 1 + Z // 2, 16 : 16 + Y, co:] = child[:, 1::2, :, None]
    return jnp.asarray(m)


# --------------------------------------------------------------------------
# kernel 4: stream_extract
# --------------------------------------------------------------------------


# (cap, with_extra, keep, shape); cap None = the kept count.  The kernel's
# tile is 16384 cells: 8 x 6 x 12 is less than one, 13 x 29 x 61 more than
# one and not a multiple.
EXTRACT_CASES = [
    pytest.param(4096, True, "random", (8, 6, 12), id="4096-True"),
    pytest.param(4096, False, "random", (8, 6, 12), id="4096-False"),
    pytest.param(300, True, "random", (8, 6, 12), id="300-True"),
    pytest.param(64, True, "empty", (8, 6, 12), id="empty keep"),
    pytest.param(200, True, "full", (8, 6, 12), id="all kept, cap < total"),
    pytest.param(None, True, "random", (8, 6, 12), id="cap == total"),
    pytest.param(6000, True, "random", (13, 29, 61), id="ragged n"),
]


@pytest.mark.parametrize("cap,with_extra,kind,shape", EXTRACT_CASES)
def test_stream_extract_matches_xla(cap, with_extra, kind, shape):
    """Same rows in the same order as ``extract_sparse`` (also when the
    capacity binds, equals the kept count, or nothing is kept), same
    coords, same payload bits."""
    r = np.random.RandomState(10)
    (X, Z, Y), C, E = shape, 5, 3
    keep = {"random": r.rand(X, Z, Y) < 0.4, "empty": np.zeros((X, Z, Y), bool),
            "full": np.ones((X, Z, Y), bool)}[kind]
    cap = int(keep.sum()) if cap is None else cap
    feats = r.randn(X, Z, Y, C).astype(np.float32)
    extra = r.randn(X, Z, Y, E).astype(np.float32) if with_extra else None
    gmin = np.array([-8, 16, -4], np.int32)
    box_j = JBox.create(gmin, (X * 2, Y * 2, Z * 2))
    box_t = Box.create(T(gmin), (X * 2, Y * 2, Z * 2))
    # jnp inputs: the reference's gather clamps the source index of rows
    # past the kept count (beyond n when n is not a multiple of 32), as
    # under jit; those rows are masked to zero
    grid, ex = jd.extract_sparse(jnp.asarray(feats), keep, box_j, 2, cap,
                                 extra=None if extra is None else jnp.asarray(extra),
                                 axis_order="xzy")
    coords, valid_t, vals_t = td.extract_sparse(T(keep), box_t, 2, cap, T(feats))
    np.testing.assert_array_equal(coords.numpy(), np.asarray(grid.coords))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(grid.mask))
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(grid.feats))
    if with_extra:
        _, _, e_t = td.extract_sparse(T(keep), box_t, 2, cap, T(extra))
        np.testing.assert_array_equal(e_t.numpy(), np.asarray(ex))
    else:
        coords0, _, v0 = td.extract_sparse(T(keep), box_t, 2, cap)
        np.testing.assert_array_equal(coords0.numpy(), np.asarray(grid.coords))
        assert v0.shape == (cap, 0)
    vals, src, valid, total = stream_extract(T(keep), cap, T(feats))
    assert int(total) == int(keep.sum())
    n = min(cap, int(keep.sum()))
    assert int(valid.sum()) == n and bool(valid[:n].all())
    np.testing.assert_array_equal(src[:n].numpy(), np.flatnonzero(keep)[:n])
    assert not vals[n:].any() and not src[n:].any()


def test_stream_extract_workspace_epochs():
    """The kernel's scratch: grows (zeroed) only for more tiles, a new
    epoch on every call, never 0, and zeroed again when the 32-bit epoch
    would wrap (a flag word of an old call could carry it)."""
    from pasco_torch.ops.extract import _Workspace

    ws = _Workspace()
    buf, tiles, e1 = ws.take(5, torch.device("cpu"))
    assert tiles == 5 and buf.shape == (5,) and not buf.any() and e1 == 1
    buf.fill_(7)
    buf2, tiles, e2 = ws.take(3, torch.device("cpu"))
    assert buf2 is buf and tiles == 5 and e2 == 2
    buf3, tiles, e3 = ws.take(9, torch.device("cpu"))
    assert tiles == 9 and buf3.shape == (9,) and not buf3.any() and e3 == 3
    buf3.fill_(7)
    ws.epoch = (1 << 32) - 1
    buf4, _, e4 = ws.take(9, torch.device("cpu"))
    assert buf4 is buf3 and e4 == 1 and not buf4.any()


def test_stream_extract_matches_pallas_interpret():
    """Same kept cells and payload as stream_extract_z2 (whose TPU row
    order differs: compare cell-keyed)."""
    from pasco_tpu.ops.pallas_extract import stream_extract_z2

    r = np.random.RandomState(11)
    X, Z, Y, E = 8, 8, 128, 10
    keep = r.rand(X, Z, Y) < 0.3
    payload = r.randn(X, Z, Y, E).astype(np.float32)
    pay_bf = jnp.asarray(payload, jnp.bfloat16)
    cap = 4096
    with pltpu.force_tpu_interpret_mode():
        v, s, m, tot = jax.jit(stream_extract_z2, static_argnums=1)(
            jnp.asarray(keep), cap, jd.pack_z2(pay_bf))
    v = np.asarray(v.astype(jnp.float32))
    s, m = np.asarray(s), np.asarray(m)
    ref = {int(s[i]): v[i] for i in np.nonzero(m)[0]}

    vals, src, valid, total = stream_extract(
        T(keep), cap, torch.from_numpy(payload).to(torch.bfloat16))
    assert int(total) == int(tot) == int(keep.sum())
    got = {int(src[i]): vals[i].float().numpy() for i in np.nonzero(valid.numpy())[0]}
    assert set(got) == set(ref)
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])


# --------------------------------------------------------------------------
# training: MaskedConv3Fn (the port of packed_conv_trainable)
# --------------------------------------------------------------------------


def _train_conv_inputs(seed, X=16, Z=8, Y=32, C=4, D=4):
    r = np.random.RandomState(seed)
    x = r.randn(X, Z, Y, C).astype(np.float32)
    mask = r.rand(X, Z, Y) > 0.5
    mask[8:] = False
    w = (r.randn(27, C, D) * 0.1).astype(np.float32)
    b = (r.randn(D) * 0.1).astype(np.float32)
    g = r.randn(X, Z, Y, D).astype(np.float32)
    return x, mask, w, b, g


def _port_grads(fn, x, mask, w, b, g):
    xt, wt, bt = (T(a).requires_grad_() for a in (x, w, b))
    y = fn(xt, T(mask), wt, bt)
    (y * T(g)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy(), bt.grad.numpy()


def test_masked_conv3_fn_matches_packed_conv_trainable():
    """Forward and x/w/b gradients of MaskedConv3Fn against the custom-VJP
    Pallas conv (interpret mode), for a loss that reads mask-valid cells
    (the packed path's contract), compared at mask-valid cells; dx is
    exactly zero elsewhere."""
    from pasco_tpu.ops.pallas_conv import packed_conv_trainable
    from pasco_torch.ops.conv import MaskedConv3Fn

    x, mask, w, b, g = _train_conv_inputs(12)
    gm = np.where(mask[..., None], g, 0).astype(np.float32)

    def loss(x_, w_, b_):
        y = packed_conv_trainable(x_, w_, b_, jnp.asarray(mask), True, None)
        return jnp.sum(y * jd.pack_z2(jnp.asarray(gm))), y

    with pltpu.force_tpu_interpret_mode():
        (_, y_ref), (dx, dw, db) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            jd.pack_z2(jnp.asarray(x)), jnp.asarray(w), jnp.asarray(b))
    y, gx, gw, gb = _port_grads(
        lambda *a: MaskedConv3Fn.apply(*a, None), x, mask, w, b, gm)
    valid = np.broadcast_to(mask[..., None], y.shape)
    close_f32(y, np.where(valid, np.asarray(jd.unpack_z2(y_ref)), 0), valid)
    close_f32(gx, np.asarray(jd.unpack_z2(dx)), np.broadcast_to(mask[..., None], gx.shape))
    close_f32(gw, dw, np.ones(gw.shape, bool))
    close_f32(gb, db, np.ones(gb.shape, bool))


@pytest.mark.parametrize("bias", [True, False])
def test_masked_conv3_fn_matches_plain_autograd(bias):
    """Against autograd through ``masked_conv3_plain``: checks the tap flip
    of the data gradient and the per-tap weight gradient (ragged extents,
    Ci != Co); ``bias=None`` gives no bias gradient."""
    from pasco_torch.ops.conv import MaskedConv3Fn, masked_conv3_plain

    x, mask, w, b, g = _train_conv_inputs(13, X=5, Z=6, Y=7, C=3, D=5)
    plain = lambda x_, m, w_, b_: masked_conv3_plain(x_, m, w_, b_ if bias else None)  # noqa: E731
    fn = lambda x_, m, w_, b_: MaskedConv3Fn.apply(x_, m, w_, b_ if bias else None, None)  # noqa: E731
    ref = _port_grads(plain, x, mask, w, b, g) if bias else None
    if not bias:
        xt, wt, bt = (T(a).requires_grad_() for a in (x, w, b))
        (plain(xt, T(mask), wt, bt) * T(g)).sum().backward()
        ref = (None, xt.grad.numpy(), wt.grad.numpy(), None)
    xt, wt, bt = (T(a).requires_grad_() for a in (x, w, b))
    y = fn(xt, T(mask), wt, bt)
    (y * T(g)).sum().backward()
    valid = np.broadcast_to(mask[..., None], xt.shape)
    close_f32(xt.grad.numpy(), ref[1], valid)
    close_f32(wt.grad.numpy(), ref[2], np.ones(w.shape, bool))
    if bias:
        close_f32(bt.grad.numpy(), ref[3], np.ones(b.shape, bool))
    else:
        assert bt.grad is None


# --------------------------------------------------------------------------
# training: cap, dropout, differentiable extraction
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [50, 400, 5000])
def test_cap_keep_gumbel_same_keep_set(cap):
    """The same Gumbel noise gives the reference's keep set, with the cap
    binding (50, 400) and not (5000)."""
    r = np.random.RandomState(14)
    keep = r.rand(10, 8, 12) < 0.6
    score = (r.rand(10, 8, 12) * r.choice([0.0, 1.0, 5.0], (10, 8, 12))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jd.cap_keep_gumbel(jnp.asarray(keep), jnp.asarray(score), cap, key))
    noise = np.asarray(jax.random.gumbel(key, keep.shape, jnp.float32))
    got = td.cap_keep_gumbel(T(keep), T(score), cap, noise=T(noise)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.sum() <= max(cap + 5, 0) or got.sum() == keep.sum()
    if cap < keep.sum():
        g = torch.Generator().manual_seed(0)
        drawn = td.cap_keep_gumbel(T(keep), T(score), cap, generator=g)
        assert abs(int(drawn.sum()) - cap) <= 5 and not (drawn & ~T(keep)).any()


def test_point_dropout_drops_at_most_rate():
    pm = torch.arange(4000) < 3000
    g = torch.Generator().manual_seed(0)
    out = td.point_dropout(pm, 0.05, g)
    assert not (out & ~pm).any()
    assert 0.9 * 3000 <= int(out.sum()) <= 3000


def test_extract_sparse_train_rows_and_gradient():
    """Same coords and payload rows as the reference's XLA extraction (cap
    binding), and the gradient lands on the kept cells' payload rows."""
    r = np.random.RandomState(15)
    X, Z, Y, E, cap = 8, 6, 12, 3, 200
    keep = r.rand(X, Z, Y) < 0.4
    pay = r.randn(X, Z, Y, E).astype(np.float32)
    gmin = np.array([-8, 16, -4], np.int32)
    grid, ex = jd.extract_sparse(pay, keep, JBox.create(gmin, (2 * X, 2 * Y, 2 * Z)), 2,
                                 cap, extra=pay, axis_order="xzy")
    pt = T(pay).requires_grad_()
    coords, valid, vals = td.extract_sparse_train(
        T(keep), Box.create(T(gmin), (2 * X, 2 * Y, 2 * Z)), 2, cap, pt)
    np.testing.assert_array_equal(coords.numpy(), np.asarray(grid.coords))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(grid.mask))
    np.testing.assert_array_equal(vals.detach().numpy(), np.asarray(ex))
    vals.sum().backward()
    first = np.cumsum(keep.reshape(-1)).reshape(keep.shape) <= cap
    np.testing.assert_array_equal(pt.grad.numpy(), np.broadcast_to(
        (keep & first)[..., None], pay.shape).astype(np.float32))
