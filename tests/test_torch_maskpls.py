"""The port's kNN (``pasco_torch/ops/knn.py``) and MaskPLS modules
(``pasco_torch/models/maskpls.py``) against ``pasco_tpu``'s on seeded
numpy inputs in f32 on the CPU.

* ``knn``: indices identical (duplicate reference points make exact ties,
  which both break toward the lower index), distances within ``1e-5 *
  max|ref|``; ``knn_up`` within ``1e-5 * max|ref| + 1e-6``.
* ``ResidualBlockOriginal``, ``ASPP`` and ``MaskPLSEncoderDecoder`` on
  weights carried by ``flax_to_torch`` with ``strict=True``: coordinates
  and masks identical row by row, features and the point features within
  ``1e-4 * max|ref| + 1e-5`` (f32, another summation order over a few
  layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_convert import flatten, nest, perturbed
from test_torch_sparse_net import assert_close, small_grid

from pasco_tpu.models import maskpls as JM
from pasco_tpu.ops import knn as JK
from pasco_torch.convert import flax_to_torch
from pasco_torch.models import maskpls as PM
from pasco_torch.ops import knn as PK

torch.set_num_threads(1)

TOL = (1e-4, 1e-5)


def points(seed, m=300, n=120):
    r = np.random.RandomState(seed)
    refs = (r.rand(n, 3) * 20).astype(np.float32)
    refs[n // 2:n // 2 + 10] = refs[:10]           # exact duplicates: ties
    q = (r.rand(m, 3) * 20).astype(np.float32)
    q[:10] = refs[:10]                              # queries on reference points
    mask = r.rand(n) < 0.85
    return q, refs, mask


@pytest.mark.parametrize("k,tile", [(1, 4096), (3, 64), (8, 100)])
def test_knn(k, tile):
    q, refs, mask = points(k)
    jd, ji = JK.knn(jnp.asarray(q), jnp.asarray(refs), jnp.asarray(mask), k, tile=tile)
    pd, pi = PK.knn(torch.from_numpy(q), torch.from_numpy(refs), torch.from_numpy(mask), k,
                    tile=tile)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert_close(pd.numpy(), jd, (1e-5, 0.0))
    assert mask[pi.numpy()].all()


def test_knn_up():
    q, refs, mask = points(5)
    feats = np.random.RandomState(5).randn(len(refs), 7).astype(np.float32)
    j = JK.knn_up(jnp.asarray(refs), jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(q))
    p = PK.knn_up(torch.from_numpy(refs), torch.from_numpy(feats), torch.from_numpy(mask),
                  torch.from_numpy(q))
    assert_close(p.numpy(), j, (1e-5, 1e-6))


def _carry(jmod, pmod, *args, **kw):
    """Init the flax module on ``args``, perturb, load into the port."""
    v = jmod.init(jax.random.PRNGKey(0), *args, **kw)
    flat = perturbed(flatten(v), seed=2)
    pmod.load_state_dict(flax_to_torch(flat), strict=True)
    return nest(flat)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("out_channels", [8, 6])       # identity skip; 1x1 + BN skip
def test_residual_block_original(out_channels, train):
    jg, pg, jbox, pbox = small_grid(np.random.RandomState(out_channels))
    jmod = JM.ResidualBlockOriginal(out_channels)
    pmod = PM.ResidualBlockOriginal(8, out_channels)
    v = _carry(jmod, pmod, jg, jbox, False)
    pmod.train(train)
    if train:
        j, _ = jmod.apply(v, jg, jbox, True, mutable=["batch_stats"])
    else:
        j = jmod.apply(v, jg, jbox, False)
    p = pmod(pg, pbox)
    np.testing.assert_array_equal(p.mask.numpy(), np.asarray(j.mask))
    assert_close(p.feats.detach().numpy(), j.feats, TOL)


def test_aspp():
    jg, pg, jbox, pbox = small_grid(np.random.RandomState(9))
    jmod, pmod = JM.ASPP(6), PM.ASPP(8, 6)
    v = _carry(jmod, pmod, jg, jbox, False)
    j = jmod.apply(v, jg, jbox, False)
    p = pmod(pg, pbox)
    np.testing.assert_array_equal(p.mask.numpy(), np.asarray(j.mask))
    assert_close(p.feats.detach().numpy(), j.feats, TOL)


def test_maskpls_encoder_decoder():
    """Three encoder stages down to stride 8 and back; the point features
    interpolated from the stride-1 grid."""
    jg, pg, jbox, pbox = small_grid(np.random.RandomState(11), n=600)
    xyz = (np.random.RandomState(12).rand(200, 3) * 8 + np.asarray([-6, 2, -3])).astype(
        np.float32)
    kw = dict(channels=(8, 16, 16, 32), out_dim=12, capacities=(512, 256, 128, 64))
    jmod = JM.MaskPLSEncoderDecoder(**kw)
    pmod = PM.MaskPLSEncoderDecoder(8, **kw)
    v = _carry(jmod, pmod, jg, jbox, jnp.asarray(xyz))
    pmod.eval()
    jpt, jouts = jmod.apply(v, jg, jbox, jnp.asarray(xyz))
    with torch.no_grad():
        ppt, pouts = pmod(pg, pbox, torch.from_numpy(xyz))
    assert len(pouts) == len(jouts) == 3
    for p, j in zip(pouts, jouts):
        np.testing.assert_array_equal(p.mask.numpy(), np.asarray(j.mask))
        np.testing.assert_array_equal(p.coords.numpy(), np.asarray(j.coords))
        assert p.stride == j.stride
        assert_close(p.feats.numpy(), j.feats, TOL)
        assert int(p.mask.sum()) > 0
    assert_close(ppt.numpy(), jpt, TOL)
