"""The port's losses, matcher, criterion and optimizer against the JAX
reference on the CPU, in f32, from numpy-seeded inputs.

Tolerances: values and gradients at ``rtol=1e-4, atol=1e-5`` (same math
in f32, another summation order); assignments exactly equal.  The
optimizer's parameters after 3 steps within ``1e-6`` absolute: the bf16
first moment rounds at the same points in both, so the remaining
difference is f32 rounding of an update of size ``lr``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasco_tpu.core.config import LossConfig, OptimConfig
from pasco_tpu.core.sparse import SparseGrid as JGrid
from pasco_tpu.loss import criterion as jcrit
from pasco_tpu.loss import losses as jl
from pasco_tpu.loss import lovasz as jlov
from pasco_tpu.loss import matcher as jm
from pasco_torch.core.sparse import SparseGrid
from pasco_torch.loss import criterion as tcrit
from pasco_torch.loss import losses as tl
from pasco_torch.loss import lovasz as tlov
from pasco_torch.loss import matcher as tm
from pasco_torch.training.optim import AdamW, lr_schedule

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5


def T(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_(grad)


def close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(ref), rtol=rtol, atol=atol)


def value_and_grad_both(jfn, tfn, *arrays):
    """Value and gradient w.r.t. the first array, in both frameworks."""
    jv, jg = jax.value_and_grad(jfn)(*(jnp.asarray(a) for a in arrays))
    x = T(arrays[0], grad=True)
    tv = tfn(x, *(T(a) for a in arrays[1:]))
    tv.backward()
    return (tv, x.grad), (jv, jg)


def _cls_inputs(seed, n=300, c=6):
    r = np.random.RandomState(seed)
    logits = (r.randn(n, c) * 2).astype(np.float32)
    labels = r.randint(0, c, n).astype(np.int32)
    valid = r.rand(n) < 0.8
    w = (r.rand(c) + 0.5).astype(np.float32)
    return logits, labels, valid, w


@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_cross_entropy(weighted):
    logits, labels, valid, w = _cls_inputs(0)
    cw = w if weighted else None
    (tv, tg), (jv, jg) = value_and_grad_both(
        lambda x, y, v: jl.weighted_cross_entropy(x, y, v, cw),
        lambda x, y, v: tl.weighted_cross_entropy(x, y, v, None if cw is None else T(cw)),
        logits, labels, valid)
    close(tv, jv)
    close(tg, jg)


def test_sigmoid_focal_and_dice():
    r = np.random.RandomState(1)
    x = (r.randn(200, 7) * 2).astype(np.float32)
    t = (r.rand(200, 7) < 0.3).astype(np.float32)
    valid = r.rand(200) < 0.7
    (tv, tg), (jv, jg) = value_and_grad_both(
        lambda a, b: jl.sigmoid_focal_loss(a, b).sum(),
        lambda a, b: tl.sigmoid_focal_loss(a, b).sum(), x, t)
    close(tv, jv)
    close(tg, jg)
    (tv, tg), (jv, jg) = value_and_grad_both(
        lambda a, b, v: (jl.dice_loss(a, b, v) * jnp.arange(7)).sum(),
        lambda a, b, v: (tl.dice_loss(a, b, v) * torch.arange(7)).sum(), x, t, valid)
    close(tv, jv)
    close(tg, jg)
    np.testing.assert_allclose(
        tl.compl_labelweights(np.arange(1, 21.0)), jl.compl_labelweights(np.arange(1, 21.0)))


@pytest.mark.parametrize("ignore", [(), (0,)])
def test_lovasz_softmax(ignore):
    """Stable descending torch.sort + constant Lovasz gradient against the
    reference's sort-free form: same value and gradient (with tied
    errors from duplicated rows and invalid rows)."""
    logits, labels, valid, _ = _cls_inputs(2, n=400, c=5)
    logits[200:260] = logits[100:160]       # ties
    labels[200:260] = labels[100:160]
    (tv, tg), (jv, jg) = value_and_grad_both(
        lambda x, y, v: jlov.lovasz_softmax(x, y, v, ignore_classes=ignore),
        lambda x, y, v: tlov.lovasz_softmax(x, y, v, ignore_classes=ignore),
        logits, labels, valid)
    close(tv, jv)
    close(tg, jg)


def test_sem_compl_loss():
    """compute_sem_compl_loss over three scales, value and logit gradients."""
    r = np.random.RandomState(3)
    S, C, N = 1, 6, 500
    smin = np.array([[-4, 2, 0]], np.int32)
    smax = np.array([[27, 33, 7]], np.int32)
    jg, tg, logits, labels = {}, {}, {}, {}
    for scale in (4, 2, 1):
        coords = np.zeros((N, 4), np.int32)
        coords[:, 1:] = np.stack([r.randint(-6, 30, N), r.randint(0, 36, N),
                                  r.randint(-1, 9, N)], 1) // scale * scale
        mask = r.rand(N) < 0.8
        ext = (32 // scale, 32 // scale, 8 // scale)
        lab = r.randint(0, C, (S, *ext)).astype(np.uint8)
        lab[r.rand(S, *ext) < 0.1] = 255
        jg[scale] = JGrid(jnp.asarray(coords), jnp.zeros((N, 1)), jnp.asarray(mask), scale)
        tg[scale] = SparseGrid(T(coords), torch.zeros((N, 1)), T(mask), scale)
        logits[scale] = (r.randn(N, S, C) * 2).astype(np.float32)
        labels[scale] = lab
    w = {s: (r.rand(C) + 0.5).astype(np.float32) for s in (1, 2, 4)}

    def jfn(lg):
        ce, lov = jl.compute_sem_compl_loss(
            jg, lg, {s: jnp.asarray(labels[s]).astype(jnp.int32) for s in labels},
            smin, smax, {s: jnp.asarray(v) for s, v in w.items()})
        return ce + 2 * lov, (ce, lov)

    (jv, (jce, jlv)), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        {s: jnp.asarray(v) for s, v in logits.items()})
    tlg = {s: T(v, grad=True) for s, v in logits.items()}
    ce, lov = tl.compute_sem_compl_loss(
        tg, tlg, {s: T(labels[s]).long() for s in labels}, T(smin), T(smax),
        {s: T(v) for s, v in w.items()})
    (ce + 2 * lov).backward()
    close(ce, jce)
    close(lov, jlv)
    for s in (1, 2, 4):
        close(tlg[s].grad, jgrad[s])


# --------------------------------------------------------------------------
# matcher and criterion
# --------------------------------------------------------------------------


def _panoptic_case(seed, S=1, Q=10, C=5, N=400, t_cap=8, n_levels=4):
    r = np.random.RandomState(seed)
    ext = (16, 16, 8)
    coords = np.zeros((S, N, 4), np.int32)
    coords[..., 1:] = np.stack([r.randint(-2, 18, (S, N)), r.randint(0, 16, (S, N)),
                                r.randint(0, 9, (S, N))], -1)
    mask = r.rand(S, N) < 0.85
    n_t = 7
    labels = np.zeros((S, t_cap), np.int32)
    labels[:, :n_t] = r.randint(1, C, (S, n_t))
    labels[:, 2] = 255          # an ignore label in a mask slot (synthetic scenes have them)
    tvalid = np.zeros((S, t_cap), bool)
    tvalid[:, :n_t] = True
    mask_id = r.randint(0, n_t + 3, (S, *ext)).astype(np.int32)
    mask_id[mask_id >= n_t] = t_cap
    sem = r.randint(0, C, (S, *ext)).astype(np.uint8)
    sem[r.rand(S, *ext) < 0.1] = 255
    unknown = r.rand(S, *ext) < 0.1
    levels = [((r.randn(S, Q, C + 1) * 2).astype(np.float32),
               (r.randn(S, N, Q) * 3).astype(np.float32)) for _ in range(n_levels)]
    cw = np.ones(C + 1, np.float32)
    cw[0], cw[-1] = 0.1, 0.1
    return dict(coords=coords, mask=mask, labels=labels, tvalid=tvalid,
                mask_id=mask_id, sem=sem, unknown=unknown, levels=levels,
                smin=np.zeros((S, 3), np.int32), cw=cw,
                compl_w=(r.rand(C) + 0.5).astype(np.float32), C=C)


def _match_args(d):
    t_cap = d["labels"].shape[1]
    q, v = d["levels"][0][0][0], d["levels"][0][1][0]
    n = d["mask"].shape[1]
    mid = np.where(d["mask"][0], d["mask_id"][0].reshape(-1)[:n], t_cap)
    mid[mid > t_cap] = t_cap
    onehot = ((mid[:, None] == np.arange(t_cap)[None]) & d["tvalid"][0][None]).astype(np.float32)
    vvalid = d["mask"][0] & (mid < t_cap)
    return (q, v, onehot, d["labels"][0], d["tvalid"][0], vvalid, d["cw"])


def test_match_same_assignment_from_same_costs():
    """The port's device costs + host LSA give the reference's assignment
    (its in-graph solver) on the same inputs, with no more target slots
    than queries (the flagship: 64 slots, 100 queries)."""
    d = _panoptic_case(4)
    args = _match_args(d)
    ref = np.asarray(jm.match(*map(jnp.asarray, args), 1.0, 40.0, 1.0))
    cost = tm.match_cost(*map(T, args), 1.0, 40.0, 1.0)
    got = tm.match_all([cost], [T(d["tvalid"][0])])[0].numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[:7] >= 0).all() and (got[7:] == -1).all()


def test_match_optimal_where_reference_solver_is_not():
    """With more target slots than queries the reference's in-graph solver
    puts 1e9 sentinel costs in the f32 sum, whose spacing there (256)
    swamps the real costs, and it can return a costlier matching
    (ROADMAP.md queue 3).  The port's host solver returns the optimum."""
    d = _panoptic_case(4, t_cap=12)
    args = _match_args(d)
    ref = np.asarray(jm.match(*map(jnp.asarray, args), 1.0, 40.0, 1.0))
    cost = tm.match_cost(*map(T, args), 1.0, 40.0, 1.0).numpy().astype(np.float64)
    got = tm.match_all([torch.from_numpy(cost)], [T(d["tvalid"][0])])[0].numpy()
    cols = np.nonzero(d["tvalid"][0])[0]
    total = lambda a: cost[a[cols], cols].sum()   # noqa: E731
    assert len(set(got[cols])) == len(cols) and (got[~d["tvalid"][0]] == -1).all()
    from scipy.optimize import linear_sum_assignment

    rows, sub = linear_sum_assignment(cost[:, cols])
    assert total(got) == pytest.approx(cost[rows, cols[sub]].sum(), abs=1e-9)
    assert total(got) < total(ref) - 1e-3


@pytest.mark.parametrize("include_aux", [False, True])
def test_criterion_all_subnets(include_aux):
    """Every key (aux levels included) and the gradients w.r.t. the query
    and voxel logits of every level; one mask slot carries the 255 ignore
    label, which the reference's clamped gathers read as "no object"."""
    d = _panoptic_case(5)
    cfg = LossConfig()
    levels = d["levels"]

    class Pred:
        def __init__(self, lv):
            self.query_logits, self.voxel_logits = lv[-1]
            self.aux = lv[:-1]

    def jfn(lv):
        grid = JGrid(jnp.asarray(d["coords"]), jnp.zeros(d["mask"].shape + (1,)),
                     jnp.asarray(d["mask"]), 1)
        tgt = jcrit.SubnetTargets(
            jnp.asarray(d["labels"]), jnp.asarray(d["tvalid"]), jnp.asarray(d["mask_id"]),
            jnp.asarray(d["sem"]).astype(jnp.int32), jnp.asarray(d["unknown"]))
        out = jcrit.criterion_all_subnets(
            Pred(lv), grid, jnp.zeros((1, 400, d["C"])), tgt, jnp.asarray(d["smin"]),
            jnp.asarray(d["cw"]), jnp.asarray(d["compl_w"]), cfg, d["C"],
            include_aux=include_aux)
        return sum(out.values()), out

    jlv = [tuple(map(jnp.asarray, lv)) for lv in levels]
    (_, jout), jgrad = jax.value_and_grad(jfn, has_aux=True)(jlv)

    tlv = [tuple(T(a, grad=True) for a in lv) for lv in levels]
    grid = SparseGrid(T(d["coords"]), torch.zeros(d["mask"].shape + (1,)), T(d["mask"]), 1)
    tgt = tcrit.SubnetTargets(T(d["labels"]), T(d["tvalid"]), T(d["mask_id"]),
                              T(d["sem"]).long(), T(d["unknown"]))
    tout = tcrit.criterion_all_subnets(
        Pred(tlv), grid, tgt, T(d["smin"]), T(d["cw"]), T(d["compl_w"]), cfg, d["C"],
        include_aux=include_aux)
    assert sorted(tout) == sorted(jout)
    assert len(tout) == 5 * (4 if include_aux else 1)
    for k in jout:
        close(tout[k], jout[k])
    sum(tout.values()).backward()
    used = levels if include_aux else levels[-1:]
    for i in range(len(levels) - len(used), len(levels)):
        for j in range(2):
            close(tlv[i][j].grad, jgrad[i][j])


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["reference", "cosine"])
def test_optimizer_three_steps(mode):
    """3 AdamW steps (one above the clip norm, two below) against
    ``make_optimizer``: bf16 first moment, optax's clip, decoupled decay."""
    from pasco_tpu.training.optim import lr_schedule as jsched
    from pasco_tpu.training.optim import make_optimizer

    ocfg = OptimConfig(lr=1e-3, warmup_steps=2, max_steps=10)
    r = np.random.RandomState(6)
    params = {"a": r.randn(5, 7).astype(np.float32), "b": r.randn(11).astype(np.float32)}
    grads = [{k: (r.randn(*v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in (1.0, 0.01, 0.02)]
    tx = make_optimizer(ocfg, mode)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(T(v)) for k, v in params.items()}
    opt = AdamW(tp, ocfg, mode)
    for i, g in enumerate(grads):
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        norm = opt.step({k: T(v) for k, v in g.items()})
        close(norm, np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values())))
        assert lr_schedule(ocfg, mode)(i) == pytest.approx(float(jsched(ocfg, mode)(i)))
        for k in params:
            close(tp[k], jp[k], rtol=0, atol=1e-6)
    mu = st[1][0].mu
    for k in params:
        assert opt.mu[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(opt.mu[k].float().numpy(),
                                      np.asarray(mu[k].astype(jnp.float32)))
