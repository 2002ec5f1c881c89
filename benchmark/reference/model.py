"""Plain PyTorch reference of the PaSCo forward at inference (the dense
network with masks, ``DensePaSCoNet`` in ``net.eval()``), in float32.

It imports nothing of the program.  It reads the benchmark's weights by
parameter name, the configuration file's dictionary and one scan's input
arrays, and works out again the working box, every occupancy mask, keep
set and extraction.  Every operation is the textbook one: ``F.conv3d`` for
the 3x3x3 convs, a reshape and one product for the stride-2 down and up
convs, ``softmax`` for attention over every key at once.

``rnd`` is applied wherever the program rounds to its compute dtype (a
conv's, a layer's or a logit's output, a conv's operands).  For the
reference it is the identity: everything stays in float32, and the caller
turns TF32 off.  The control passes a rounding to a lower precision.

Layouts: volumes are ``[X, Z, Y, C]`` with masks ``[X, Z, Y]``; conv
kernels are ``[taps, Ci, Co]`` with the taps x-major and z fastest over
the (x, y, z) offsets; kept cells are extracted in flat ``[X, Z, Y]``
order, the first ``capacity`` of them.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.compare import match

BN_EPS = 1e-5
LN_EPS = 1e-6
UNDECIDABLE = 1e3   # keep_gap of a cell kept where the reference could not keep one

Rnd = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def pick_box(cfg: dict, gmin, gmax) -> Tuple[int, int, int]:
    """The smallest candidate box (by volume) covering the scan's global
    box, the largest where none does; the configured box without
    candidates."""
    scene = cfg["scene"]
    cands = sorted({tuple(c) for c in scene["box_candidates"]}, key=np.prod) \
        if scene["box_candidates"] else [tuple(scene["box_extent"])]
    ext = np.asarray(gmax) - np.asarray(gmin) + 1
    for c in cands:
        if np.all(ext <= np.asarray(c)):
            return c
    return cands[-1]


class Reference:
    """The forward of one scan; ``w`` maps parameter names to f32 tensors
    on the device the reference runs on."""

    def __init__(self, cfg: dict, w: Dict[str, torch.Tensor], rnd: Rnd = identity):
        self.cfg, self.w, self.rnd = cfg, w, rnd
        m = cfg["model"]
        self.S, self.K, self.f = m["n_infers"], m["n_classes"], m["f"]
        self.fm = (self.f, 2 * self.f, 4 * self.f, 4 * self.f)
        self.n_res = m["res_blocks"] if m["res_blocks"] is not None else (
            0 if m["heavy_decoder"] else 3)
        # the products of the last forward, for benchmark/flops.py: dicts
        # with ``kind`` "mm" (rows, k, n), "conv3" (cells, pairs, ci, co,
        # skip, mask_cells), "dense" (cells, taps, ci, co) or "attn" (q, n, d)
        self.calls = []

    def count(self, kind, **kw):
        self.calls.append(dict(kind=kind, **{k: int(v) for k, v in kw.items()}))

    # ---- primitives -----------------------------------------------------

    def p(self, name):
        return self.w[name].float()

    def bn(self, x, name, index=None):
        """BatchNorm at inference: running statistics mean 0, variance 1
        (the benchmark's weights), then the learnt scale and bias."""
        scale, bias = self.p(name + ".scale"), self.p(name + ".bias")
        mean = self.w.get(name + ".mean", torch.zeros_like(scale)).float()
        var = self.w.get(name + ".var", torch.ones_like(scale)).float()
        if index is not None:
            scale, bias, mean, var = scale[index], bias[index], mean[index], var[index]
        return (x - mean) * torch.rsqrt(var + BN_EPS) * scale + bias

    def linear(self, x, name):
        return x @ self.p(name + ".weight").T + self.p(name + ".bias")

    def layer_norm(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p(name + ".weight"), self.p(name + ".bias"),
                            LN_EPS)

    def conv3(self, x, mask, kernel, bias=None, bn=None, bn_index=None, skip=None,
              relu_out=False):
        """``mask * [relu](conv3(mask * [relu(bn(x))]) + bias [+ skip])``."""
        r = self.rnd
        y = x
        if bn is not None:
            y = torch.relu(self.bn(y, bn, bn_index))
        y = torch.where(mask[..., None], y, torch.zeros((), device=y.device))
        ci, co = kernel.shape[1], kernel.shape[2]
        m = mask.float()[None, None]
        around = F.conv3d(m, torch.ones((1, 1, 3, 3, 3), device=m.device), padding=1)
        self.count("conv3", cells=mask.sum(), pairs=(around * m).sum(), ci=ci, co=co,
                   skip=skip is not None, mask_cells=mask.numel())
        wk = r(kernel).reshape(3, 3, 3, ci, co).permute(4, 3, 0, 2, 1)
        out = F.conv3d(r(y).permute(3, 0, 1, 2)[None], wk, padding=1)[0].permute(1, 2, 3, 0)
        if bias is not None:
            out = out + bias
        if skip is not None:
            out = out + skip
        if relu_out:
            out = torch.relu(out)
        return r(torch.where(mask[..., None], out, torch.zeros((), device=out.device)))

    def res_block(self, x, mask, name):
        f = self.conv3(x, mask, self.p(name + ".conv1.kernel"), self.p(name + ".conv1.bias"),
                       bn=name + ".bn1")
        return self.conv3(f, mask, self.p(name + ".conv2.kernel"),
                          self.p(name + ".conv2.bias"), bn=name + ".bn2", skip=x,
                          relu_out=True)

    def res_stack(self, x, mask, stage):
        for i in range(self.n_res):
            x = self.res_block(x, mask, f"{stage}.res{i}")
        return x

    @staticmethod
    def pool_mask(mask):
        X, Z, Y = mask.shape
        return mask.reshape(X // 2, 2, Z // 2, 2, Y // 2, 2).any(5).any(3).any(1)

    @staticmethod
    def up_mask(mask):
        return mask.repeat_interleave(2, 0).repeat_interleave(2, 1).repeat_interleave(2, 2)

    def axes(self, stride):
        """Absolute x, y, z coordinates of the box's cells at ``stride``."""
        dev = self.gmin.device
        return [self.box_min[j] + torch.arange(-(-e // stride), device=dev) * stride
                for j, e in enumerate(self.box_extent)]

    def bbox_mask(self, stride, lo, hi):
        ax, ay, az = self.axes(stride)
        mx = (ax >= lo[0]) & (ax <= hi[0])
        my = (ay >= lo[1]) & (ay <= hi[1])
        mz = (az >= lo[2]) & (az <= hi[2])
        return mx[:, None, None] & mz[None, :, None] & my[None, None, :]

    def extract(self, keep, stride, capacity):
        """The first ``capacity`` kept cells in flat order: their absolute
        (x, y, z) coordinates ``[n, 3]`` and flat indices ``[n]``."""
        X, Z, Y = keep.shape
        flat = keep.reshape(-1).nonzero()[:, 0][:capacity]
        sx, sz, sy = flat // (Z * Y), (flat // Y) % Z, flat % Y
        coords = torch.stack([sx, sy, sz], 1) * stride + self.box_min[None, :]
        return coords, flat

    # ---- the network ------------------------------------------------------

    def force(self, own, taken, capacity, stride, margin, scale):
        """The keep decisions of a stage when the reference follows the
        side it judges: ``taken`` are the cells that side extracted (the
        first ``capacity`` it kept, in flat order), so its decision is
        known at every cell up to the last of them, and there it replaces
        the reference's own ``own``; past it the reference's own stands.
        Returns (the decisions to go on with, the widest ``|margin|`` of a
        cell decided apart in the stretch both extractions cover, as a share
        of ``scale``; a cell that only the other side keeps and the
        reference could not keep at all reads :data:`UNDECIDABLE`)."""
        X, Z, Y = own.shape
        n = own.numel()
        rel = torch.div(taken.long() - self.box_min[None], stride, rounding_mode="floor")
        dims = torch.tensor([X, Y, Z], device=own.device)
        inside = ((rel >= 0) & (rel < dims)).all(1)
        flat = (rel[:, 0] * Z + rel[:, 2]) * Y + rel[:, 1]
        gap = 0.0 if inside.all() else UNDECIDABLE
        flat = flat[inside]
        theirs = torch.zeros(n, dtype=torch.bool, device=own.device)
        theirs[flat] = True
        reach_t = int(flat.max()) if taken.shape[0] >= capacity and flat.numel() else n - 1
        mine = own.reshape(-1)
        kept = mine.nonzero()[:, 0]
        reach_m = int(kept[capacity - 1]) if kept.numel() >= capacity else n - 1
        both = min(reach_t, reach_m) + 1
        apart = theirs[:both] != mine[:both]
        if apart.any():
            m = margin.reshape(-1)[:both][apart].abs().max().item() / max(scale, 1e-30)
            gap = max(gap, min(m, UNDECIDABLE))
        out = mine.clone()
        out[: reach_t + 1] = theirs[: reach_t + 1]
        return out.reshape(own.shape), gap

    def forward(self, scan: Dict[str, np.ndarray], device, follow=None) -> dict:
        """Returns ``sem`` (scale -> kept coords ``[n, 3]``), ``sem_logits``
        (scale-1 logits of those cells ``[n, S, K]``), ``panop`` (scale ->
        list over subnets of kept coords), ``mask_logits`` (list over
        subnets of ``[n, Q]`` on the scale-1 panoptic cells),
        ``query_logits`` ``[S, Q, K + 1]`` and ``attn`` (list over the
        transformer's rounds of lists over subnets of ``[n, Q]``: which
        scale-1 cell let which query attend, before the round's downscale).

        With ``follow`` (the judged side's output in this form, with its
        ``caps``) every keep decision follows that side's where it is known
        (:meth:`force`), and so does every attention mask where ``follow``
        has ``attn`` (:meth:`transformer`), so that a near tie decided the
        other way by rounding does not change everything downstream;
        ``keep_gap`` then says how far from a tie the keeps taken apart
        were."""
        r, S, K = self.rnd, self.S, self.K
        cfg, cap = self.cfg, self.cfg["capacity"]
        t = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
        pf = t(scan["point_feats"]).float()
        pc = t(scan["point_coords"]).long()
        pm = t(scan["point_mask"]).bool()
        self.gmin, self.gmax = t(scan["global_min"]).long(), t(scan["global_max"]).long()
        smin, smax = t(scan["subnet_min"]).long(), t(scan["subnet_max"]).long()
        self.box_extent = pick_box(cfg, scan["global_min"], scan["global_max"])
        self.box_min = self.gmin
        ex, ey, ez = self.box_extent

        # point MLP, then the per-(cell, subnet) max in the enc_in input
        zero = torch.zeros((), device=device)
        self.calls = []
        n_pts = pm.sum()
        for i in (1, 2, 3, 4):
            wt = self.w[f"point_mlp.fc{i}.weight"]
            self.count("mm", rows=n_pts, k=wt.shape[1], n=wt.shape[0])
        f = torch.where(pm[:, None], self.bn(pf, "point_mlp.bn_in"), zero)
        for i in (1, 2, 3):
            f = torch.where(pm[:, None], torch.relu(self.bn(
                self.linear(f, f"point_mlp.fc{i}"), f"point_mlp.bn{i}")), zero)
        f = r(torch.where(pm[:, None], self.linear(f, "point_mlp.fc4"), zero))
        rel = pc[:, 1:] - self.box_min[None]
        in_box = pm & (rel >= 0).all(1) & (rel[:, 0] < ex) & (rel[:, 1] < ey) & (rel[:, 2] < ez)
        sub = pc[:, 0].clamp(0, S - 1)
        n_rows = ex * ey * ez * S
        row = ((rel[:, 0] * ez + rel[:, 2]) * ey + rel[:, 1]) * S + sub
        row = torch.where(in_box, row, torch.full_like(row, n_rows))
        fdim = f.shape[1]
        grid = torch.full((n_rows + 1, fdim), -math.inf, device=device)
        grid.scatter_reduce_(0, row[:, None].expand(-1, fdim), f, "amax")
        hits = torch.zeros(n_rows + 1, device=device).index_add_(0, row, torch.ones_like(f[:, 0]))
        occ = hits[:-1] > 0
        x = torch.where(occ[:, None], grid[:-1], zero).reshape(ex, ez, ey, S * fdim)
        mask1 = occ.reshape(ex, ez, ey, S).any(-1)

        # encoder
        self.count("mm", rows=mask1.sum(), k=x.shape[-1], n=self.fm[0])
        x = r(x @ r(self.p("enc_in.kernel")[0]) + self.p("enc_in.bias"))
        x = torch.where(mask1[..., None], x, zero)
        enc = {1: (self.res_stack(x, mask1, "enc_s1"), mask1)}
        for stride in (2, 4, 8):
            xin, min_ = enc[stride // 2]
            name = f"enc_s{stride}.down"
            mout = self.pool_mask(min_)
            xm = torch.where(min_[..., None], xin, zero)
            X, Z, Y, c = xm.shape
            self.count("mm", rows=min_.sum(), k=c, n=self.w[name + ".kernel"].shape[-1])
            cols = xm.reshape(X // 2, 2, Z // 2, 2, Y // 2, 2, c).permute(0, 2, 4, 1, 5, 3, 6)
            y = r(cols).reshape(-1, 8 * c) @ r(self.p(name + ".kernel")).reshape(8 * c, -1)
            y = (y + self.p(name + ".bias")).reshape(X // 2, Z // 2, Y // 2, -1)
            y = torch.relu(self.bn(F.leaky_relu(self.bn(y, name + ".bn1"), 0.01), name + ".bn2"))
            y = r(torch.where(mout[..., None], y, zero))
            enc[stride] = (self.res_stack(y, mout, f"enc_s{stride}"), mout)

        # dense bottleneck at stride 8, on [X, Y, Z, C]
        x8 = enc[8][0].permute(0, 2, 1, 3)
        xb = self.bottleneck(x8)
        xb = r(xb).permute(0, 2, 1, 3)
        mask8 = self.bbox_mask(8, self.gmin, self.gmax)
        x = torch.where(mask8[..., None], xb, zero)
        parent_keep = mask8

        # generative decoder
        dense = {}
        out = {"sem": {}, "panop": {}, "margin_sem": {}, "margin_panop": {}, "logit_scale": {},
               "caps": {**{("sem", s): cap[f"dec_s{s}"] for s in (4, 2, 1)},
                        **{("panop", s): cap[f"panop_s{s}"] for s in (4, 2, 1)}}}
        out["keep_gap"] = 0.0
        for scale in (4, 2, 1):
            x, sem, top, msk = self.decoder_stage(x, parent_keep, *enc[scale], scale)
            keep = (top != 0).any(-1) & msk
            # how far each decision lies from a tie: the best class but
            # "empty" against "empty", per subnet; a cell the reference
            # could not keep (outside the mask or the subnet's box) is inf
            margin = sem[..., 1:].amax(-1) - sem[..., 0]
            inf = torch.full((), math.inf, device=device)
            out["margin_sem"][scale] = torch.where(msk, margin.amax(-1), inf)
            boxes = torch.stack([self.bbox_mask(scale, smin[i], smax[i]) for i in range(S)], -1)
            out["margin_panop"][scale] = torch.where(msk[..., None] & boxes, margin, inf)
            out["logit_scale"][scale] = sem.abs().amax()
            if follow is not None:
                keep, gap = self.force(keep, follow["sem"][scale], follow["caps"][("sem", scale)],
                                       scale, out["margin_sem"][scale],
                                       out["logit_scale"][scale].item())
                out["keep_gap"] = max(out["keep_gap"], gap)
            coords, flat = self.extract(keep, scale, cap[f"dec_s{scale}"])
            out["sem"][scale] = coords
            if scale == 1:
                out["sem_logits"] = sem.reshape(-1, S, K)[flat]
            dense[scale] = (x, top, keep)
            parent_keep = keep

        # per-subnet refiners and extraction, then the transformer
        grids = {}
        for scale in (4, 2, 1):
            xd, top, dkeep = dense[scale]
            pcap = cap[f"panop_s{scale}"]
            name = f"voxel_feats_s{scale}"
            rows = []
            for s in range(S):
                keep_s = (top[..., s] != 0) & dkeep & self.bbox_mask(scale, smin[s], smax[s])
                if follow is not None:
                    keep_s, gap = self.force(keep_s, follow["panop"][scale][s],
                                             follow["caps"][("panop", scale)], scale,
                                             out["margin_panop"][scale][..., s],
                                             out["logit_scale"][scale].item())
                    out["keep_gap"] = max(out["keep_gap"], gap)
                g = self.conv3(xd, keep_s, self.p(name + ".conv1.kernel")[s])
                g = self.conv3(g, keep_s, self.p(name + ".conv2.kernel")[s],
                               self.p(name + ".conv2.bias")[s], bn=name + ".bn", bn_index=s)
                coords, flat = self.extract(keep_s, scale, pcap)
                n = coords.shape[0]
                padded_c = torch.zeros((pcap, 3), dtype=torch.long, device=device)
                padded_f = torch.zeros((pcap, g.shape[-1]), device=device)
                padded_c[:n] = coords
                padded_f[:n] = g.reshape(-1, g.shape[-1])[flat]
                valid = torch.arange(pcap, device=device) < n
                rows.append((padded_c, padded_f, valid))
            grids[scale] = rows
            out["panop"][scale] = [c[v] for c, _, v in rows]
        theirs = None if follow is None or follow.get("attn") is None else (
            follow["attn"], follow["panop"][1])
        query, masks, out["attn"] = self.transformer(grids, theirs)
        out["query_logits"] = query
        out["mask_logits"] = [m[v] for m, (_, _, v) in zip(masks, grids[1])]
        return out

    def bottleneck(self, x):
        """SPCDense3D: multi-branch anisotropic convs, each with BN + ReLU."""
        r = self.rnd

        def cbr(y, name):
            k = self.p(f"bottleneck.{name}_conv.kernel")
            kx, ky, kz, ci, co = k.shape
            self.count("dense", cells=y[..., 0].numel(), taps=kx * ky * kz, ci=ci, co=co)
            pad = tuple(s // 2 for s in k.shape[:3])
            o = F.conv3d(r(y).permute(3, 0, 1, 2)[None], r(k).permute(4, 3, 0, 1, 2), padding=pad)
            o = r(o[0].permute(1, 2, 3, 0))
            return torch.relu(self.bn(o, f"bottleneck.{name}_bn"))

        x1 = cbr(x, "a1")
        x2, x3, x4 = cbr(x1, "a2"), cbr(x1, "a3"), cbr(x1, "a4")
        t = x2 + x3 + x4
        x5, x6, x7 = cbr(t, "a5"), cbr(t, "a6"), cbr(t, "a7")
        y0 = cbr(x1 + x2 + x3 + x4 + x5 + x6 + x7, "ch1")
        return x1 + y0 + cbr(x, "r1") + cbr(x, "r2") + cbr(x, "r3")

    def decoder_stage(self, parent, parent_keep, skip, skip_mask, scale):
        """Up-convolution of the kept parents, the coordinate resize, the
        skip add on the union mask, the residual stack and the heads.
        Returns (volume, logits [X, Z, Y, S, K], argmax [X, Z, Y, S], mask)."""
        r, S, K = self.rnd, self.S, self.K
        name = f"dec_s{scale}"
        zero = torch.zeros((), device=parent.device)
        child = self.up_mask(parent_keep) & self.bbox_mask(scale, self.gmin, self.gmax)
        msk = child | skip_mask
        X2, Z2, Y2, ci = parent.shape
        wd = r(self.p(name + ".up_kernel"))
        co = wd.shape[-1]
        n_child = child.sum()
        self.count("mm", rows=n_child, k=ci, n=co)
        self.count("mm", rows=n_child, k=co + 3, n=co)
        self.count("mm", rows=msk.sum(), k=co, n=S * K)
        pm = torch.where(parent_keep[..., None], parent, zero)
        d = r(pm).reshape(-1, ci) @ wd.permute(1, 0, 2).reshape(ci, 8 * co)
        d = r(d + self.p(name + ".up_bias").repeat(8))
        d = d.reshape(X2, Z2, Y2, 2, 2, 2, co).permute(0, 3, 1, 5, 2, 4, 6).reshape(
            2 * X2, 2 * Z2, 2 * Y2, co)
        d = r(F.leaky_relu(self.bn(d, name + ".up_bn"), 0.01))
        ax, ay, az = self.axes(scale)
        shape = (ax.numel(), az.numel(), ay.numel())
        coords = torch.stack([ax[:, None, None].expand(shape), ay[None, None, :].expand(shape),
                              az[None, :, None].expand(shape)], -1).float() / scale
        xc = r(self.bn(torch.cat([d, r(coords)], -1), name + ".resize_bn"))
        rz = r(xc @ r(self.p(name + ".resize.kernel")[0]) + self.p(name + ".resize.bias"))
        x = torch.where(child[..., None], rz, zero) + skip
        x = r(torch.where(msk[..., None], x, zero))
        x = self.res_stack(x, msk, name)
        hk = r(self.p(name + ".head_kernel"))
        ch = hk.shape[1]
        sem = x.reshape(-1, ch) @ hk.permute(1, 0, 2).reshape(ch, S * K)
        sem = r(sem + self.p(name + ".head_bias").reshape(-1)).reshape(*x.shape[:-1], S, K)
        top = sem.argmax(-1)
        sem = torch.where(msk[..., None, None], sem, zero)
        top = torch.where(msk[..., None], top, torch.zeros_like(top))
        return x, sem, top, msk

    # ---- mask transformer ---------------------------------------------------

    @staticmethod
    def sine_pe(coords, npf):
        c = coords.float()
        c = c / (c + 1e-6) * (2 * math.pi)
        half = torch.arange(npf // 2, dtype=torch.float32, device=coords.device)
        pos = c[..., None] / (10000.0 ** (2 * half / npf))
        return torch.cat([torch.sin(pos), torch.cos(pos)], -1).reshape(*coords.shape[:-1], 3 * npf)

    @staticmethod
    def mask_keep(mask_pred, grid1, theirs=None):
        """[N_1, Q]: scale-1 cell n lets query q attend where
        sigmoid(mask logit) > 0.5; with ``theirs`` (the judged side's
        decisions ``[n, Q]`` on its valid cells, and those cells' coords)
        its decision wherever it holds the cell."""
        c1, _, v1 = grid1
        keep = (torch.sigmoid(mask_pred) > 0.5) & v1[:, None]
        if theirs is not None:
            decided, coords = theirs
            n = int(v1.sum())
            rows_t, rows_r, _ = match(coords, c1[:n])
            keep[rows_r] = decided[rows_t].to(keep.device)
        return keep

    def allowed(self, keep, grid1, grid_s, scale):
        """[N_s, Q]: voxel n of scale ``scale`` may attend query q where a
        scale-1 cell inside it lets q attend (``keep``, :meth:`mask_keep`)."""
        c1, _, v1 = grid1
        cs, _, vs = grid_s
        if scale == 1:
            return keep
        ext = [-(-e // scale) for e in self.box_extent]

        def key(c):
            rel = torch.div(c - self.box_min[None], scale, rounding_mode="floor")
            ok = ((rel >= 0) & (rel < torch.tensor(ext, device=c.device))).all(1)
            return (rel[:, 0] * ext[1] + rel[:, 1]) * ext[2] + rel[:, 2], ok

        n_cells = math.prod(ext)
        ks, oks = key(cs)
        table = torch.full((n_cells + 1,), -1, dtype=torch.long, device=cs.device)
        table[torch.where(oks & vs, ks, n_cells)] = torch.arange(cs.shape[0], device=cs.device)
        table[n_cells] = -1
        kp, okp = key(torch.div(c1, scale, rounding_mode="floor") * scale)
        row = table[torch.where(okp & v1, kp, n_cells)]
        found = row >= 0
        hits = torch.zeros((cs.shape[0] + 1, keep.shape[1]), device=cs.device)
        hits.index_add_(0, torch.where(found, row, cs.shape[0]), keep.float())
        return (hits[:-1] > 0) & vs[:, None]

    def attention(self, q, k, v, allowed, heads, rnd_in=True):
        """Multi-head attention of ``q [Q, D]`` over ``k, v [N, D]``;
        ``allowed [N, Q]`` (None: every key).  A query with no allowed key
        attends every key."""
        r = self.rnd if rnd_in else identity
        nq, d = q.shape
        dh = d // heads
        qh = r(q).reshape(nq, heads, dh).transpose(0, 1)
        kh = r(k).reshape(-1, heads, dh).transpose(0, 1)
        vh = r(v).reshape(-1, heads, dh).transpose(0, 1)
        s = qh @ kh.transpose(1, 2) * dh ** -0.5
        if allowed is not None:
            allowed = allowed | ~allowed.any(0, keepdim=True)
            s = torch.where(allowed.T[None], s, torch.full((), -math.inf, device=s.device))
        p = torch.softmax(s, -1)
        return (r(p) @ vh).transpose(0, 1).reshape(nq, d)

    def transformer(self, grids, theirs=None):
        """(query logits ``[S, Q, K + 1]``, mask logits per subnet, the
        attention decisions of every round per subnet); ``theirs``, the
        judged side's (``attn``, scale-1 coords per subnet), is followed."""
        tc = self.cfg["model"]["transformer"]
        H, heads = tc["hidden_dim"], tc["num_heads"]
        npf = H // 3
        S = self.S
        T = "transformer"
        zero = torch.zeros((), device=grids[1][0][0].device)
        Q, F_ = tc["num_queries"], tc["dim_feedforward"]
        n_valid = {sc: [int(v.sum()) for _, _, v in grids[sc]] for sc in grids}
        C1 = grids[1][0][1].shape[-1]
        for s in range(S):
            n1 = n_valid[1][s]
            self.count("mm", rows=n1, k=C1, n=H)
            for _ in range(len(tc["src_scales"]) + 1):    # the heads of every round
                self.count("mm", rows=Q, k=H, n=self.K + 1 + 3 * H)
                self.count("mm", rows=n1, k=H, n=Q)
            for i, sc in enumerate(tc["src_scales"]):
                ns, Cs = n_valid[sc][s], grids[sc][s][1].shape[-1]
                self.count("mm", rows=ns, k=Cs, n=H)
                self.count("mm", rows=ns, k=H, n=2 * H)
                self.count("mm", rows=Q, k=H, n=6 * H)
                self.count("attn", q=Q, n=ns, d=H)
                self.count("attn", q=Q, n=Q, d=H)
                self.count("mm", rows=Q, k=H, n=2 * F_)
        vfeat = []
        for c1, f1, v1 in grids[1]:
            vf = self.linear(f1, f"{T}.mask_feat_proj") + self.sine_pe(c1, npf)
            vfeat.append(torch.where(v1[:, None], vf, zero))

        def heads_of(o, s):
            dec = self.layer_norm(o, f"{T}.decoder_norm")
            cls = self.linear(dec, f"{T}.class_embed")
            emb = dec
            for i in range(3):
                emb = self.linear(emb, f"{T}.mask_embed.Dense_{i}")
                if i < 2:
                    emb = torch.relu(emb)
            msk = vfeat[s] @ emb.T
            return cls, torch.where(grids[1][s][2][:, None], msk, zero)

        qf, qe = self.p(f"{T}.query_feat"), self.p(f"{T}.query_embed")
        output = [qf[s] for s in range(S)]
        preds = [heads_of(output[s], s) for s in range(S)]
        decisions = []
        for i, scale in enumerate(tc["src_scales"]):
            new = []
            decisions.append([])
            for s in range(S):
                cs, fs, vs = grids[scale][s]
                src = self.linear(fs, f"{T}.input_proj_{i}")
                pos = torch.where(vs[:, None], self.sine_pe(cs, npf), zero)
                keep = self.mask_keep(preds[s][1], grids[1][s], None if theirs is None else (
                    theirs[0][i][s], theirs[1][s]))
                decisions[-1].append(keep[: n_valid[1][s]])
                allowed = self.allowed(keep, grids[1][s], grids[scale][s], scale)
                name = f"{T}.cross_{i}"
                xq = self.layer_norm(output[s], name + ".norm")
                a = self.attention(self.linear(xq + qe[s], name + ".q_proj"),
                                   self.linear(src + pos, name + ".k_proj"),
                                   self.linear(src + pos, name + ".v_proj"), allowed, heads)
                o = xq + self.linear(a, name + ".out_proj")
                name = f"{T}.self_{i}"
                a = self.attention(self.linear(o + qe[s], name + ".q_proj"),
                                   self.linear(o + qe[s], name + ".k_proj"),
                                   self.linear(o, name + ".v_proj"), None, heads, rnd_in=False)
                new.append(self.layer_norm(o + self.linear(a, name + ".out_proj"),
                                           name + ".norm"))
            name = f"{T}.ffn_{i}"
            output = []
            for s in range(S):
                y = self.layer_norm(new[s], name + ".norm")
                h = torch.relu(self.linear(y, name + ".fc1"))
                output.append(y + self.linear(h, name + ".fc2"))
            preds = [heads_of(output[s], s) for s in range(S)]
        return torch.stack([c for c, _ in preds]), [m for _, m in preds], decisions
