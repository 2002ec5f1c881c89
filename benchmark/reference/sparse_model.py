"""Plain PyTorch reference of PaSCo's sparse-substrate forward at inference
(``PaSCoNet`` in ``net.eval()``, the MinkowskiEngine network as published),
in float32.

It imports nothing of the program.  It reads the benchmark's weights by
parameter name, the configuration file's dictionary and one scan's input
arrays.  Each sparse conv is written the textbook way, with no kernel map:
the input set's features on a dense ``[X, Y, Z, C]`` volume over the
working box, zero off the set, through ``F.conv3d`` (a submanifold 3x3x3
conv, read at the same set; a stride-2 down conv, read at the pooled set)
or ``F.conv_transpose3d`` (the generative up conv, every child of a kept
parent), so that the comparison holds the program's rulebooks, tables and
gathers to what they stand for.  The dense bottleneck and the mask
transformer are :class:`~benchmark.reference.model.Reference`'s.

Which cells exist follows the program's published semantics at its
padded capacities, worked out again here from the scan:

* a grid's row order is the order of first occurrence: the encoder's cells
  at stride ``s`` in the order of the first point that falls in them; the
  bottleneck's in flat ``(x, y, z)`` order; a stage's children by parent
  row, then by offset (x-major, z fastest);
* a capacity keeps the first rows in that order (the encoder's stages, the
  bottleneck's grid, the stride-4 children before their resize);
* the union with the encoder's skip cells fills only the rows the children
  left free, skip cells in their grid's order; the rest are dropped;
* each decoder stage keeps its ``dec_s<scale>`` best cells by score (the
  best subnet's top class probability, where some subnet's argmax is not
  "empty"), and each subnet's refiner its ``panop_s<scale>`` best by its
  top class probability.

Departures from the published description, all the port's: the padded
capacities above (MinkowskiEngine's sets have none); BatchNorm at its
running statistics; no dropout at inference.  The reference assumes a
working box that covers the scan (the benchmark's ladder picks one).

With ``follow`` (the judged side's output) every kept set is the judged
side's, so that a near tie decided the other way does not change what
follows, and ``keep_gap`` says how far from a tie the reference's own
decision was at each cell decided apart: for a cell one side's class
decision drops, the best class but "empty" against "empty"; for one that
the capacity decides, its log score against the reference's threshold;
both over the stage's largest logit.  A kept cell the reference could not
keep at all reads :data:`UNDECIDABLE`.

``rnd`` is applied wherever the program rounds to its compute dtype (as in
:mod:`benchmark.reference.model`).  ``calls`` records the products of the
last forward for ``benchmark/flops.py`` and ``benchmark/sparse_flops.py``:
a sparse conv is a ``conv3`` record whose ``pairs`` are the (output cell,
input neighbour) pairs that exist, with ``taps`` and ``rows_in`` (the
input cells it reads) besides.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.model import UNDECIDABLE, Reference, identity, pick_box

BOTTLENECK = "dense_bottleneck.spc."
SCALES = (4, 2, 1)
NEVER = torch.iinfo(torch.int64).max      # the rank of a cell that holds no row


class SparseReference(Reference):
    """The sparse substrate's forward of one scan; ``w`` maps parameter
    names to f32 tensors on the device the reference runs on."""

    def __init__(self, cfg: dict, w: Dict[str, torch.Tensor], rnd=identity):
        if cfg["model"]["heavy_decoder"]:
            raise ValueError("the sparse reference follows the released light decoder")
        w = dict(w)
        for k in [k for k in w if k.startswith(BOTTLENECK)]:
            w["bottleneck." + k[len(BOTTLENECK):]] = w[k]
        super().__init__(cfg, w, rnd)

    # ---- the working box ----------------------------------------------------

    def dims(self, stride: int) -> List[int]:
        return [-(-e // stride) for e in self.box_extent]

    def flat(self, coords: torch.Tensor, stride: int):
        """(flat ``[X, Y, Z]`` index at ``stride``, inside the box) of
        absolute coordinates ``[n, 3]``."""
        d = self.dims(stride)
        rel = torch.div(coords.long() - self.box_min[None], stride, rounding_mode="floor")
        inside = ((rel >= 0) & (rel < torch.tensor(d, device=rel.device))).all(1)
        rel = torch.where(inside[:, None], rel, torch.zeros_like(rel))
        return (rel[:, 0] * d[1] + rel[:, 1]) * d[2] + rel[:, 2], inside

    def coords_of(self, mask: torch.Tensor, stride: int) -> torch.Tensor:
        """Absolute coordinates ``[n, 3]`` of a mask's cells, flat order."""
        return mask.nonzero() * stride + self.box_min[None]

    def mask_of(self, coords: torch.Tensor, stride: int):
        """(the cells of ``coords`` as a mask at ``stride``, whether every
        one lies in the box)."""
        idx, inside = self.flat(coords, stride)
        m = torch.zeros(math.prod(self.dims(stride)), dtype=torch.bool, device=coords.device)
        m[idx[inside]] = True
        return m.reshape(self.dims(stride)), bool(inside.all())

    def axes(self, stride):
        dev = self.box_min.device
        return [self.box_min[j] + torch.arange(n, device=dev) * stride
                for j, n in enumerate(self.dims(stride))]

    def bbox(self, stride, lo, hi) -> torch.Tensor:
        ax, ay, az = self.axes(stride)
        return (((ax >= lo[0]) & (ax <= hi[0]))[:, None, None]
                & ((ay >= lo[1]) & (ay <= hi[1]))[None, :, None]
                & ((az >= lo[2]) & (az <= hi[2]))[None, None, :])

    @staticmethod
    def first_cap(mask: torch.Tensor, rank: torch.Tensor, cap: int) -> torch.Tensor:
        """The ``cap`` cells of ``mask`` of least ``rank``."""
        if int(mask.sum()) <= cap:
            return mask
        r = torch.where(mask, rank, NEVER).reshape(-1)
        keep = torch.zeros_like(r, dtype=torch.bool)
        keep[torch.topk(r, cap, largest=False).indices] = True
        return keep.reshape(mask.shape)

    @staticmethod
    def pool_rank(rank: torch.Tensor) -> torch.Tensor:
        """Each parent cell's least child rank (``NEVER`` without a child)."""
        X, Y, Z = (-(-n // 2) * 2 for n in rank.shape)
        r = F.pad(rank, (0, Z - rank.shape[2], 0, Y - rank.shape[1], 0, X - rank.shape[0]),
                  value=NEVER)
        return r.reshape(X // 2, 2, Y // 2, 2, Z // 2, 2).amin(5).amin(3).amin(1)

    # ---- the sparse convs -----------------------------------------------------

    def _vol(self, x):
        return x.permute(3, 0, 1, 2)[None]

    def _unvol(self, y):
        return y[0].permute(1, 2, 3, 0)

    def _zero_off(self, x, mask):
        return torch.where(mask[..., None], x, torch.zeros((), device=x.device))

    def _record(self, ci, co, taps, cells, pairs, rows_in):
        self.count("conv3", cells=cells, pairs=pairs, ci=ci, co=co, skip=0, mask_cells=0,
                   taps=taps, rows_in=rows_in)

    def subm(self, x, mask, kernel, bias=None):
        """Submanifold 3x3x3 conv on the set ``mask``:
        ``r(conv(r(x on the set), r(kernel)) [+ bias])`` at the set."""
        r = self.rnd
        ci, co = kernel.shape[-2:]
        m = mask.float()[None, None]
        around = F.conv3d(m, torch.ones((1, 1, 3, 3, 3), device=m.device), padding=1)
        n = int(mask.sum())
        self._record(ci, co, 27, n, int((around * m).sum()), n)
        wk = r(kernel).reshape(3, 3, 3, ci, co).permute(4, 3, 0, 1, 2)
        out = self._unvol(F.conv3d(self._vol(r(self._zero_off(x, mask))), wk, padding=1))
        if bias is not None:
            out = out + bias
        return r(self._zero_off(out, mask))

    def down(self, x, mask_in, mask_out, kernel, bias):
        """Kernel-2 stride-2 conv of the set ``mask_in`` read at its pooled
        set ``mask_out``."""
        r = self.rnd
        ci, co = kernel.shape[-2:]
        X, Y, Z = (-(-n // 2) * 2 for n in mask_in.shape)
        pad = (0, Z - mask_in.shape[2], 0, Y - mask_in.shape[1], 0, X - mask_in.shape[0])
        y = F.pad(self._vol(r(self._zero_off(x, mask_in))), pad)
        wk = r(kernel).reshape(2, 2, 2, ci, co).permute(4, 3, 0, 1, 2)
        out = self._unvol(F.conv3d(y, wk, stride=2))[: mask_out.shape[0], : mask_out.shape[1],
                                                      : mask_out.shape[2]]
        kids = F.conv3d(F.pad(mask_in.float()[None, None], pad),
                        torch.ones((1, 1, 2, 2, 2), device=x.device), stride=2)[0, 0]
        kids = kids[: mask_out.shape[0], : mask_out.shape[1], : mask_out.shape[2]]
        n = int((kids * mask_out).sum())
        self._record(ci, co, 8, int(mask_out.sum()), n, n)
        return r(self._zero_off(out + bias, mask_out))

    def up(self, x, mask_par, kernel, bias, dims):
        """Generative kernel-2 stride-2 transposed conv: every cell of
        ``mask_par`` gives its 8 children (a volume of ``dims``)."""
        r = self.rnd
        ci, co = kernel.shape[-2:]
        n = int(mask_par.sum())
        self._record(ci, co, 8, 8 * n, 8 * n, n)
        wk = r(kernel).reshape(2, 2, 2, ci, co).permute(3, 4, 0, 1, 2)
        out = self._unvol(F.conv_transpose3d(self._vol(r(self._zero_off(x, mask_par))), wk,
                                             stride=2))
        return r(out[: dims[0], : dims[1], : dims[2]] + bias)

    @staticmethod
    def max_pool(x, mask):
        """Non-overlapping 2x2x2 max over the cells of the set ``mask``
        (the program's ``sparse_max_pool``): (the features, the pooled
        set)."""
        X, Y, Z = (-(-n // 2) * 2 for n in mask.shape)
        pad = (0, Z - mask.shape[2], 0, Y - mask.shape[1], 0, X - mask.shape[0])
        y = torch.where(mask[..., None], x, torch.full((), -math.inf, device=x.device))
        y = F.max_pool3d(F.pad(y.permute(3, 0, 1, 2)[None], pad, value=-math.inf), 2)
        y = y[0].permute(1, 2, 3, 0)
        return torch.where(torch.isfinite(y), y, torch.zeros((), device=x.device)), \
            torch.isfinite(y).all(-1)

    def bn_(self, x, name, index=None):
        return self.rnd(self.bn(x, name, index))

    def res_block(self, x, mask, name):
        """``relu(x + conv2(relu(bn2(conv1(relu(bn1(x)))))))`` on the set."""
        r = self.rnd
        f = torch.relu(self.bn_(x, name + ".bn1"))
        g = self.subm(f, mask, self.p(name + ".conv1.kernel"), self.p(name + ".conv1.bias"))
        f = torch.relu(self.bn_(g, name + ".bn2"))
        g = self.subm(f, mask, self.p(name + ".conv2.kernel"), self.p(name + ".conv2.bias"))
        return self._zero_off(torch.relu(r(x + g)), mask)

    def res_stack(self, x, mask, prefix):
        for i in range(self.n_res):
            x = self.res_block(x, mask, f"{prefix}{i}")
        return x

    def one_by_one(self, x, mask, kernel, bias):
        r = self.rnd
        self.count("mm", rows=mask.sum(), k=kernel.shape[-2], n=kernel.shape[-1])
        return r(self._zero_off(r(x) @ r(kernel[0]) + bias, mask))

    # ---- the keep decisions -----------------------------------------------------

    def judge(self, own_ok, score, margin, cap, theirs, scale):
        """The reference's own kept set (the ``cap`` best ``score`` among
        ``own_ok``) against ``theirs`` (None: no judged side): (the set to
        go on with, the widest gap of a cell decided apart over ``scale``).
        ``margin`` is each cell's class margin (positive where ``own_ok``)."""
        if int(own_ok.sum()) > cap:
            best = torch.topk(torch.where(own_ok, score, -math.inf).reshape(-1), cap)
            thr = best.values[-1]
            mine = torch.zeros(own_ok.numel(), dtype=torch.bool, device=own_ok.device)
            mine[best.indices] = True
            mine = mine.reshape(own_ok.shape)
        else:
            thr = None
            mine = own_ok
        if theirs is None:
            return mine, 0.0
        apart = mine != theirs
        if not apart.any():
            return theirs, 0.0
        m = margin[apart].abs()
        if thr is not None:
            m = torch.where(own_ok[apart], torch.minimum(m, (score[apart] - thr).abs()), m)
        return theirs, min(m.max().item() / max(scale, 1e-30), UNDECIDABLE)

    def follow_set(self, coords, stride, within):
        """The judged side's cells as a mask, and :data:`UNDECIDABLE` where
        some lie outside ``within`` (cells the reference cannot keep)."""
        theirs, inside = self.mask_of(coords, stride)
        gap = 0.0 if inside and not (theirs & ~within).any() else UNDECIDABLE
        return theirs & within, gap

    # ---- the network ------------------------------------------------------------

    def forward(self, scan: Dict[str, np.ndarray], device, follow=None) -> dict:
        """The outputs in :meth:`Reference.forward`'s form (``sem``,
        ``sem_logits``, ``panop``, ``mask_logits``, ``query_logits``,
        ``attn``, ``keep_gap``); with ``follow`` every kept set and
        attention mask is the judged side's."""
        r, S, K = self.rnd, self.S, self.K
        cap = self.cfg["capacity"]
        t = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
        pf = t(scan["point_feats"]).float()
        pc = t(scan["point_coords"]).long()
        pm = t(scan["point_mask"]).bool()
        self.gmin, self.gmax = t(scan["global_min"]).long(), t(scan["global_max"]).long()
        smin, smax = t(scan["subnet_min"]).long(), t(scan["subnet_max"]).long()
        self.box_extent = pick_box(self.cfg, scan["global_min"], scan["global_max"])
        self.box_min = self.gmin
        zero = torch.zeros((), device=device)
        self.calls = []
        out = {"sem": {}, "panop": {}, "keep_gap": 0.0}

        # point MLP, then the per-(cell, subnet) max and the subnets' union
        n_pts = pm.sum()
        for i in (1, 2, 3, 4):
            wt = self.w[f"cylinder_feat.fc{i}.weight"]
            self.count("mm", rows=n_pts, k=wt.shape[1], n=wt.shape[0])
        f = torch.where(pm[:, None], self.bn(pf, "cylinder_feat.bn_in"), zero)
        for i in (1, 2, 3):
            f = torch.where(pm[:, None], torch.relu(self.bn(
                self.linear(f, f"cylinder_feat.fc{i}"), f"cylinder_feat.bn{i}")), zero)
        f = torch.where(pm[:, None], self.linear(f, "cylinder_feat.fc4"), zero)
        cell, inside = self.flat(pc[:, 1:], 1)
        ok = pm & inside
        n_cells = math.prod(self.dims(1))
        sub = pc[:, 0].clamp(0, S - 1)
        row = torch.where(ok, cell * S + sub, n_cells * S)
        fdim = f.shape[1]
        grid = torch.full((n_cells * S + 1, fdim), -math.inf, device=device)
        grid.scatter_reduce_(0, row[:, None].expand(-1, fdim), f, "amax")
        grid = torch.where(torch.isfinite(grid), grid, zero)[:-1]
        x = r(grid.reshape(*self.dims(1), S * fdim))
        # each cell's rank: its first point
        first = torch.full((n_cells + 1,), NEVER, dtype=torch.long, device=device)
        first.scatter_reduce_(0, torch.where(ok, cell, n_cells),
                              torch.arange(pc.shape[0], device=device), "amin")
        rank = first[:-1].reshape(self.dims(1))
        mask = self.first_cap(rank < NEVER, rank, cap["enc_s1"])

        # encoder
        x = self.one_by_one(x, mask, self.p("encoder.in_conv.kernel"),
                            self.p("encoder.in_conv.bias"))
        enc = {1: (self.res_stack(x, mask, "encoder.s1_res"), mask, rank)}
        for name, stride in (("s1s2", 2), ("s2s4", 4), ("s4s8", 8)):
            xin, min_, rin = enc[stride // 2]
            rank = self.pool_rank(torch.where(min_, rin, NEVER))
            mout = self.first_cap(rank < NEVER, rank, cap[f"enc_s{stride}"])
            blk = f"encoder.{name}_down"
            y = self.down(xin, min_, mout, self.p(blk + ".SparseDownConv_0.kernel"),
                          self.p(blk + ".SparseDownConv_0.bias"))
            y = r(F.leaky_relu(self.bn_(y, blk + ".MaskedBatchNorm_0"), 0.01))
            y = self._zero_off(torch.relu(self.bn_(y, blk + ".MaskedBatchNorm_1")), mout)
            enc[stride] = (self.res_stack(y, mout, f"encoder.{name}_res"), mout, rank)

        # dense bottleneck over the whole box; its grid: every cell with a
        # non-zero channel, in flat order
        xb = r(self.bottleneck(enc[8][0]))
        par = xb.ne(0).any(-1)
        flat8 = torch.arange(par.numel(), device=device).reshape(par.shape)
        par = self.first_cap(par, flat8, cap["bottleneck"])
        rows = cap["bottleneck"] if par.numel() != cap["bottleneck"] else par.numel()
        order = flat8

        # generative decoder
        stage = {}
        for scale in SCALES:
            name = f"decoder.block_s{scale}"
            dims = self.dims(scale)
            kernel = self.p(name + ".up.kernel")
            co = kernel.shape[-1]
            d = self.up(xb, par, kernel, self.p(name + ".up.bias"), dims)
            child = self.up_mask(par)[: dims[0], : dims[1], : dims[2]] & self.bbox(
                scale, self.gmin, self.gmax)
            rows *= 8
            if scale == 4 and cap["ups_s4"] < rows:
                kid = (order[:, None, :, None, :, None] * 8 + torch.arange(
                    8, device=device).reshape(1, 2, 1, 2, 1, 2)).reshape(
                        *(2 * n for n in order.shape))[: dims[0], : dims[1], : dims[2]]
                child = self.first_cap(child, kid, cap["ups_s4"])
                rows = cap["ups_s4"]
            d = self._zero_off(r(F.leaky_relu(self.bn_(d, name + ".up_bn"), 0.01)), child)
            ax, ay, az = self.axes(scale)
            shape = tuple(dims)
            pos = torch.stack([ax[:, None, None].expand(shape), ay[None, :, None].expand(shape),
                               az[None, None, :].expand(shape)], -1).float() / scale
            fc = self._zero_off(torch.cat([d, r(pos)], -1), child)
            self.count("mm", rows=child.sum(), k=co + 3, n=co)
            rkern = self.p(name + ".resize.kernel")
            xr = r(self._zero_off(r(self.bn_(fc, name + ".resize_bn")) @ r(rkern[0])
                                  + self.p(name + ".resize.bias"), child))
            skip_x, skip_m, skip_r = enc[scale]
            xr = r(xr + self._zero_off(skip_x, skip_m & child))
            # the skip cells the children miss take the free rows, in order
            extra = skip_m & ~child
            n_free = rows - int(child.sum())
            extra = self.first_cap(extra, skip_r, max(n_free, 0)) if n_free > 0 else \
                torch.zeros_like(extra)
            union = child | extra
            xu = xr + self._zero_off(skip_x, extra)
            xu = self.res_stack(xu, union, name + ".res")
            hk = self.p(name + ".head_kernel")
            ch = hk.shape[1]
            self.count("mm", rows=union.sum(), k=ch, n=S * K)
            sem = (xu.reshape(-1, ch) @ hk.permute(1, 0, 2).reshape(ch, S * K)
                   + self.p(name + ".head_bias").reshape(-1)).reshape(*dims, S, K)
            sem = torch.where(union[..., None, None], sem, zero)
            prob = torch.softmax(sem, -1)
            top_prob, top_class = prob.amax(-1), prob.argmax(-1)
            nonempty = (top_class != 0) & union[..., None]
            score = torch.log((top_prob * nonempty).amax(-1).clamp(min=1e-20))
            margin = (sem[..., 1:].amax(-1) - sem[..., 0])
            lscale = sem.abs().amax().item()
            theirs, gap = (None, 0.0) if follow is None else self.follow_set(
                follow["sem"][scale], scale, union)
            kept, g2 = self.judge(nonempty.any(-1), score, margin.amax(-1),
                                  cap[f"dec_s{scale}"], theirs, lscale)
            out["keep_gap"] = max(out["keep_gap"], gap, g2)
            out["sem"][scale] = self.coords_of(kept, scale)
            if scale == 1:
                out["sem_logits"] = r(sem[kept])
            stage[scale] = (xu, kept, r(sem), lscale)
            rows = min(rows, cap[f"dec_s{scale}"])
            xb, par = xu, kept

        # per-subnet refiners, then the transformer
        grids = {}
        for scale in SCALES:
            # the refiners read the logits as the kept rows carry them
            xu, kept, sem, lscale = stage[scale]
            prob = torch.softmax(sem, -1)
            margin = sem[..., 1:].amax(-1) - sem[..., 0]
            pcap = cap[f"panop_s{scale}"]
            name = f"decoder.voxel_feats_s{scale}"
            rows_s, out["panop"][scale] = [], []
            for s in range(S):
                ok = (prob[..., s, :].argmax(-1) != 0) & kept & self.bbox(scale, smin[s], smax[s])
                theirs, gap = (None, 0.0) if follow is None else self.follow_set(
                    follow["panop"][scale][s], scale, kept)
                keep_s, g2 = self.judge(ok, torch.log(prob[..., s, :].amax(-1).clamp(min=1e-20)),
                                        margin[..., s], pcap, theirs, lscale)
                out["keep_gap"] = max(out["keep_gap"], gap, g2)
                g = self.subm(xu, keep_s, self.p(name + ".conv1.kernel")[s])
                g = torch.relu(self.bn_(g, name + ".bn", s))
                g = self.subm(g, keep_s, self.p(name + ".conv2.kernel")[s],
                              self.p(name + ".conv2.bias")[s])
                coords = self.coords_of(keep_s, scale)
                n = coords.shape[0]
                padded_c = torch.zeros((pcap, 3), dtype=torch.long, device=device)
                padded_f = torch.zeros((pcap, g.shape[-1]), device=device)
                padded_c[:n] = coords
                padded_f[:n] = g[keep_s]
                rows_s.append((padded_c, padded_f, torch.arange(pcap, device=device) < n))
                out["panop"][scale].append(coords)
            grids[scale] = rows_s
        theirs = None if follow is None or follow.get("attn") is None else (
            follow["attn"], follow["panop"][1])
        query, masks, out["attn"] = self.transformer(grids, theirs)
        out["query_logits"] = query
        out["mask_logits"] = [m[v] for m, (_, _, v) in zip(masks, grids[1])]
        return out
