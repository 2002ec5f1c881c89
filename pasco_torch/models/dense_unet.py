"""Dense-with-masks PaSCo network, inference and training, for any number
of MIMO subnets ``S = n_infers`` (counterpart of
``pasco_tpu/models/dense_unet.py:85-1506``).

Every U-Net stage computes on a dense ``[X, Z, Y, C]`` volume over the
working box with an ``[X, Z, Y]`` occupancy mask.  At inference
(``net.eval()``, the state a new net is built in) stage interiors run
through the hand-written kernels (``pasco_torch/ops``): the residual
and refiner convs through ``masked_conv3``, the encoder downs through
``down2_fused``, the dense bottleneck through ``spc_dense3d``, the decoder
preambles through ``up_preamble`` and every extraction through
``stream_extract``.  Each op returns exact zeros at
mask-invalid cells, so no stage needs a separate masking pass.

In training (``net.train()``) BatchNorm normalises with batch statistics,
so the BN affines cannot fold into kernel prologues.  As in the
reference's train branches, every 3^3 conv runs unfused as the
differentiable :class:`~pasco_torch.ops.conv.MaskedConv3Fn` (forward and
data gradient on the conv kernel), the downs and up-preambles run as plain
PyTorch (XLA in the reference), the decoder keep sets are capped by
:func:`~pasco_torch.ops.dense_ops.cap_keep_gumbel`, and extraction gathers
the payload rows differentiably.  ``cfg.model.remat`` rematerialises the
residual blocks, the bottleneck and the refiners as flax's ``nn.remat``
does.  On a CPU tensor every op runs its plain PyTorch version.

Submodule and parameter names equal the flax names, and parameters keep
the flax shapes (conv kernels ``[taps, Ci, Co]``, BN ``scale``/``bias``/
``mean``/``var``); :mod:`pasco_torch.convert` maps a flax variable tree
onto this module.

At ``S > 1`` the subnets share the backbone: the featurizer scatters each
point into its subnet's lane block of the ``S * f``-wide ``enc_in`` input,
the heads emit ``S * K`` logits, and each subnet runs its own refiner on
its own keep set and its own query set in the transformer.

A batch of ``B`` scans (every array of the ``ModelInput`` with a leading
``B``: the stacked input that the reference's ``bench.py`` runs through
``jax.vmap``) runs through the same body at once: every volume and mask
carries ``B`` in front, the box has one corner per scan, rows 1-3 take the
whole batch in one launch each, each extraction launches once per scan
(``capacity`` rows each), the bottleneck's convs run at N = B and the
transformer's products are batched over the scans.  One scan is the case
``B = 1``, with the batch axis taken off the outputs.  The batch is an
inference path, as the reference's only batched caller is: at ``B > 1``
training mode and MC dropout raise.

Dropout follows the reference's ``drop_on = train or mc_dropout``
(``dense_unet.py:1102-1105``): in training mode, and at inference under
``mc_dropout=True`` (MC dropout: BatchNorm keeps its running statistics
and the caps stay off), the point dropout, the whole-channel spatial
dropouts (:class:`SpatialDropout`, after each encoder stage, after the
bottleneck and before each decoder stage's heads) and the transformer
dropout are live.  Every random draw is made outside the rematerialised
regions: ``torch.utils.checkpoint`` restores only the default generators,
not the explicit ``generator`` threaded through the forward, so a draw
inside a region would change on recompute.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pasco_torch.core.config import PaSCoConfig
from pasco_torch.core.sparse import Box, SparseGrid, stack_grids
from pasco_torch.models.blocks import (
    ConvParams, SpatialDropout, add_dropout, apply_dropout, compute_dtype_of, flax_init_)
from pasco_torch.models.bottleneck import SPCDense3D
from pasco_torch.models.cylinder_feat import PointMLP
from pasco_torch.models.norm import BatchNorm, masked_sums
from pasco_torch.models.transformer import TransformerPredictor
from pasco_torch.models.unet import ModelInput, ModelOutput, scan_output
from pasco_torch.ops.conv import MaskedConv3Fn, conv_tiles, masked_conv3
from pasco_torch.ops.deconv import up_preamble, up_tiles
from pasco_torch.ops.dense_ops import (
    bbox_mask, cap_keep_gumbel, deconv2_dense, down2_dense, extract_sparse,
    extract_sparse_train, maxpool2_mask, point_dropout, upsample2_mask)
from pasco_torch.ops.down import down2_fused, down_tiles
from pasco_torch.ops.featurizer import enc_in_1x1, scatter_points
from pasco_torch.utils import timing


def _tiles(fn, mask):
    """Tile list for the CUDA kernels; the plain versions take none."""
    return fn(mask) if mask.is_cuda else None


def _remat(on: bool, fn, *args):
    """``fn(*args)``, recomputed in backward when ``on`` (flax ``nn.remat``)."""
    if on and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _masked(x, mask):
    return torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class DenseResBlock(nn.Module):
    """Pre-activation residual block.  Inference: two fused convs,
    ``conv1`` with the bn1 affine + relu prologue, ``conv2`` with the bn2
    prologue and the residual add + relu epilogue (``dense_unet.py:471-505``).
    Training: bn1, relu, conv1, bn2, relu, conv2, skip add, relu
    (``dense_unet.py:429-469``).  ``x`` is zero at invalid cells and so is
    every conv output, so the sum needs no mask."""

    def __init__(self, ch: int):
        super().__init__()
        self.bn1, self.bn2 = BatchNorm(ch), BatchNorm(ch)
        self.conv1 = ConvParams((27, ch, ch), (ch,))
        self.conv2 = ConvParams((27, ch, ch), (ch,))

    def forward(self, x, mask, tiles):
        if self.training:
            f = torch.relu(self.bn1(x, mask))
            f = MaskedConv3Fn.apply(f, mask, self.conv1.kernel, self.conv1.bias, tiles)
            f = torch.relu(self.bn2(f, mask))
            f = MaskedConv3Fn.apply(f, mask, self.conv2.kernel, self.conv2.bias, tiles)
            return torch.relu(x + f)
        f = masked_conv3(x, mask, self.conv1.kernel, self.conv1.bias,
                         affine=self.bn1.affine(), relu_in=True, tiles=tiles)
        return masked_conv3(f, mask, self.conv2.kernel, self.conv2.bias,
                            affine=self.bn2.affine(), relu_in=True, skip=x,
                            relu_out=True, tiles=tiles)


def _res_stack(stage, x, mask, tiles):
    for i in range(stage.n_res):
        x = _remat(stage.remat and stage.training, getattr(stage, f"res{i}"),
                   x, mask, tiles)
    return x


class DenseDown(nn.Module):
    """ks=2/s=2 down conv + bn1 + leaky + bn2 + relu, one fused kernel."""

    def __init__(self, ci: int, co: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros((8, ci, co)))
        self.bias = nn.Parameter(torch.zeros((co,)))
        self.bn1, self.bn2 = BatchNorm(co), BatchNorm(co)

    def forward(self, x, mask):
        new_mask = maxpool2_mask(mask)
        if self.training:   # plain stride-2 conv + BN-train (dense_unet.py:517-555)
            f = down2_dense(x, self.kernel, self.bias)
            f = F.leaky_relu(self.bn1(f, new_mask), 0.01)
            return torch.relu(self.bn2(f, new_mask)), new_mask
        out = down2_fused(x, mask, new_mask, self.kernel, self.bias,
                          self.bn1.affine(), self.bn2.affine(),
                          tiles=_tiles(down_tiles, new_mask))
        return out, new_mask


class DenseEncStage(nn.Module):
    """Optional down step + residual stack; returns (x, mask)."""

    def __init__(self, ci: int, co: int, down: bool, n_res: int, remat: bool):
        super().__init__()
        if down:
            self.down = DenseDown(ci, co)
        self.n_res, self.remat = n_res, remat
        for i in range(n_res):
            self.add_module(f"res{i}", DenseResBlock(co))

    def forward(self, x, mask):
        if hasattr(self, "down"):
            x, mask = self.down(x, mask)
        return _res_stack(self, x, mask, _tiles(conv_tiles, mask)), mask


class DenseDecoderStage(nn.Module):
    """Generative decoder stage: fused up-preamble (deconv, up_bn, leaky,
    coords, resize_bn, resize, union skip add) -> residual stack ->
    per-subnet semantic heads (``dense_unet.py:698-969``)."""

    def __init__(self, ci: int, ch: int, n_infers: int, n_classes: int,
                 n_res: int, scale: int, remat: bool, dropout: float = 0.0):
        super().__init__()
        self.scale, self.n_res, self.remat = scale, n_res, remat
        add_dropout(self, "drop", dropout, f"dec_s{scale}/drop")
        self.up_kernel = nn.Parameter(torch.zeros((8, ci, ch)))
        self.up_bias = nn.Parameter(torch.zeros((ch,)))
        self.up_bn = BatchNorm(ch)
        self.resize_bn = BatchNorm(ch + 3)
        self.resize = ConvParams((1, ch + 3, ch), (ch,))
        for i in range(n_res):
            self.add_module(f"res{i}", DenseResBlock(ch))
        self.head_kernel = nn.Parameter(torch.zeros((n_infers, ch, n_classes)))
        self.head_bias = nn.Parameter(torch.zeros((n_infers, n_classes)))

    def forward(self, x, parent_keep, skip, skip_mask, box, gmin, gmax,
                generator=None, live=False):
        """Volumes ``[B, X, Z, Y, C]``, masks ``[B, X, Z, Y]``, ``box`` and
        ``gmin``/``gmax`` one row per scan; training takes one scan."""
        msk_child = upsample2_mask(parent_keep) & bbox_mask(
            box, self.scale, gmin, gmax)
        msk = msk_child | skip_mask
        if self.training:
            x = self._preamble_train(x[0], parent_keep[0], msk_child[0], skip[0],
                                     Box(box.minimum[0], box.extent))[None]
        else:
            x = up_preamble(
                x, parent_keep, msk_child, msk, skip, box, self.scale,
                self.up_kernel, self.up_bias, self.up_bn.affine(),
                self.resize_bn.affine(), self.resize.kernel[0], self.resize.bias,
                tiles=_tiles(up_tiles, msk),
            )
        x = _res_stack(self, x, msk, _tiles(conv_tiles, msk))
        return self._finish(x, msk, generator, live)

    def _preamble_train(self, x, parent_keep, msk_child, skip, box):
        """The unfused train preamble (``dense_unet.py:775-830``): plain
        deconv, up_bn over the child set, leaky, the coordinate resize,
        then the union add with the skip (zero outside ``skip_mask``)."""
        x = deconv2_dense(_masked(x, parent_keep), self.up_kernel, self.up_bias)
        x = F.leaky_relu(self.up_bn(x, msk_child), 0.01)
        return _masked(self._resize(x, msk_child, box), msk_child) + skip.to(x.dtype)

    def _resize(self, x, mask, box):
        """``resize_bn`` + the 1x1 ``resize`` over [features, cell coords /
        scale] without the concat (``DenseBNResizeCoords``,
        ``dense_unet.py:171-291``): the coordinate channels' statistics
        come from the mask's marginal counts, and their contribution to the
        1x1 is three rank-1 broadcast terms."""
        X, Z, Y, ch = x.shape
        s, mn, dev = self.scale, box.minimum, x.device

        def axis(n, m):   # coord / scale, rounded to x's dtype as the reference does
            v = (torch.arange(n, device=dev, dtype=torch.int32) * s + m).float() / s
            return v.to(x.dtype).float()

        cx, cz, cy = axis(X, mn[0]), axis(Z, mn[2]), axis(Y, mn[1])

        bn = self.resize_bn

        def moments():
            cnt, s1, s2 = masked_sums(x, mask)
            mf = mask.float()
            m_x, m_z, m_y = mf.sum((1, 2)), mf.sum((0, 2)), mf.sum((0, 1))
            s1c = torch.stack([m_x @ cx, m_y @ cy, m_z @ cz])
            s2c = torch.stack([m_x @ cx.square(), m_y @ cy.square(), m_z @ cz.square()])
            return bn.moments(cnt, torch.cat([s1, s1c]), torch.cat([s2, s2c]))

        mean, var = bn.stats(moments)
        inv = torch.rsqrt(var + bn.epsilon) * bn.scale
        shift = bn.bias - mean * inv
        wr, br = self.resize.kernel[0], self.resize.bias
        out = (x.float() * inv[:ch] + shift[:ch]) @ wr[:ch]
        cc = [c * inv[ch + j] + shift[ch + j] for j, c in enumerate((cx, cy, cz))]
        coord = (cc[0][:, None, None, None] * wr[ch]
                 + cc[2][None, :, None, None] * wr[ch + 2]
                 + cc[1][None, None, :, None] * wr[ch + 1] + br)
        return (out + coord).to(x.dtype)

    def _finish(self, x, msk, generator=None, live=False):
        """The stage's spatial dropout where ``live`` (``dense_unet.py:
        876-884``: the returned volume, which the refiners read, is the
        dropped one), then the per-subnet sem heads.  The logits are
        rounded to bf16 and the argmax reads the ROUNDED logits, like the reference
        (``dense_unet.py:898-915, 951-968``): extraction sets depend on the
        tie rule.  Returns (x, sem [B,X,Z,Y,S,K] bf16, top_class
        [B,X,Z,Y,S], top_prob [B,X,Z,Y,S] bf16 (training only, else None),
        msk)."""
        x = apply_dropout(self, "drop", x, generator, live)
        S, ch, K = self.head_kernel.shape
        w = self.head_kernel.to(x.dtype).float().permute(1, 0, 2).reshape(ch, S * K)
        sem = x.reshape(-1, ch).float() @ w + self.head_bias.reshape(-1)
        sem = sem.to(torch.bfloat16).reshape(*x.shape[:-1], S, K)
        top_class = sem.argmax(dim=-1).to(torch.int32)
        top_prob = None
        if self.training:
            # softmax prob of the argmax: 1 / sum(exp(sem - max)), the
            # difference rounded as the bf16 logits are (reduce_sem)
            with torch.no_grad():
                mx = sem.amax(dim=-1, keepdim=True)
                se = (sem - mx).float().exp().sum(-1)
                top_prob = torch.where(msk[..., None], (1.0 / se).to(torch.bfloat16),
                                       torch.zeros((), dtype=torch.bfloat16,
                                                   device=sem.device))
        sem = torch.where(msk[..., None, None], sem,
                          torch.zeros((), dtype=sem.dtype, device=sem.device))
        top_class = torch.where(msk[..., None], top_class,
                                torch.zeros_like(top_class))
        return x, sem, top_class, top_prob, msk


class DenseVoxelFeatsRefiner(nn.Module):
    """Per-subnet two-conv refiner (``decoder_v3.py:266-283``).  The
    parameters carry the vmapped subnet axis in front, as in flax."""

    def __init__(self, ch: int, n_infers: int):
        super().__init__()
        S = n_infers
        self.conv1 = ConvParams((S, 27, ch, ch))
        self.bn = BatchNorm((S, ch))
        self.conv2 = ConvParams((S, 27, ch, ch), (S, ch))

    def forward(self, x, keep, s: int, tiles):
        """Subnet ``s`` on its keep set (``tiles`` from ``conv_tiles(keep)``).
        Inference: conv1 with a mask-only prologue and no bias, then conv2
        with the bn affine + relu prologue (``dense_unet.py:1034-1061``).
        Training: conv1, BN-train, relu, conv2 (``dense_unet.py:1012-1031``),
        both convs through the differentiable conv kernel."""
        if self.training:
            g = MaskedConv3Fn.apply(x, keep, self.conv1.kernel[s], None, tiles)
            f = torch.relu(self.bn(g, keep, index=s))
            return MaskedConv3Fn.apply(f, keep, self.conv2.kernel[s],
                                       self.conv2.bias[s], tiles)
        a, c = self.bn.affine()
        g = masked_conv3(x, keep, self.conv1.kernel[s], tiles=tiles)
        return masked_conv3(g, keep, self.conv2.kernel[s], self.conv2.bias[s],
                            affine=(a[s], c[s]), relu_in=True, tiles=tiles)


class DensePaSCoNet(nn.Module):
    """Dense-mode end-to-end network; same inputs/outputs as the reference."""

    def __init__(self, cfg: PaSCoConfig):
        super().__init__()
        m = cfg.model
        self.cfg = cfg
        fm = m.f_maps
        n_res = m.res_blocks if m.res_blocks is not None else (0 if m.heavy_decoder else 3)
        dec_n_res = m.res_blocks if m.res_blocks is not None else (7 if m.heavy_decoder else 3)
        S = m.n_infers
        self.point_mlp = PointMLP(m.in_channels, m.f)
        self.enc_in = ConvParams((1, S * m.f, fm[0]), (fm[0],))
        self.enc_s1 = DenseEncStage(fm[0], fm[0], False, n_res, m.remat)
        for si, stride in enumerate((2, 4, 8)):
            self.add_module(f"enc_s{stride}", DenseEncStage(
                fm[si], fm[si + 1], True, n_res, m.remat))
            name = f"enc_drop_s{stride}"
            add_dropout(self, name, m.encoder_dropouts[-3 + si], name)
        self.bottleneck = SPCDense3D(fm[3])
        add_dropout(self, "dense3d_drop", m.dense3d_dropout, "dense3d_drop")
        dec_ch = fm[::-1]
        for i, scale in enumerate((4, 2, 1)):
            self.add_module(f"dec_s{scale}", DenseDecoderStage(
                dec_ch[i], dec_ch[i + 1], S, m.n_classes, dec_n_res, scale, m.remat,
                m.decoder_dropouts[i]))
        for scale, ch in zip((4, 2, 1), dec_ch[1:]):
            self.add_module(f"voxel_feats_s{scale}", DenseVoxelFeatsRefiner(ch, S))
        self.transformer = TransformerPredictor(
            m.transformer, m.n_classes, S, (m.f * 4, m.f * 2, m.f))
        self.eval()   # built for inference; net.train() selects the training forward

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random init with the flax initializer families
        (:func:`~pasco_torch.models.blocks.flax_init_`)."""
        flax_init_(self, generator)

    def forward(self, inp: ModelInput,
                labelweights: Optional[Dict[int, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                mc_dropout: bool = False,
                is_predict_panop: bool = True,
                box_extent: Optional[Tuple[int, int, int]] = None) -> ModelOutput:
        """One scene, or a batch of scenes (below).  In training mode
        (``self.training``) ``labelweights`` (scale -> [n_classes]
        completion weights) weight the decoder caps' sampling scores, and ``generator`` (on the input's device) draws the
        dropouts and the caps' Gumbel noise.  ``mc_dropout=True`` keeps
        every dropout live at inference (MC dropout, ``pasco_tpu/training/
        step.py:324-341``); different generators give different samples.
        ``is_predict_panop=False`` (the sem-only pretraining phase) skips
        the refiners and the transformer, as the reference does
        (``dense_unet.py:1384, 1491``): ``panop_grids`` is empty,
        ``sem_logits_pruned`` zero and ``predictor`` None.  ``box_extent``
        is the working box of this call (``cfg.scene.box_extent`` by
        default); :class:`~pasco_torch.inference.dispatch.AdaptiveForward`
        picks it per scan from ``cfg.scene.box_candidates``.

        A ``ModelInput`` whose arrays carry a leading ``B``
        (:func:`~pasco_torch.models.unet.stack_inputs`) is a batch of scans
        in one box: every tensor of the returned ``ModelOutput`` carries
        that ``B`` in front, as ``jax.vmap(net.apply)`` returns it
        (:func:`~pasco_torch.models.unet.scan_output` takes scan ``b``).
        At ``B > 1`` the call must be an inference (``net.eval()``, no
        ``mc_dropout``)."""
        batched = inp.point_feats.dim() == 3
        if batched and inp.point_feats.shape[0] > 1 and (self.training or mc_dropout):
            raise ValueError("a batch of scans (B > 1) runs at inference only: not in "
                             "training mode or under mc_dropout")
        out = self._forward(inp if batched else ModelInput(*(t[None] for t in inp)),
                            labelweights, generator, mc_dropout, is_predict_panop, box_extent)
        return out if batched else scan_output(out, 0)

    def _forward(self, inp: ModelInput, labelweights, generator, mc_dropout: bool,
                 is_predict_panop: bool, box_extent) -> ModelOutput:
        """The forward on a batch of ``B`` scans (``B = 1`` for one).  The
        U-Net's dense volumes live in :meth:`_unet` alone, so they are freed
        before the transformer, whose working set is the forward's
        largest."""
        live = self.training or mc_dropout
        box = Box.create(inp.global_min, box_extent or self.cfg.scene.box_extent)   # [B, 3]
        xs, sem_at, panop_grids, sem_pruned = self._unet(
            inp, labelweights, generator, live, is_predict_panop, box)
        predictor = None
        if is_predict_panop:
            with timing.span("transformer"):
                predictor = self.transformer(panop_grids, box, generator, live)
        if sem_pruned is None:   # inference reads none
            m = self.cfg.model
            sem_pruned = torch.zeros((inp.point_feats.shape[0], m.n_infers,
                                      self.cfg.capacity.panop_s1, m.n_classes),
                                     device=box.minimum.device)
        return ModelOutput(
            sem_grids=xs,
            sem_logits=sem_at,
            panop_grids=panop_grids,
            sem_logits_pruned=sem_pruned,
            predictor=predictor,
        )

    def _unet(self, inp: ModelInput, labelweights, generator, live: bool,
              is_predict_panop: bool, box: Box):
        """Featurizer, encoder, bottleneck, decoder and refiners: the
        kept cells and logits of each scale, the refined grids and, in
        training, the pruned logits (else None)."""
        train = self.training
        cfg = self.cfg
        m = cfg.model
        cap = cfg.capacity
        S = m.n_infers
        B = inp.point_feats.shape[0]
        cd = compute_dtype_of(m)
        ex, ey, ez = box.extent

        # ---- point MLP + scatter-max featurizer --------------------------
        with timing.span("featurize"):
            pm = inp.point_mask
            if live and m.encoder_dropouts[0] > 0.0:
                pm = point_dropout(pm, m.encoder_dropouts[0], generator)
            f = self.point_mlp(inp.point_feats, pm)
            rel = inp.point_coords[..., 1:] - box.minimum[:, None, :]
            in_box = (pm & (rel >= 0).all(-1) & (rel[..., 0] < ex)
                      & (rel[..., 1] < ey) & (rel[..., 2] < ez))
            # One row per (cell, subnet): subnet s lands in lane block s of the
            # S * f-wide enc_in input (dense_unet.py:1202-1216; the packed form
            # :1165-1167 has the same order per z-slot).  Every empty (cell,
            # subnet) row is zero, not only empty cells: a cell that one subnet
            # occupies and another does not is mask-valid, and enc_in mixes its
            # lane blocks (dense_unet.py:1178-1189).
            subnet = inp.point_coords[..., 0].clamp(0, S - 1)
            x, occ = scatter_points(f, rel, in_box, subnet, S, box.extent, cd)
            mask1 = occ.any(-1)
            x = enc_in_1x1(x, mask1, self.enc_in.kernel[0], self.enc_in.bias)

        # ---- encoder -------------------------------------------------------
        with timing.span("encoder"):
            enc = {1: self.enc_s1(x, mask1)}
            for stride in (2, 4, 8):
                # The next stage's down and the decoder's skip read the dropped
                # volume (dense_unet.py:1258-1268).
                x, msk = getattr(self, f"enc_s{stride}")(*enc[stride // 2])
                enc[stride] = (apply_dropout(self, f"enc_drop_s{stride}", x, generator, live),
                               msk)

        # ---- dense bottleneck at stride 8 ([B, X, Y, Z] inside) -----------
        with timing.span("bottleneck"):
            x8 = enc[8][0].permute(0, 1, 3, 2, 4).float()
            xb = _remat(m.remat and train, self.bottleneck, x8, cd)
            xb = apply_dropout(self, "dense3d_drop", xb.to(cd), generator,
                               live).permute(0, 1, 3, 2, 4)
            mask8 = bbox_mask(box, 8, inp.global_min, inp.global_max)
            x = torch.where(mask8[..., None], xb, torch.zeros((), dtype=cd,
                                                              device=xb.device)).contiguous()
        parent_keep = mask8

        # ---- generative decoder + extraction -------------------------------
        xs: Dict[int, SparseGrid] = {}
        sem_at: Dict[int, torch.Tensor] = {}
        dense = {}
        for scale in (4, 2, 1):
            with timing.span(f"decoder.s{scale}"):
                stage = getattr(self, f"dec_s{scale}")
                x, sem, top_class, top_prob, msk = stage(
                    x, parent_keep, enc[scale][0], enc[scale][1], box,
                    inp.global_min, inp.global_max, generator, live)
                keep = (top_class != 0).any(-1) & msk
                dcap = cap.dec_capacity(scale)
                if train:
                    # Train-time voxel cap (dense_unet.py:1322-1335): the capped
                    # keep feeds the extractions and the next stage.
                    tp = top_prob.float()
                    w = None if labelweights is None else labelweights.get(scale)
                    if w is not None:
                        tp = tp * w.to(tp.device)[top_class.long()]
                    score = (tp * (top_class != 0)).amax(-1)
                    keep = cap_keep_gumbel(keep, score, dcap, generator)
                dense[scale] = (x, sem, top_class, keep)
                # Inference reads scale 1's logits only; training supervises all
                # three.  The grids' features have no consumer (zeros, as in
                # the reference).
                payload = sem.reshape(*sem.shape[:-2], -1)
                if train:
                    coords, valid, vals = extract_sparse_train(keep, box, scale, dcap, payload)
                else:
                    coords, valid, vals = extract_sparse(
                        keep, box, scale, dcap, payload if scale == 1 else None)
                feats = torch.zeros((B, dcap, x.shape[-1]), dtype=x.dtype, device=x.device)
                xs[scale] = SparseGrid(coords, feats, valid, scale)
                sem_at[scale] = (
                    vals.float().reshape(B, dcap, S, m.n_classes) if train or scale == 1
                    else torch.zeros((B, dcap, S, m.n_classes), device=x.device)
                )
            parent_keep = keep

        # ---- per-subnet refiners + extraction ------------------------------
        panop_grids: Dict[int, SparseGrid] = {}
        sem_pruned = None
        for scale in (4, 2, 1) if is_predict_panop else ():
            with timing.span(f"refiner.s{scale}"):
                xd, sem, top_class, dkeep = dense[scale]
                refiner = getattr(self, f"voxel_feats_s{scale}")
                pcap = cap.panop_capacity(scale)
                sub, sub_sem = [], []
                for s in range(S):
                    keep_s = ((top_class[..., s] != 0) & dkeep & bbox_mask(
                        box, scale, inp.subnet_min[:, s], inp.subnet_max[:, s]))
                    refined = _remat(m.remat and train, refiner, xd, keep_s, s,
                                     _tiles(conv_tiles, keep_s))
                    if train:
                        coords, valid, vals = extract_sparse_train(
                            keep_s, box, scale, pcap, refined)
                        if scale == 1:   # pruned logits for the criterion
                            sub_sem.append(extract_sparse_train(
                                keep_s, box, scale, pcap, sem[..., s, :])[2].float())
                    else:
                        coords, valid, vals = extract_sparse(
                            keep_s, box, scale, pcap, refined)
                    coords[..., 0] = s
                    sub.append(SparseGrid(coords, vals, valid, scale))
                panop_grids[scale] = stack_grids(sub, dim=1)      # [B, S, cap, ...]
                if sub_sem:
                    sem_pruned = torch.stack(sub_sem, 1)
        return xs, sem_at, panop_grids, sem_pruned
