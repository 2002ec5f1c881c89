"""Torch (reference) checkpoint -> parameter tree converter (the port's copy
of ``pasco_tpu/training/convert_torch.py``, whose converter is NumPy, plus
:func:`reference_to_state_dict` and :func:`load_reference_into`, which
chain it with :func:`pasco_torch.convert.flax_to_torch` to load a
reference ``state_dict`` into the port's net).

Maps the reference's Lightning ``.ckpt`` ``state_dict`` (PyTorch +
MinkowskiEngine module names, ``net_panoptic_sparse.py``) onto this
framework's Flax parameter tree so released checkpoints
(``pasco.ckpt`` / ``pasco_single.ckpt``, reference README.md:369-374) can
be evaluated for weight-level parity.  Targets the dense-with-masks
substrate (:class:`pasco_torch.models.dense_unet.DensePaSCoNet`, the
flagship eval path); weight layouts are shared with the sparse path.

Key layout transforms (each validated numerically against torch CPU in
``tests/test_convert_torch.py``):

* ``nn.Linear``: torch ``[out, in]`` -> flax ``[in, out]`` (transpose).
* ``nn.MultiheadAttention``: ``in_proj_weight [3H, H]`` splits into
  q/k/v thirds (torch packs q;k;v), each transposed; ``out_proj`` like a
  Linear.
* ``ME.MinkowskiConvolution`` kernel: ME stores ``[K, in, out]`` with the
  hypercube offsets enumerated **first-axis-fastest** (x fastest); our
  sparse convs (``pasco_tpu/ops/sparse_conv.py:kernel_offsets``) enumerate
  ``itertools.product`` order (z fastest).  :func:`me_kernel_permutation`
  builds the index permutation between the two orders.  1x1 ME kernels
  are stored 2D ``[in, out]`` and map to our ``[1, in, out]``.
* ``nn.Conv3d`` (dense bottleneck): torch ``[out, in, kx, ky, kz]`` ->
  ``[kx, ky, kz, in, out]``.
* BatchNorm (``nn.BatchNorm1d/3d``, ``ME.Minkowski{Sync,}BatchNorm``
  whose inner module is ``.bn``): weight/bias -> scale/bias params,
  running_mean/var -> batch_stats {mean, var}.
* Per-subnet ModuleDicts (``completion_heads.{i}``,
  ``voxel_feats.scale{s}_infer{i}``) stack into the leading subnet axis
  of our grouped/vmapped parameters.
* ME convs default to ``bias=False``; where our module has a bias the
  converter fills zeros (listed in the returned report).

The reference registers the shared ``transformer_predictor`` under three
paths (``transformer_predictor.``, ``unet3d.transformer_predictor.``,
``unet3d.decoder_generative.transformer_predictor.``) — the aliases are
consumed as duplicates.  ``num_batches_tracked`` and criterion buffers
carry no information for inference and are dropped explicitly.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pasco_torch.convert import flax_to_torch


# ---------------------------------------------------------------------------
# primitive layout transforms
# ---------------------------------------------------------------------------


def me_kernel_permutation(kernel_size: int) -> np.ndarray:
    """perm[j] = index into the ME kernel row for our offset row j."""
    if kernel_size % 2 == 1:
        r = range(-(kernel_size // 2), kernel_size // 2 + 1)
    else:
        r = range(kernel_size)
    ours = list(itertools.product(r, r, r))        # z fastest
    # ME enumerates hypercube offsets first-axis-fastest (x fastest).
    theirs = [(x, y, z) for (z, y, x) in itertools.product(r, r, r)]
    index = {off: i for i, off in enumerate(theirs)}
    return np.asarray([index[o] for o in ours], np.int64)


def convert_linear(w: np.ndarray, b: Optional[np.ndarray]) -> Dict[str, np.ndarray]:
    out = {"kernel": np.ascontiguousarray(w.T)}
    if b is not None:
        out["bias"] = np.asarray(b)
    return out


def convert_me_conv_kernel(kernel: np.ndarray, kernel_size: int) -> np.ndarray:
    """ME [K, in, out] (or [in, out] for 1x1) -> ours [K, in, out] reordered."""
    if kernel.ndim == 2:  # 1x1 conv stored as [in, out]
        return np.ascontiguousarray(kernel[None])
    perm = me_kernel_permutation(kernel_size)
    return np.ascontiguousarray(kernel[perm])


def convert_conv3d(w: np.ndarray) -> np.ndarray:
    """torch [out, in, kx, ky, kz] -> [kx, ky, kz, in, out]."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 4, 1, 0)))


def split_mha_in_proj(
    w: np.ndarray, b: np.ndarray
) -> Tuple[Dict[str, np.ndarray], ...]:
    """torch in_proj [3H, H] / [3H] -> three flax Dense {kernel [H,H], bias}."""
    h = w.shape[1]
    parts = []
    for i in range(3):
        parts.append(
            {
                "kernel": np.ascontiguousarray(w[i * h : (i + 1) * h].T),
                "bias": np.asarray(b[i * h : (i + 1) * h]),
            }
        )
    return tuple(parts)


# ---------------------------------------------------------------------------
# full-tree conversion
# ---------------------------------------------------------------------------


class _Converter:
    def __init__(self, sd: Dict[str, np.ndarray]):
        self.sd = {k: np.asarray(v) for k, v in sd.items()}
        self.params: Dict[str, Any] = {}
        self.stats: Dict[str, Any] = {}
        self.used: set = set()
        self.zero_filled: List[str] = []

    def take(self, key: str) -> np.ndarray:
        self.used.add(key)
        return self.sd[key]

    def maybe(self, key: str) -> Optional[np.ndarray]:
        if key in self.sd:
            return self.take(key)
        return None

    def put(self, tree: Dict, path: Tuple[str, ...], value) -> None:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(value)

    # -- composite layers ---------------------------------------------------

    def bn(self, path: Tuple[str, ...], ref: str, wrapped: bool = True) -> None:
        """BatchNorm at ``ref`` (inner ``.bn`` for ME wrappers) -> ``path``."""
        inner = f"{ref}.bn" if wrapped and f"{ref}.bn.weight" in self.sd else ref
        self.put(self.params, path + ("scale",), self.take(f"{inner}.weight"))
        self.put(self.params, path + ("bias",), self.take(f"{inner}.bias"))
        self.put(self.stats, path + ("mean",), self.take(f"{inner}.running_mean"))
        self.put(self.stats, path + ("var",), self.take(f"{inner}.running_var"))
        self.used.add(f"{inner}.num_batches_tracked")

    def linear(self, path: Tuple[str, ...], ref: str) -> None:
        lin = convert_linear(self.take(f"{ref}.weight"), self.maybe(f"{ref}.bias"))
        for k, v in lin.items():
            self.put(self.params, path + (k,), v)

    def me_conv(
        self, path: Tuple[str, ...], ref: str, ks: int, want_bias: bool = True
    ) -> None:
        """ME conv at ``ref`` -> {kernel [K,in,out]} (+ zero bias if ours has
        one and the reference conv was created bias-free)."""
        kernel = convert_me_conv_kernel(self.take(f"{ref}.kernel"), ks)
        self.put(self.params, path + ("kernel",), kernel)
        bias = self.maybe(f"{ref}.bias")
        if bias is not None:
            # ME conv biases are stored [1, out]; ours are [out].
            self.put(self.params, path + ("bias",), np.asarray(bias).reshape(-1))
        elif want_bias:
            self.put(
                self.params, path + ("bias",), np.zeros(kernel.shape[-1], np.float32)
            )
            self.zero_filled.append("/".join(path) + "/bias")

    def res_block(self, path: Tuple[str, ...], ref: str) -> None:
        """maskpls pre-act ResidualBlock (mink.py:618-658) -> DenseResBlock."""
        self.bn(path + ("bn1",), f"{ref}.net.0")
        self.me_conv(path + ("conv1",), f"{ref}.net.2", 3)
        self.bn(path + ("bn2",), f"{ref}.net.3")
        self.me_conv(path + ("conv2",), f"{ref}.net.5", 3)
        if f"{ref}.downsample.0.kernel" in self.sd:
            self.me_conv(path + ("downsample",), f"{ref}.downsample.0", 1)


def convert_reference_checkpoint(
    state_dict: Dict[str, np.ndarray],
    n_infers: int,
    heavy_decoder: bool = False,
) -> Tuple[Dict[str, Any], Dict[str, Any], List[str]]:
    """Convert the reference ``Net`` state_dict to the dense-substrate tree.

    Returns ``(params, batch_stats, unmatched_keys)``.  ``unmatched_keys``
    lists reference keys that carried information but found no home —
    should be empty for a released checkpoint; alias/bookkeeping keys
    (duplicate shared-transformer paths, ``num_batches_tracked``,
    criterion buffers) are consumed silently.
    """
    c = _Converter(state_dict)
    S = n_infers

    # ---- CylinderFeat point MLP (unet3d_sparse_v2.py:22-34) -------------
    pp = "feat.PPmodel"
    # torch Sequential: 0 BN1d, 1 Linear, 2 BN, 3 ReLU, 4 Linear, 5 BN,
    # 6 ReLU, 7 Linear, 8 BN, 9 ReLU, 10 Linear
    for idx, name in [(0, "bn_in"), (2, "bn1"), (5, "bn2"), (8, "bn3")]:
        c.bn(("point_mlp", name), f"{pp}.{idx}", wrapped=False)
    for idx, name in [(1, "fc1"), (4, "fc2"), (7, "fc3"), (10, "fc4")]:
        c.linear(("point_mlp", name), f"{pp}.{idx}")

    # ---- encoder (encoder_v2.py:89-183) ----------------------------------
    enc = "unet3d.encoder"
    c.me_conv(("enc_in",), f"{enc}.enc_in_feats", 1)
    n_enc_res = 0 if heavy_decoder else 3
    for i in range(n_enc_res):
        c.res_block(("enc_s1", f"res{i}"), f"{enc}.s1.{i}")
    for ref_stage, ours in [("s1s2", "enc_s2"), ("s2s4", "enc_s4"), ("s4s8", "enc_s8")]:
        base = f"{enc}.{ref_stage}"
        c.me_conv((ours, "down"), f"{base}.0.net.0", 2)
        c.bn((ours, "down", "bn1"), f"{base}.0.net.1")
        c.bn((ours, "down", "bn2"), f"{base}.1")
        for i in range(n_enc_res):
            c.res_block((ours, f"res{i}"), f"{base}.{i + 3}")

    # ---- dense bottleneck SPCDense3Dv2 (layers.py:646-726) ---------------
    d3 = "unet3d.dense3d.0"
    branch_map = (
        [(f"a_conv{k}", f"bn_{k}", f"a{k}") for k in range(1, 8)]
        + [("ch_conv1", "bn_ch_conv1", "ch1")]
        + [(f"res_{k}", f"bn_res_{k}", f"r{k}") for k in range(1, 4)]
    )
    for conv_ref, bn_ref, ours in branch_map:
        c.put(
            c.params,
            ("bottleneck", f"{ours}_conv", "kernel"),
            convert_conv3d(c.take(f"{d3}.{conv_ref}.0.weight")),
        )
        c.bn(("bottleneck", f"{ours}_bn"), f"{d3}.{bn_ref}", wrapped=False)

    # ---- generative decoder (decoder_v3.py:77-283) ------------------------
    dec = "unet3d.decoder_generative"
    n_dec_res = 7 if heavy_decoder else 3
    for bi, scale in enumerate((4, 2, 1)):
        blk = f"{dec}.dec_blocks.{bi}"
        ours = f"dec_s{scale}"
        up_kernel = convert_me_conv_kernel(c.take(f"{blk}.upsample.net.0.kernel"), 2)
        c.put(c.params, (ours, "up_kernel"), up_kernel)
        up_bias = c.maybe(f"{blk}.upsample.net.0.bias")
        if up_bias is None:
            up_bias = np.zeros(up_kernel.shape[-1], np.float32)
            c.zero_filled.append(f"{ours}/up_bias")
        else:
            up_bias = np.asarray(up_bias).reshape(-1)  # ME stores [1, out]
        c.put(c.params, (ours, "up_bias"), up_bias)
        c.bn((ours, "up_bn"), f"{blk}.upsample.net.1")
        c.bn((ours, "resize_bn"), f"{blk}.resize.0")
        c.me_conv((ours, "resize"), f"{blk}.resize.1", 1)
        for i in range(n_dec_res):
            c.res_block((ours, f"res{i}"), f"{blk}.process.{i}")
        heads_w, heads_b = [], []
        for j in range(S):
            head = f"{blk}.completion_heads.{j}.0"
            heads_w.append(convert_me_conv_kernel(c.take(f"{head}.kernel"), 1)[0])
            # ME conv biases are stored [1, out] (MinkowskiConvolutionBase).
            heads_b.append(np.asarray(c.take(f"{head}.bias")).reshape(-1))
        c.put(c.params, (ours, "head_kernel"), np.stack(heads_w))
        c.put(c.params, (ours, "head_bias"), np.stack(heads_b))

    # ---- per-subnet voxel-feat refiners (decoder_v3.py:266-283) ----------
    for scale in (4, 2, 1):
        stacked: Dict[str, List[np.ndarray]] = {
            "conv1.kernel": [], "bn.scale": [], "bn.bias": [],
            "bn.mean": [], "bn.var": [], "conv2.kernel": [], "conv2.bias": [],
        }
        for j in range(S):
            vf = f"{dec}.voxel_feats.scale{scale}_infer{j}"
            stacked["conv1.kernel"].append(
                convert_me_conv_kernel(c.take(f"{vf}.0.kernel"), 3)
            )
            inner = f"{vf}.1.bn" if f"{vf}.1.bn.weight" in c.sd else f"{vf}.1"
            stacked["bn.scale"].append(c.take(f"{inner}.weight"))
            stacked["bn.bias"].append(c.take(f"{inner}.bias"))
            stacked["bn.mean"].append(c.take(f"{inner}.running_mean"))
            stacked["bn.var"].append(c.take(f"{inner}.running_var"))
            c.used.add(f"{inner}.num_batches_tracked")
            stacked["conv2.kernel"].append(
                convert_me_conv_kernel(c.take(f"{vf}.3.kernel"), 3)
            )
            stacked["conv2.bias"].append(
                np.asarray(c.take(f"{vf}.3.bias")).reshape(-1)
            )
        base = ("voxel_feats_s%d" % scale,)
        c.put(c.params, base + ("conv1", "kernel"), np.stack(stacked["conv1.kernel"]))
        c.put(c.params, base + ("bn", "scale"), np.stack(stacked["bn.scale"]))
        c.put(c.params, base + ("bn", "bias"), np.stack(stacked["bn.bias"]))
        c.put(c.stats, base + ("bn", "mean"), np.stack(stacked["bn.mean"]))
        c.put(c.stats, base + ("bn", "var"), np.stack(stacked["bn.var"]))
        c.put(c.params, base + ("conv2", "kernel"), np.stack(stacked["conv2.kernel"]))
        c.put(c.params, base + ("conv2", "bias"), np.stack(stacked["conv2.bias"]))

    # ---- transformer predictor (transformer_predictor_v2.py:11-110) ------
    tp = "transformer_predictor"
    t = ("transformer",)
    H = c.sd[f"{tp}.query_feat.weight"].shape[1]
    c.put(
        c.params, t + ("query_feat",),
        c.take(f"{tp}.query_feat.weight").reshape(S, -1, H),
    )
    c.put(
        c.params, t + ("query_embed",),
        c.take(f"{tp}.query_embed.weight").reshape(S, -1, H),
    )
    c.put(c.params, t + ("decoder_norm", "scale"), c.take(f"{tp}.decoder_norm.weight"))
    c.put(c.params, t + ("decoder_norm", "bias"), c.take(f"{tp}.decoder_norm.bias"))
    c.linear(t + ("class_embed",), f"{tp}.class_embed")
    c.linear(t + ("mask_feat_proj",), f"{tp}.mask_feat_proj")
    for i in range(3):
        c.linear(t + ("mask_embed", f"Dense_{i}"), f"{tp}.mask_embed.layers.{i}")
        c.linear(t + (f"input_proj_{i}",), f"{tp}.input_projs.{i}")
    for i in range(3):
        for kind, ours_name, attn in [
            ("transformer_cross_attention_layers", f"cross_{i}", "multihead_attn"),
            ("transformer_self_attention_layers", f"self_{i}", "self_attn"),
        ]:
            base = f"{tp}.{kind}.{i}"
            q, k, v = split_mha_in_proj(
                c.take(f"{base}.{attn}.in_proj_weight"),
                c.take(f"{base}.{attn}.in_proj_bias"),
            )
            for name, part in (("q_proj", q), ("k_proj", k), ("v_proj", v)):
                for leaf, val in part.items():
                    c.put(c.params, t + (ours_name, name, leaf), val)
            c.linear(t + (ours_name, "out_proj"), f"{base}.{attn}.out_proj")
            c.put(
                c.params, t + (ours_name, "norm", "scale"),
                c.take(f"{base}.norm.weight"),
            )
            c.put(
                c.params, t + (ours_name, "norm", "bias"),
                c.take(f"{base}.norm.bias"),
            )
        ffn = f"{tp}.transformer_ffn_layers.{i}"
        c.linear(t + (f"ffn_{i}", "fc1"), f"{ffn}.linear1")
        c.linear(t + (f"ffn_{i}", "fc2"), f"{ffn}.linear2")
        c.put(c.params, t + (f"ffn_{i}", "norm", "scale"), c.take(f"{ffn}.norm.weight"))
        c.put(c.params, t + (f"ffn_{i}", "norm", "bias"), c.take(f"{ffn}.norm.bias"))

    # ---- alias/bookkeeping keys -------------------------------------------
    alias_prefixes = (
        "unet3d.transformer_predictor.",
        "unet3d.decoder_generative.transformer_predictor.",
        "criterion.",                     # empty_weight / compl weight buffers
    )
    unmatched = []
    for key in c.sd:
        if key in c.used:
            continue
        if key.endswith("num_batches_tracked"):
            continue
        if any(key.startswith(p) for p in alias_prefixes):
            continue
        unmatched.append(key)
    return c.params, c.stats, sorted(unmatched)


def load_reference_ckpt(path: str) -> Dict[str, np.ndarray]:
    """Load a Lightning ``.ckpt`` into a numpy state_dict (CPU torch)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v.detach().numpy() for k, v in sd.items() if hasattr(v, "detach")}


# ---------------------------------------------------------------------------
# reference schema (for structural tests without the released files)
# ---------------------------------------------------------------------------


def reference_state_dict_spec(
    n_infers: int,
    f: int = 64,
    n_classes: int = 20,
    in_channels: int = 27 + 256,
    hidden_dim: int = 384,
    num_queries: int = 100,
    dim_feedforward: int = 1024,
    heavy_decoder: bool = False,
) -> Dict[str, Tuple[int, ...]]:
    """{state_dict key: shape} of the reference ``Net`` (SemanticKITTI).

    Derived from the reference module definitions (``unet3d_sparse_v2.py``,
    ``encoder_v2.py``, ``decoder_v3.py``, ``transformer_predictor_v2.py``,
    ``maskpls/mink.py``, ``layers.py:646-726``); used by tests to validate
    the converter covers every key a released checkpoint contains.
    """
    S, H, Q, C = n_infers, hidden_dim, num_queries, n_classes
    f_maps = [f, 2 * f, 4 * f, 4 * f]
    spec: Dict[str, Tuple[int, ...]] = {}

    def bn(prefix, ch, wrapped=True):
        base = f"{prefix}.bn" if wrapped else prefix
        spec[f"{base}.weight"] = (ch,)
        spec[f"{base}.bias"] = (ch,)
        spec[f"{base}.running_mean"] = (ch,)
        spec[f"{base}.running_var"] = (ch,)
        spec[f"{base}.num_batches_tracked"] = ()

    def linear(prefix, din, dout, bias=True):
        spec[f"{prefix}.weight"] = (dout, din)
        if bias:
            spec[f"{prefix}.bias"] = (dout,)

    def me_conv(prefix, din, dout, ks, bias=False):
        spec[f"{prefix}.kernel"] = (din, dout) if ks == 1 else (ks**3, din, dout)
        if bias:
            # ME stores conv biases [1, out] (MinkowskiConvolutionBase);
            # the converter flattens.
            spec[f"{prefix}.bias"] = (1, dout)

    def res_block(prefix, ch):
        bn(f"{prefix}.net.0", ch)
        me_conv(f"{prefix}.net.2", ch, ch, 3)
        bn(f"{prefix}.net.3", ch)
        me_conv(f"{prefix}.net.5", ch, ch, 3)

    # CylinderFeat
    bn("feat.PPmodel.0", in_channels, wrapped=False)
    linear("feat.PPmodel.1", in_channels, 64)
    bn("feat.PPmodel.2", 64, wrapped=False)
    linear("feat.PPmodel.4", 64, 128)
    bn("feat.PPmodel.5", 128, wrapped=False)
    linear("feat.PPmodel.7", 128, 256)
    bn("feat.PPmodel.8", 256, wrapped=False)
    linear("feat.PPmodel.10", 256, f)

    # encoder
    me_conv("unet3d.encoder.enc_in_feats", f * S, f_maps[0], 1)
    if not heavy_decoder:
        for i in range(3):
            res_block(f"unet3d.encoder.s1.{i}", f_maps[0])
    for stage, (cin, cout) in zip(
        ("s1s2", "s2s4", "s4s8"),
        ((f_maps[0], f_maps[1]), (f_maps[1], f_maps[2]), (f_maps[2], f_maps[3])),
    ):
        base = f"unet3d.encoder.{stage}"
        spec[f"{base}.0.net.0.kernel"] = (8, cin, cout)
        bn(f"{base}.0.net.1", cout)
        bn(f"{base}.1", cout)
        if not heavy_decoder:
            for i in range(3):
                res_block(f"{base}.{i + 3}", cout)

    # SPCDense3Dv2 bottleneck
    ch4 = f_maps[-1]
    kshape = {"a_conv1": (3, 3, 1), "a_conv2": (3, 3, 1), "a_conv3": (5, 5, 3),
              "a_conv4": (7, 7, 5), "a_conv5": (3, 3, 1), "a_conv6": (5, 5, 3),
              "a_conv7": (7, 7, 5), "ch_conv1": (1, 1, 1),
              "res_1": (3, 3, 1), "res_2": (5, 5, 3), "res_3": (7, 7, 5)}
    bn_of = {"a_conv1": "bn_1", "a_conv2": "bn_2", "a_conv3": "bn_3",
             "a_conv4": "bn_4", "a_conv5": "bn_5", "a_conv6": "bn_6",
             "a_conv7": "bn_7", "ch_conv1": "bn_ch_conv1",
             "res_1": "bn_res_1", "res_2": "bn_res_2", "res_3": "bn_res_3"}
    for conv, (kx, ky, kz) in kshape.items():
        spec[f"unet3d.dense3d.0.{conv}.0.weight"] = (ch4, ch4, kx, ky, kz)
        bn(f"unet3d.dense3d.0.{bn_of[conv]}", ch4, wrapped=False)

    # generative decoder
    dec_ch = f_maps[::-1]
    n_dec_res = 7 if heavy_decoder else 3
    for bi, scale in enumerate((4, 2, 1)):
        cin, cout = dec_ch[bi], dec_ch[bi + 1]
        blk = f"unet3d.decoder_generative.dec_blocks.{bi}"
        spec[f"{blk}.upsample.net.0.kernel"] = (8, cin, cout)
        bn(f"{blk}.upsample.net.1", cout)
        bn(f"{blk}.resize.0", cout + 3)
        me_conv(f"{blk}.resize.1", cout + 3, cout, 1, bias=True)
        for i in range(n_dec_res):
            res_block(f"{blk}.process.{i}", cout)
        for j in range(S):
            me_conv(f"{blk}.completion_heads.{j}.0", cout, C, 1, bias=True)
        for j in range(S):
            vf = f"unet3d.decoder_generative.voxel_feats.scale{scale}_infer{j}"
            me_conv(f"{vf}.0", cout, cout, 3)
            bn(f"{vf}.1", cout)
            me_conv(f"{vf}.3", cout, cout, 3, bias=True)

    # transformer predictor
    tp = "transformer_predictor"
    spec[f"{tp}.query_feat.weight"] = (Q * S, H)
    spec[f"{tp}.query_embed.weight"] = (Q * S, H)
    spec[f"{tp}.decoder_norm.weight"] = (H,)
    spec[f"{tp}.decoder_norm.bias"] = (H,)
    for i, cin in enumerate((f * 4, f * 2, f)):
        linear(f"{tp}.input_projs.{i}", cin, H)
    for i in range(3):
        for kind, attn in [
            ("transformer_self_attention_layers", "self_attn"),
            ("transformer_cross_attention_layers", "multihead_attn"),
        ]:
            base = f"{tp}.{kind}.{i}"
            spec[f"{base}.{attn}.in_proj_weight"] = (3 * H, H)
            spec[f"{base}.{attn}.in_proj_bias"] = (3 * H,)
            linear(f"{base}.{attn}.out_proj", H, H)
            spec[f"{base}.norm.weight"] = (H,)
            spec[f"{base}.norm.bias"] = (H,)
        ffn = f"{tp}.transformer_ffn_layers.{i}"
        linear(f"{ffn}.linear1", H, dim_feedforward)
        linear(f"{ffn}.linear2", dim_feedforward, H)
        spec[f"{ffn}.norm.weight"] = (H,)
        spec[f"{ffn}.norm.bias"] = (H,)
    linear(f"{tp}.class_embed", H, C + 1)
    for i, (din, dout) in enumerate(((H, H), (H, H), (H, H))):
        linear(f"{tp}.mask_embed.layers.{i}", din, dout)
    linear(f"{tp}.mask_feat_proj", f, H)
    return spec


def synthetic_reference_state_dict(
    rng: np.random.RandomState, **spec_kwargs
) -> Dict[str, np.ndarray]:
    """Random state_dict with the reference's exact keys/shapes."""
    spec = reference_state_dict_spec(**spec_kwargs)
    out = {}
    for key, shape in spec.items():
        if key.endswith("num_batches_tracked"):
            out[key] = np.asarray(0, np.int64)
        elif key.endswith("running_var"):
            out[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            out[key] = rng.standard_normal(shape).astype(np.float32) * 0.1
    return out


# ---------------------------------------------------------------------------
# into the port's net
# ---------------------------------------------------------------------------


def _flat(tree: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def reference_to_state_dict(
    state_dict: Dict[str, np.ndarray],
    n_infers: int,
    heavy_decoder: bool = False,
) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """The reference ``state_dict`` as the port's ``state_dict``
    (:func:`convert_reference_checkpoint`, then ``flax_to_torch`` on the
    ``params/...`` / ``batch_stats/...`` keys), and the unmatched keys."""
    params, stats, unmatched = convert_reference_checkpoint(
        state_dict, n_infers, heavy_decoder)
    flat = {**_flat(params, "params"), **_flat(stats, "batch_stats")}
    return flax_to_torch(flat), unmatched


def load_reference_into(
    net: torch.nn.Module, state_dict: Dict[str, np.ndarray]
) -> List[str]:
    """Load a reference ``state_dict`` into ``net`` with ``strict=True``
    (every parameter and running statistic of ``net`` filled, nothing
    left over); returns the reference keys that found no home.  The
    conversion targets the dense substrate, as the reference's does
    (``pasco_tpu/training/convert_torch.py:180``): a net of another
    substrate raises."""
    m = net.cfg.model
    if m.substrate != "dense":
        raise ValueError(
            f"load_reference_into converts to the dense substrate; this net is "
            f"substrate={m.substrate!r} (build it with substrate='dense')")
    sd, unmatched = reference_to_state_dict(
        state_dict, m.n_infers, bool(m.heavy_decoder))
    net.load_state_dict(sd, strict=True)
    return unmatched
