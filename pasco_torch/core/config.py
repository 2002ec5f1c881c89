"""Typed configuration tree for the TPU-native PaSCo framework.

The reference has no config system — hyperparameters are `click` CLI flags
(`scripts/train.py:20-67`) plus constants hard-coded in constructors
(`pasco/models/net_panoptic_sparse.py:41-208`, `decoder_v3.py:210-235`).
Here everything lives in one frozen dataclass tree so that (a) a model
configuration is a hashable static argument to ``jax.jit``, (b) checkpoint
metadata can serialise the full config next to the weights, and (c) the
static *capacities* (padded voxel-set sizes) that make dynamic sparsity
XLA-compatible are explicit and auditable.

Capacity design: every sparse tensor in the network is a padded
:class:`~pasco_tpu.core.sparse.SparseGrid` whose row count is fixed by this
config.  The reference already imposes hard voxel caps during decoding
(``occ_thres``, ``decoder_v3.py:210-235``), so the capacities below are the
same quantities made explicit, rounded up to multiples of 128 lanes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


def _r128(x: int) -> int:
    """Round up to a multiple of 128 (TPU lane width)."""
    return -(-int(x) // 128) * 128


@dataclass(frozen=True)
class CapacityConfig:
    """Static padded sizes of every sparse stage of the network.

    Defaults are sized for SemanticKITTI scenes (256x256x32 voxels @0.2 m)
    with the reference voxel caps (``decoder_v3.py:210-235``, n_infers<=2:
    {4: 25k, 2: 120k, 1: 400k}).
    """

    num_points: int = 163840          # raw LiDAR points fed to CylinderFeat
    enc_s1: int = 131072              # stride-1 input voxels (union of subnets)
    enc_s2: int = 65536
    enc_s4: int = 32768
    enc_s8: int = 16384
    # Dense-bottleneck output: every stride-8 cell of the static working box
    # can be occupied after ME.to_sparse (44*44*5 for the default box).
    bottleneck: int = 9728
    # Upsampled stride-4 set before the occupancy cap: the generative deconv
    # of the (dense) bottleneck emits all children inside the global bbox.
    ups_s4: int = _r128(52000)
    # Decoder voxel caps per output scale == reference ``agg_occ_thres``
    # (decoder_v3.py:231-235) rounded to lanes.
    dec_s4: int = _r128(30000)
    dec_s2: int = _r128(100000)
    dec_s1: int = _r128(400000)
    # Per-subnet pruned voxel sets fed to the mask transformer
    # (decoder_v3.py:396-451); each subnet keeps at most this many voxels
    # per scale.
    panop_s4: int = _r128(20000)
    panop_s2: int = _r128(65000)
    panop_s1: int = _r128(150000)

    def scaled(self, factor: float) -> "CapacityConfig":
        """Uniformly scale all capacities (tiny configs for tests)."""
        return CapacityConfig(
            **{
                f.name: max(128, _r128(getattr(self, f.name) * factor))
                for f in dataclasses.fields(self)
            }
        )

    def dec_capacity(self, scale: int) -> int:
        return {4: self.dec_s4, 2: self.dec_s2, 1: self.dec_s1}[scale]

    def panop_capacity(self, scale: int) -> int:
        return {4: self.panop_s4, 2: self.panop_s2, 1: self.panop_s1}[scale]

    def enc_capacity(self, stride: int) -> int:
        return {1: self.enc_s1, 2: self.enc_s2, 4: self.enc_s4, 8: self.enc_s8}[
            stride
        ]


@dataclass(frozen=True)
class TransformerConfig:
    """Mask transformer (Mask2Former-style) hyperparameters.

    Reference: ``TransformerPredictorV2`` built in
    ``net_panoptic_sparse.py:108-121`` (hidden 384, 8 heads, FFN 1024,
    100 queries, src scales [4, 2, 1]).
    """

    hidden_dim: int = 384
    num_heads: int = 8
    dim_feedforward: int = 1024
    num_queries: int = 100
    src_scales: Tuple[int, ...] = (4, 2, 1)
    mask_dim: int = 64                # channels of the scale-1 mask features
    # Residual dropout in the attention/FFN blocks.  The reference CLI
    # default is ``--transformer_dropout 0.2`` (``scripts/train.py:36``) but
    # the released code then constructs every layer with a hard-coded
    # ``dropout=0.0`` (``transformer_predictor_v2.py:72-82``) — the flag is
    # dead.  Default 0.0 matches that *effective* behaviour (and the
    # released checkpoints); ``scripts_tpu/train.py`` passes the CLI value
    # through honestly, so ``--transformer_dropout 0.2`` actually trains
    # with dropout here.
    dropout: float = 0.0
    kv_chunk: int = 32768             # KV chunk for online-softmax attention


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the MIMO sparse generative U-Net.

    Reference: ``UNet3DV2`` (``unet3d_sparse_v2.py:89-256``) with
    ``f_maps=[f, 2f, 4f, 4f]``, f=64 (``net_panoptic_sparse.py:124-135``).
    """

    n_classes: int = 20               # incl. empty class 0
    in_channels: int = 27 + 256       # per-point features (SemKITTI WaffleIron)
    f: int = 64
    n_infers: int = 1                 # MIMO subnets sharing the backbone
    heavy_decoder: bool = False       # released config (train.py:58)
    num_queries: int = 100
    query_sample_ratio: float = 1.0
    # Dropout schedule (reference ``scripts/train.py:83-87``):
    # ``encoder_dropouts[0]`` is the point-dropout ratio (each scan drops a
    # random 0..p fraction of its input points at train time); the last
    # three encoder entries and the decoder entries are spatial
    # (whole-channel) dropout rates per stage, all 0.0 in the released
    # recipe (``net_3d_dropout=0``).  Both substrates consume them.
    encoder_dropouts: Tuple[float, ...] = (0.05, 0.0, 0.0, 0.0, 0.0, 0.0)
    decoder_dropouts: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0, 0.0)
    dense3d_dropout: float = 0.0
    drop_path_rate: float = 0.0
    use_se_layer: bool = False
    # Residual blocks per encoder/decoder stage.  None = the reference rule
    # (encoder: 0 if heavy_decoder else 3, ``encoder_v2.py:116-172``;
    # decoder: 7 if heavy_decoder else 3, ``decoder_v3.py:125``).  An
    # explicit value overrides both — used by the multi-chip dry-run
    # config to shrink compile/step cost on the virtual CPU mesh while
    # keeping every layer type and the real sharding.
    res_blocks: Optional[int] = None
    # Hot-path precision: features and conv taps in bfloat16 (halves the
    # gather-dominated HBM traffic, doubles MXU rate); accumulation,
    # normalisation statistics, logits, and losses stay float32.
    compute_dtype: str = "bfloat16"
    # Rematerialise conv stacks in backward (full-scale training needs
    # ~47 GB of stored activations otherwise; one v5e chip has 15.75 GB).
    remat: bool = True
    # Compute formulation: "dense" runs the U-Net on masked dense volumes
    # over the working box (near-roofline on TPU; see models/dense_unet.py),
    # "sparse" uses the gather-based sparse substrate (reference-shaped).
    substrate: str = "dense"
    # Fold z-pairs into channels at strides 1 and 2 of the dense substrate
    # ([X, Z, Y, C] -> [X, Z/2, Y, 2C]): fills the 128-lane tile (C=64
    # volumes otherwise pad 2x in HBM) and runs the conv as two batched 2D
    # convs — measured ~1.8x faster per stride-1 conv in context.
    # Requires the working-box z extent divisible by 4.
    z_pack: bool = True
    # Packed-conv execution: "auto" uses the block-sparse Pallas kernel
    # (ops/pallas_conv.py) on TPU backends — at inference through the
    # fused residual chain, in training through the custom-VJP wrapper
    # (backward data pass = the same kernel with flipped taps); "off"
    # always uses the XLA formulation; "force" engages the kernels on any
    # backend (the CPU equivalence test runs them in interpret mode).
    pallas_conv: str = "auto"
    transformer: TransformerConfig = field(default_factory=TransformerConfig)

    @property
    def f_maps(self) -> Tuple[int, int, int, int]:
        return (self.f, self.f * 2, self.f * 4, self.f * 4)


@dataclass(frozen=True)
class SceneConfig:
    """Voxel-scene geometry.

    SemanticKITTI SSC: 256x256x32 voxels of 0.2 m covering
    [0, 51.2] x [-25.6, 25.6] x [-2, 4.4] m
    (``kitti_dataset.py:86-89``).  ``box_extent`` is the static extent of
    the axis-aligned working box that contains every augmented subnet scene
    (augmentation rotates/translates the canonical grid, so the union bbox
    can exceed the canonical scene; collate rounds it to ``complete_scale``).
    """

    scene_size: Tuple[int, int, int] = (256, 256, 32)
    voxel_size: float = 0.2
    point_cloud_range: Tuple[float, ...] = (0.0, -25.6, -2.0, 51.2, 25.6, 4.4)
    # Static working box. (352, 352, 32) covers the union bbox of the
    # canonical scene under the eval augmentations (rotation up to +-30deg,
    # small translation: measured p100 extent 350x350x32 over 2000 draws;
    # augmentation never moves z, so z stays at the canonical 32);
    # dense-mode FLOPs scale linearly with this volume.
    box_extent: Tuple[int, int, int] = (352, 352, 32)
    # Scene-adaptive working boxes: at inference each scan dispatches to
    # the SMALLEST candidate program covering its actual bbox (an
    # unaugmented scan spans the canonical 256^2; a 30deg-rotated one up to
    # 350^2 — extent ~ 256(|cos a|+|sin a|)).  This mirrors the reference,
    # whose sparse tensors only ever span the scan's true bbox
    # (MinkowskiEngine coordinate maps are dynamic), instead of paying the
    # p100 union for every scan.  Parameters are box-independent, so all
    # candidates share one variable tree; each candidate is one cached XLA
    # program.  None/empty = always use ``box_extent``.
    box_candidates: Tuple[Tuple[int, int, int], ...] = (
        (256, 256, 32),
        (288, 288, 32),
        (320, 320, 32),
        (352, 352, 32),
    )
    # Training-time working box: the reference trains on random 0.8-crops
    # (``kitti_dataset.py:463-490``), so the train step needs a smaller box
    # than full-scene inference — (256, 256, 32) is what fits one 16GB chip
    # with remat + donated state (memory ladder in PERF.md).  None = use
    # ``box_extent`` for training too (tiny/test configs).
    train_box_extent: Optional[Tuple[int, int, int]] = (256, 256, 32)
    complete_scale: int = 8


@dataclass(frozen=True)
class LossConfig:
    """Loss weights (reference ``net_panoptic_sparse.py:141-166`` with
    CLI defaults ``scripts/train.py:53``: mask_weight=40)."""

    ce_weight: float = 2.0
    mask_weight: float = 40.0
    dice_weight: float = 1.0
    ssc_ce_weight: float = 0.3
    ssc_lovasz_weight: float = 1.0
    occ_weight: float = 1.0
    no_object_weight: float = 0.1
    cost_class: float = 1.0
    use_voxel_query_loss: bool = True
    alpha: float = 0.1                # focal loss alpha
    # Apply the criterion to the transformer's aux (intermediate-round)
    # predictions as well as the final ones (reference
    # ``criterion_sparse.py:387-405``).  The dry-run config turns this off
    # to cut the train-step graph on the virtual CPU mesh.
    include_aux: bool = True


@dataclass(frozen=True)
class OptimConfig:
    """AdamW + warmup-cosine schedule (reference
    ``net_panoptic_sparse.py:887-903``, ``pasco/utils/torch_util.py:75-96``,
    grad clip 0.5 ``scripts/train.py:209,228``)."""

    lr: float = 1e-4
    weight_decay: float = 1e-4
    grad_clip: float = 0.5
    warmup_steps: int = 1000
    max_steps: int = 60 * 2000
    betas: Tuple[float, float] = (0.9, 0.999)


@dataclass(frozen=True)
class InferenceConfig:
    """Panoptic assembly + ensembling thresholds
    (``net_panoptic_sparse.py:55-56,82-83``, ``helper.py:91-303``)."""

    object_mask_threshold: float = 0.7
    overlap_threshold: float = 0.4
    vox_occ_threshold: float = 0.3
    iou_threshold: float = 0.2        # ensembler mean-IoU keep threshold
    ensemble_confidence_type: str = "max_prob"
    max_segments: int = 128           # static cap on panoptic segments


@dataclass(frozen=True)
class PaSCoConfig:
    """Root config."""

    model: ModelConfig = field(default_factory=ModelConfig)
    scene: SceneConfig = field(default_factory=SceneConfig)
    capacity: CapacityConfig = field(default_factory=CapacityConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    thing_ids: Tuple[int, ...] = (1, 2, 3, 4, 5, 6, 7, 8)  # SemKITTI things

    def replace(self, **kw) -> "PaSCoConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def kitti360_config(n_infers: int = 1) -> PaSCoConfig:
    """SSCBench-KITTI360 variant: 19 classes, 8 raw in-channels, things 1..6
    (reference ``net_panoptic_sparse_kitti360.py:27-90``,
    ``data/kitti360/params.py:35-59``)."""
    base = PaSCoConfig()
    return base.replace(
        model=dataclasses.replace(
            base.model, n_classes=19, in_channels=8, n_infers=n_infers
        ),
        thing_ids=(1, 2, 3, 4, 5, 6),
    )


def flagship_narrow_config(n_infers: int = 2) -> PaSCoConfig:
    """The flagship MODEL section (full f=64 channel widths, the real
    384-dim transformer, 100 queries, WaffleIron in_channels) over a
    narrow working box with reduced capacities.

    Multi-chip dry-runs use this so the sharded train step exercises the
    real per-layer shapes (BN psum folding, vmapped subnet axes, head
    widths) on a virtual CPU mesh without flagship-box memory/compile
    cost.
    """
    base = PaSCoConfig()
    return base.replace(
        model=dataclasses.replace(
            base.model,
            n_infers=n_infers,
            encoder_dropouts=(0.0,) * 6,
        ),
        scene=SceneConfig(
            scene_size=(32, 32, 8),
            box_extent=(64, 64, 16),
            box_candidates=((48, 48, 16), (64, 64, 16)),
            train_box_extent=None,
        ),
        capacity=CapacityConfig(
            num_points=4096,
            enc_s1=4096, enc_s2=2048, enc_s4=1024, enc_s8=512,
            bottleneck=256, ups_s4=2048,
            dec_s4=1024, dec_s2=2048, dec_s1=8192,
            panop_s4=512, panop_s2=1024, panop_s1=2048,
        ),
    )


def dryrun_config(n_infers: int = 2) -> PaSCoConfig:
    """Multi-chip dry-run preset: the transformer keeps its real width
    (384-dim, 100 queries) and every per-layer sharding rule is the real
    one, but conv widths are HALVED to f=32 so a cold compile + one
    8-device step fits a test's time budget on a single-core CPU host
    (round-2 regression: the flagship-narrow f=64 dry-run cold-compiled
    >9.5 min and the 8-device step alone executed ~5 min serialised).

    Cuts vs ``flagship_narrow_config`` (all sharding-preserving): f=32
    conv widths, one residual block per stage instead of 3, no aux-level
    criterion, a 32x32x8 working box (execution of the 8-device step is
    serialised on the single host core, so step FLOPs — box volume x
    channel widths — set the wall-clock), and capacities to match.  Every
    layer type, both BN psum folds, the vmapped subnet axis, and the full
    matched criterion still run; the transformer alone runs at real
    channel/query widths.  Flagship-width (f=64) multi-device correctness
    is covered separately by the slow-tier test
    ``tests/test_multichip.py::test_flagship_width_two_device_step``.
    """
    base = flagship_narrow_config(n_infers=n_infers)
    return base.replace(
        # float32 compute: the dry run executes on a virtual CPU mesh, and
        # XLA:CPU emulates bfloat16 with per-op f32 converts — measured as
        # the difference between a >330 s and a ~1 min 8-device step on the
        # 1-core test host.  Sharding semantics are dtype-independent.
        # f=32 halves every conv width (4x FLOPs) — with f=64 the 8-device
        # step alone executed ~5 min serialised on the single host core.
        # The transformer keeps its real 384-dim/100-query shape and the
        # MIMO subnet axis stays vmapped, so every sharding rule and layer
        # type is exercised unchanged.
        # remat=False: rematerialisation exists to fit flagship-box
        # activations in HBM; at the 32x32x8 dry-run box it only doubles
        # the backward's compute and the compiled HLO (round-4 regression:
        # compile 138.8 -> 202.6 s, exec past the test budget).
        model=dataclasses.replace(
            base.model, f=32, res_blocks=1, compute_dtype="float32",
            remat=False,
        ),
        loss=dataclasses.replace(base.loss, include_aux=False),
        scene=SceneConfig(
            scene_size=(16, 16, 8),
            box_extent=(32, 32, 8),
            box_candidates=((32, 32, 8),),
            train_box_extent=None,
        ),
        capacity=CapacityConfig(
            num_points=1024,
            enc_s1=1024, enc_s2=512, enc_s4=256, enc_s8=128,
            bottleneck=128, ups_s4=512,
            dec_s4=256, dec_s2=512, dec_s1=2048,
            panop_s4=128, panop_s2=256, panop_s1=512,
        ),
    )


def tiny_config(n_infers: int = 1, n_classes: int = 20) -> PaSCoConfig:
    """Small config for unit tests / CPU mesh dry-runs."""
    base = PaSCoConfig()
    return base.replace(
        model=dataclasses.replace(
            base.model,
            f=16,
            n_infers=n_infers,
            n_classes=n_classes,
            in_channels=8,
            # No stochastic input for tests: the flagship default applies
            # 0..5% point dropout per train step (the recipe);
            # tests/test_dropout.py covers the dropout machinery explicitly.
            encoder_dropouts=(0.0,) * 6,
            transformer=TransformerConfig(
                hidden_dim=48, num_heads=4, dim_feedforward=64, num_queries=10,
                mask_dim=16, kv_chunk=256,
            ),
            num_queries=10,
        ),
        scene=SceneConfig(
            scene_size=(32, 32, 8),
            box_extent=(64, 64, 16),
            box_candidates=((48, 48, 16), (64, 64, 16)),
            train_box_extent=None,
        ),
        capacity=CapacityConfig(
            num_points=2048,
            enc_s1=2048, enc_s2=1024, enc_s4=512, enc_s8=256,
            bottleneck=128, ups_s4=1024,
            dec_s4=512, dec_s2=1024, dec_s1=4096,
            panop_s4=256, panop_s2=512, panop_s1=1024,
        ),
    )
