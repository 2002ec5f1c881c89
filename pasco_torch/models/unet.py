"""Model input/output containers, the sparse-substrate network
:class:`PaSCoNet` and the network factory (counterpart of
``pasco_tpu/models/unet.py`` and ``pasco_tpu/training/step.py:62-71``)."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from pasco_torch.core.config import PaSCoConfig
from pasco_torch.data.semantic_kitti.collate import CollatedScene
from pasco_torch.core.sparse import Box, SparseGrid
from pasco_torch.models.blocks import compute_dtype_of, flax_init_
from pasco_torch.models.bottleneck import DenseBottleneck
from pasco_torch.models.cylinder_feat import CylinderFeat, mimo_merge
from pasco_torch.models.decoder import GenerativeDecoder
from pasco_torch.models.encoder import Encoder
from pasco_torch.models.transformer import TransformerPredictor
from pasco_torch.ops.dense_ops import point_dropout
from pasco_torch.utils import timing


class ModelInput(NamedTuple):
    """One scene, voxelised on the host.  Shapes are static.  A batch of
    scenes carries a leading ``B`` on every array (:func:`stack_inputs`)."""

    point_feats: torch.Tensor      # [P, in_ch] f32
    point_coords: torch.Tensor     # [P, 4] int32 (subnet, x, y, z)
    point_mask: torch.Tensor       # [P] bool
    global_min: torch.Tensor       # [3] int32 global bbox (stride-1 units)
    global_max: torch.Tensor       # [3] int32
    subnet_min: torch.Tensor       # [S, 3] int32 per-subnet bboxes
    subnet_max: torch.Tensor       # [S, 3] int32


class ModelOutput(NamedTuple):
    """One scene's outputs; a batch's carry a leading ``B`` on every
    tensor (:func:`scan_output` takes one scan)."""

    sem_grids: Dict[int, SparseGrid]          # scale -> voxel grid
    sem_logits: Dict[int, torch.Tensor]       # scale -> [cap, S, n_classes]
    panop_grids: Dict[int, SparseGrid]        # scale -> per-subnet [S, cap, ...]
    sem_logits_pruned: torch.Tensor           # [S, cap1, n_classes]
    predictor: Optional[object]               # transformer.PredictorOutput


def stack_inputs(inps) -> ModelInput:
    """Scenes of one shape stacked into a batch (``bench.py:226-228``)."""
    return ModelInput(*(torch.stack(parts) for parts in zip(*inps)))


def scan_output(out: ModelOutput, b: int) -> ModelOutput:
    """Scan ``b`` of a batch's ``ModelOutput`` (views, no copy)."""

    def grid(g: SparseGrid) -> SparseGrid:
        return SparseGrid(g.coords[b], g.feats[b], g.mask[b], g.stride)

    pred = out.predictor
    if pred is not None:
        pred = type(pred)(pred.query_logits[b], pred.voxel_logits[b],
                          [(c[b], m[b]) for c, m in pred.aux])
    return ModelOutput(
        sem_grids={k: grid(g) for k, g in out.sem_grids.items()},
        sem_logits={k: v[b] for k, v in out.sem_logits.items()},
        panop_grids={k: grid(g) for k, g in out.panop_grids.items()},
        sem_logits_pruned=out.sem_logits_pruned[b],
        predictor=pred,
    )


def scene_to_model_input(scene: CollatedScene, device) -> ModelInput:
    """A host ``CollatedScene`` as tensors on ``device``."""

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype).to(device)

    return ModelInput(
        point_feats=t(scene.point_feats, torch.float32),
        point_coords=t(scene.point_coords, torch.int32),
        point_mask=t(scene.point_mask, torch.bool),
        global_min=t(scene.global_min, torch.int32),
        global_max=t(scene.global_max, torch.int32),
        subnet_min=t(scene.subnet_min, torch.int32),
        subnet_max=t(scene.subnet_max, torch.int32),
    )


class PaSCoNet(nn.Module):
    """The sparse-substrate network (``cfg.model.substrate == "sparse"``,
    ``pasco_tpu/models/unet.py:54-152``): point featurizer -> MIMO merge ->
    sparse encoder -> dense bottleneck -> generative decoder -> mask
    transformer, on the padded grids of :mod:`pasco_torch.core.sparse`.
    It takes the calls of :class:`~pasco_torch.models.dense_unet.
    DensePaSCoNet` (the trainer's, the evaluator's, ``AdaptiveForward``'s)
    and returns the same ``ModelOutput``, with the decoder's kept voxels in
    score order instead of the dense substrate's flat-index order.

    One scan per call: a batch of scans raises.  ``net.train()`` selects
    the training forward (batch statistics, Gumbel-noised caps, dropouts
    live); ``mc_dropout=True`` makes the dropouts live at inference.  Every
    draw comes from ``generator``.  The forward keeps every count on the
    device, so it makes the host wait for the card nowhere.  Its stage
    spans (:mod:`pasco_torch.utils.timing`) have the dense substrate's
    names: ``featurize``, ``encoder``, ``bottleneck``, ``decoder.s4/s2/s1``,
    ``refiner.s4/s2/s1`` (in :class:`~pasco_torch.models.decoder.
    GenerativeDecoder`) and ``transformer``."""

    def __init__(self, cfg: PaSCoConfig):
        super().__init__()
        m, cap = cfg.model, cfg.capacity
        self.cfg = cfg
        self.cd = compute_dtype_of(m)
        self.cylinder_feat = CylinderFeat(m.in_channels, m.f, cap.enc_s1)
        self.encoder = Encoder(m, cap)
        self.dense_bottleneck = DenseBottleneck(m.f_maps[3], cap.bottleneck, m.dense3d_dropout,
                                                self.cd)
        self.decoder = GenerativeDecoder(m, cap)
        self.transformer = TransformerPredictor(m.transformer, m.n_classes, m.n_infers,
                                                (m.f * 4, m.f * 2, m.f))
        self.eval()

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
        """One scene.  ``labelweights`` (scale -> [n_classes]) weight the
        decoder caps' scores; ``generator`` (on the input's device) draws
        the point dropout, the dropouts and, in training mode, the caps'
        Gumbel noise; ``is_predict_panop=False`` skips the refiners and the
        transformer (``panop_grids`` empty, ``predictor`` None);
        ``box_extent`` is this call's working box (``cfg.scene.box_extent``
        by default)."""
        if inp.point_feats.dim() != 2:
            raise ValueError("the sparse substrate runs one scan per call, not a batch")
        cfg = self.cfg
        m, cap = cfg.model, cfg.capacity
        S = m.n_infers
        drop_on = self.training or mc_dropout
        box = Box.create(inp.global_min, box_extent or cfg.scene.box_extent)

        with timing.span("featurize"):
            pm = inp.point_mask
            if drop_on and m.encoder_dropouts[0] > 0.0:
                pm = point_dropout(pm, m.encoder_dropouts[0], generator)
            per_subnet = self.cylinder_feat(inp.point_feats, inp.point_coords, pm, box, S)
            merged = mimo_merge(per_subnet, box, S, cap.enc_s1)
            merged = merged.with_feats(merged.feats.to(self.cd))

        with timing.span("encoder"):
            enc = self.encoder(merged, box, generator, drop_on)
        with timing.span("bottleneck"):
            bott = self.dense_bottleneck(enc[3], box, generator, drop_on)
        dec = self.decoder(bott, enc[:3], box, inp.global_min, inp.global_max, inp.subnet_min,
                           inp.subnet_max, labelweights, generator, is_predict_panop, drop_on)

        predictor = None
        if is_predict_panop:
            with timing.span("transformer"):
                one = {k: SparseGrid(g.coords[None], g.feats[None], g.mask[None], g.stride)
                       for k, g in dec.panop_grids.items()}
                p = self.transformer(one, Box(box.minimum[None], box.extent), generator,
                                     drop_on)
                predictor = type(p)(p.query_logits[0], p.voxel_logits[0],
                                    [(c[0], v[0]) for c, v in p.aux])
        return ModelOutput(sem_grids=dec.xs, sem_logits=dec.sem_logits,
                           panop_grids=dec.panop_grids,
                           sem_logits_pruned=dec.sem_logits_pruned, predictor=predictor)


def build_net(cfg: PaSCoConfig, device="cuda", process_group=None):
    """The network of ``cfg.model.substrate``: ``"dense"`` the
    dense-with-masks ``DensePaSCoNet`` on the hand-written kernels, any
    other the sparse :class:`PaSCoNet` (as the reference's ``build_net``
    picks), on ``device``: the card unless the caller asks for the CPU
    (``device="cpu"``); without a card the default raises.  With a
    ``torch.distributed`` ``process_group`` its training-mode BatchNorms
    reduce their statistics over the group's ranks (SyncBN, the
    reference's ``build_net(cfg, axis_name=)``); off by default."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_net: no CUDA device; pass device='cpu' for the CPU")
    from pasco_torch.models.norm import set_process_group

    if cfg.model.substrate == "dense":
        from pasco_torch.models.dense_unet import DensePaSCoNet

        net = DensePaSCoNet(cfg)
    else:
        net = PaSCoNet(cfg)
    net = net.to(device)
    set_process_group(net, process_group)
    return net
