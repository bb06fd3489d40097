"""Top-level model: backbone -> ViT blend -> FPN -> YOLO head, the
segmentation and depth heads, and the classifier on the global features.

Counterpart of ``hvs_tpu/models/hybrid.py`` (``SegmentationHead``,
``DepthHead``, ``HybridVisionSystem`` for every task, with the ``use_vit``,
``use_segmentation``, ``use_depth`` and ``use_rag`` flags,
``LightweightHybridVision``, ``ProductionHybridVision``, ``detect``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..data.device_pipeline import resize_weights
from ..device import DeviceLike, device_constant, resolve_device
from ..ops.sinkhorn import sinkhorn_log_many
from .backbone import HybridVisionBackbone
from .fpn import OUT_CHANNELS, OUT_NAMES, FeaturePyramidNetwork
from .layers import Conv, ConvTranspose, Dense, ManifoldHyperConnection, group_norm, \
    init_weights, silu_norm
from .rag import RAGVisionKnowledge
from .vit import HybridVisionEncoder
from .yolo_head import YOLODetectionHead, postprocess_detections

TASKS = ("detection", "classification", "segmentation", "depth", "multi_task")


class _UpsamplingHead(nn.Module):
    """Two ConvTranspose(4x4, stride 2) -> GroupNorm -> SiLU stages at 128 and
    64 channels, then a 1x1 conv to ``out_channels``: a map at stride s comes
    out at stride s/4. Submodules keep the flax auto-names."""

    STAGES = (128, 64)

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        c = in_channels
        for i, ch in enumerate(self.STAGES):
            self.add_module(f"ConvTranspose_{i}", ConvTranspose(c, ch, dtype=dtype))
            self.add_module(f"GroupNorm_{i}", group_norm(ch, dtype))
            c = ch
        self.Conv_0 = Conv(c, out_channels, dtype=dtype)

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.STAGES)):
            x = getattr(self, f"ConvTranspose_{i}")(x)
            x = silu_norm(getattr(self, f"GroupNorm_{i}"), x)
        return self.Conv_0(x)


def bilinear_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, h, w, C), "bilinear")`` of an NHWC map, as
    JAX computes it: a product with a [h, H] and a [w, W] weight matrix
    (half-pixel centres, antialiased when shrinking), in ``x``'s dtype.
    Products, unlike ``F.interpolate``'s scattered backward, differentiate
    without atomics, so a captured step and its eager run agree."""
    mats = []
    for n_in, n_out in ((x.shape[1], h), (x.shape[2], w)):
        mats.append(device_constant(
            ("bilinear_resize", n_in, n_out), x.device,
            lambda: resize_weights(n_in, n_out, torch.tensor([n_out / n_in]),
                                   torch.zeros(1))[0].tolist()).to(x.dtype))
    y = torch.einsum("yi,bixc->byxc", mats[0], x)
    return torch.einsum("xj,byjc->byxc", mats[1], y)


class SegmentationHead(_UpsamplingHead):
    """Per-pixel class logits (``num_classes``, channel 0 the background) at
    a quarter of the small scale's stride.

    Multi-scale form (``in_channels`` = the small, medium and large fused
    maps' channels; called with the fused-features dict): the medium and
    large maps go through 1x1 convs to ``context_channels``, are resized
    bilinearly to the small grid (``bilinear_resize``) and concatenated
    after the small map. Single-map form (``in_channels`` an int; called
    with one map): the map alone."""

    def __init__(self, in_channels: Union[int, Sequence[int]], num_classes: int = 21,
                 context_channels: int = 128, dtype: torch.dtype = torch.bfloat16):
        multi_scale = not isinstance(in_channels, int)
        width = in_channels[0] + 2 * context_channels if multi_scale else in_channels
        super().__init__(width, num_classes, dtype)
        if multi_scale:
            for name, c in zip(OUT_NAMES[1:], in_channels[1:]):
                self.add_module(f"ctx_{name}", Conv(c, context_channels, dtype=dtype))

    def forward(self, feat: Union[torch.Tensor, Dict[str, torch.Tensor]]) -> torch.Tensor:
        if not isinstance(feat, dict):
            return self.decode(feat.to(self.dtype))
        small = feat["fused_small"].to(self.dtype)
        parts = [small]
        for name in OUT_NAMES[1:]:
            ctx = getattr(self, f"ctx_{name}")(feat[name])
            parts.append(bilinear_resize(ctx, small.shape[1], small.shape[2]))
        return self.decode(torch.cat(parts, dim=-1))


class DepthHead(_UpsamplingHead):
    """Monocular depth (softplus, so positive) at a quarter of the input
    map's stride, [B, 4H, 4W, 1]."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_channels, 1, dtype)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return F.softplus(self.decode(feat.to(self.dtype)))


class HybridVisionSystem(nn.Module):
    """The flagship CNN+ViT model on NHWC images in [0, 1].

    Defaults are the flagship's widths and the JAX model's training flags:
    the mHC constraints are computed in every forward (Sinkhorn with
    ``sk_iters`` iterations), ``dropout_rate`` reaches the ViT and the
    feature mHC (the head towers keep the layer default 0.1, backbone and FPN
    0, as in JAX), and ``monitor`` turns on the per-layer telemetry, returned
    under ``"stability"`` ({mHC module path: metrics} of the layers that ran)
    as the JAX ``stability`` collection. Torch's ``train()``/``eval()`` take
    the part of JAX's ``deterministic`` flag. The model is built with a
    seeded, flax-like random init (``seed``) on ``device``: the CUDA card
    unless ``device="cpu"`` is passed. Real weights come from a flax tree
    through ``hvs_tpu_torch.convert.load_flax_params``.

    int8 serving (W8A8, ``ops/quant.py``), as the JAX model's flags:
    ``act_quant`` the backbone's convolutions (``stem2`` and the blocks')
    and the head towers' ``reduce`` and ``conv``; ``act_quant_fpn`` the FPN's
    laterals, refines and projections; ``act_quant_mhc`` the backbone
    blocks' mHC chains; ``act_quant_vit`` the ViT's projections and mHC
    chains. Their scales come from ``models/quantize.py``
    (``calibrate_quant_scales``, ``load_quant_scales``); calibration
    records every site whatever the flags. Parameters are those of the
    float model, so float checkpoints load unchanged.

    ``use_vit=False`` builds and runs no ViT encoder. ``use_rag`` injects
    retrieved knowledge into the small fused scale after the FPN
    (``RAGVisionKnowledge``, named ``rag``, its knowledge base seeded with
    ``rag_classes``, COCO's by default) behind a zero-init gate: the blend
    is ``small + tanh(rag_gate) * tokens``, in fp32 as JAX computes it with
    its fp32 gate, so at init it changes nothing. Each head casts the
    blended map to its own dtype. ``use_segmentation``
    and ``use_depth`` add the dense heads on the fused features. A flax
    model holds the parameters of the heads its ``init`` task ran, so
    ``task`` (one of ``TASKS``) says which heads are built: the detection
    head for ``"detection"``, the segmentation head (if ``use_segmentation``)
    for ``"segmentation"``, the depth head (if ``use_depth``) for
    ``"depth"``, the classifier for ``"classification"``, and all of them
    for ``"multi_task"``. ``forward(images, task)`` runs the heads of its
    task as the JAX ``__call__`` does and raises if one of them was not
    built; the global features are always computed.

    When the mHC layers compute their constraints (training and validation),
    the forward first projects every layer's ``H_res_raw`` in one grouped
    Sinkhorn call (one kernel launch per matrix width on the card) and hands
    each layer its projection for this forward. JAX projects inside each
    layer; the arithmetic is the same.
    """

    def __init__(self, num_classes: int = 80, sk_iters: int = 20, base_channels: int = 32,
                 stage_blocks: Sequence[int] = (2, 3, 4, 2),
                 stage_channels: Sequence[int] = (64, 128, 256, 512), vit_dim: int = 256,
                 vit_depth: int = 6, vit_heads: int = 8, fpn_channels: int = 256,
                 head_channels: int = 256, feature_dim: int = 256, dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16, monitor: bool = False,
                 precomputed_constraints: bool = False, device: DeviceLike = None,
                 seed: int = 0, use_vit: bool = True, use_segmentation: bool = False,
                 use_depth: bool = False, task: str = "detection", act_quant: bool = False,
                 act_quant_fpn: bool = False, act_quant_mhc: bool = False,
                 act_quant_vit: bool = False, use_rag: bool = False,
                 rag_classes: Optional[Sequence[str]] = None):
        super().__init__()
        if task not in TASKS:
            raise ValueError(f"task must be one of {TASKS}, got {task!r}")
        device = resolve_device(device)
        self.dtype = dtype
        self.sk_iters = sk_iters
        self.task = task
        self.use_segmentation, self.use_depth = use_segmentation, use_depth
        mhc = dict(sk_iters=sk_iters, monitor=monitor,
                   precomputed_constraints=precomputed_constraints)
        self.backbone = HybridVisionBackbone(base_channels, stage_blocks, stage_channels,
                                             dtype=dtype, act_quant=act_quant,
                                             act_quant_mhc=act_quant_mhc, **mhc)
        self.vit_encoder = (HybridVisionEncoder(stage_channels[-1], vit_dim, vit_depth,
                                                vit_heads, dtype=dtype,
                                                dropout_rate=dropout_rate,
                                                act_quant=act_quant_vit, **mhc)
                            if use_vit else None)
        self.fpn = FeaturePyramidNetwork(tuple(stage_channels[1:]), fpn_channels, dtype=dtype,
                                         act_quant=act_quant_fpn, **mhc)
        # The knowledge module has no int8 sites and no telemetry, as in JAX.
        self.rag = (RAGVisionKnowledge(OUT_CHANNELS[0], sk_iters=sk_iters, dtype=dtype,
                                       precomputed_constraints=precomputed_constraints,
                                       kb_classes=rag_classes)
                    if use_rag else None)
        self.rag_gate = nn.Parameter(torch.zeros(())) if use_rag else None
        self.detection_head = (YOLODetectionHead(OUT_CHANNELS, num_classes, head_channels,
                                                 dtype=dtype, act_quant=act_quant, **mhc)
                               if task in ("detection", "multi_task") else None)
        self.feature_proj = Dense(sum(OUT_CHANNELS), feature_dim, dtype=dtype)
        self.mhc_features = ManifoldHyperConnection(feature_dim, 1, 2, dtype=dtype,
                                                    dropout_rate=dropout_rate, **mhc)
        # +1: channel 0 is the background (dense masks are class id + 1).
        self.segmentation_head = (SegmentationHead(OUT_CHANNELS, num_classes + 1, dtype=dtype)
                                  if use_segmentation and task in ("segmentation", "multi_task")
                                  else None)
        self.depth_head = (DepthHead(OUT_CHANNELS[0], dtype=dtype)
                           if use_depth and task in ("depth", "multi_task") else None)
        self.classifier = (Dense(feature_dim, num_classes, dtype=dtype)
                           if task in ("classification", "multi_task") else None)
        self._monitored = [(name, m) for name, m in self.named_modules()
                           if isinstance(m, ManifoldHyperConnection) and m.monitor]
        # Layers that project H_res in their forward, grouped by (iterations, tau).
        self._projecting: Dict[Tuple[int, float], List[ManifoldHyperConnection]] = {}
        for m in self.modules():
            if isinstance(m, ManifoldHyperConnection) and not m.precomputed_constraints:
                self._projecting.setdefault((m.sk_iters, m.tau), []).append(m)
        init_weights(self, seed)
        self.to(device)

    def forward(self, images: torch.Tensor, task: str = "detection") -> Dict[str, Any]:
        if task not in TASKS:
            raise ValueError(f"task must be one of {TASKS}, got {task!r}")
        for (iters, tau), layers in self._projecting.items():
            projected = sinkhorn_log_many([m.H_res_raw for m in layers], iters, tau)
            for m, h_res in zip(layers, projected):
                m.h_res_given = h_res
        try:
            return self._forward(images, task)
        finally:
            for layers in self._projecting.values():
                for m in layers:
                    m.h_res_given = None

    def _head(self, name: str) -> nn.Module:
        head = getattr(self, name)
        if head is None:
            raise ValueError(f"this model has no {name}: it was built with task={self.task!r}, "
                             f"which does not create it (build it with the task that runs it, "
                             f"or 'multi_task')")
        return head

    def global_features(self, fused: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global features of the fused maps: their spatial means (fp32),
        concatenated, projected (``feature_proj``) and through ``mhc_features``."""
        pooled = torch.cat([fused[k].float().mean(dim=(1, 2)) for k in OUT_NAMES], dim=-1)
        return self.mhc_features(self.feature_proj(pooled.to(self.dtype)))

    def _forward(self, images: torch.Tensor, task: str) -> Dict[str, Any]:
        for _, m in self._monitored:
            m.metrics = {}
        scales = self.backbone(images)
        if self.vit_encoder is not None:
            enhanced = self.vit_encoder(scales["scale_large"])
            scales["scale_large"] = 0.5 * scales["scale_large"] + 0.5 * enhanced
        fused = self.fpn(scales)
        if self.rag is not None:
            small = fused["fused_small"]
            b, h, w, c = small.shape
            tokens = self.rag(small.reshape(b, h * w, c)).reshape(b, h, w, c)
            fused["fused_small"] = small.float() + torch.tanh(self.rag_gate) * tokens.float()
        out: Dict[str, Any] = {}
        if task in ("detection", "multi_task"):
            out["detection"] = self._head("detection_head")(fused)
        if task in ("segmentation", "multi_task") and self.use_segmentation:
            out["segmentation"] = self._head("segmentation_head")(fused)
        if task in ("depth", "multi_task") and self.use_depth:
            out["depth"] = self._head("depth_head")(fused["fused_small"])
        out["features"] = self.global_features(fused)
        if task in ("classification", "multi_task"):
            out["classification"] = self._head("classifier")(out["features"])
        out["fused_features"] = fused
        if self._monitored:
            out["stability"] = {name: m.metrics for name, m in self._monitored if m.metrics}
        return out


class LightweightHybridVision(HybridVisionSystem):
    """Edge variant with the JAX defaults: no ViT, stages (1, 2, 2, 1) at
    (48, 96, 192, 384) channels, FPN and head towers at 128. Its bottleneck
    mHC widths (24, 48, 96, 192) are not kernel A's, so the fused block
    serves only the 3 FPN levels and 3 head towers (d = 128).

    Other fields as ``HybridVisionSystem``'s. For serving, pass
    ``ProductionHybridVision``'s flags (``precomputed_constraints=True``,
    ``dropout_rate=0.0``; ``monitor`` is off by default), as JAX sets them as
    fields of this class.
    """

    DEFAULTS = dict(use_vit=False, stage_blocks=(1, 2, 2, 1),
                    stage_channels=(48, 96, 192, 384), fpn_channels=128, head_channels=128)

    def __init__(self, **kwargs):
        super().__init__(**{**self.DEFAULTS, **kwargs})


class ProductionHybridVision(HybridVisionSystem):
    """Serving variant: telemetry off, dropout 0, the mHC constraints computed
    once at load (``Detector`` installs them). Same parameters as the
    flagship, so training weights load directly."""

    def __init__(self, **kwargs):
        kwargs.setdefault("monitor", False)
        kwargs.setdefault("dropout_rate", 0.0)
        kwargs.setdefault("precomputed_constraints", True)
        super().__init__(**kwargs)


def detect(model: HybridVisionSystem, images: torch.Tensor, score_threshold: float = 0.25,
           iou_threshold: float = 0.45, max_detections: int = 100, pre_nms_top_k: int = 512,
           nms_method: str = "hard"):
    """Forward + on-device postprocess; returns (NMSResult, raw outputs).
    The model's constraints must be installed (see ``constraints.py``)."""
    out = model(images)
    det = postprocess_detections(out["detection"], score_threshold, iou_threshold,
                                 max_detections, pre_nms_top_k, nms_method)
    return det, out


def collect_stability_metrics(stability: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """JAX's summary of a forward's per-layer telemetry (``out["stability"]``
    of a model built with ``monitor``): ``num_layers``, the mean and max over
    layers of ``signal_ratio``, ``ds_error`` and ``max_eigenvalue`` (those
    the layers report) and ``per_layer``, keyed by the flax path of each
    layer (``backbone/stage1_block0/mhc``) in the order of those paths."""
    per_layer = {name.replace(".", "/"): metrics
                 for name, metrics in sorted(stability.items(),
                                             key=lambda kv: kv[0].replace(".", "/"))}
    summary: Dict[str, Any] = {"num_layers": len(per_layer)}
    for metric in ("signal_ratio", "ds_error", "max_eigenvalue"):
        vals = [float(v[metric]) for v in per_layer.values() if metric in v]
        if vals:
            summary[f"{metric}_mean"] = sum(vals) / len(vals)
            summary[f"{metric}_max"] = max(vals)
    summary["per_layer"] = per_layer
    return summary
