"""Top-level detector: backbone -> ViT blend -> FPN -> YOLO head.

Counterpart of ``hvs_tpu/models/hybrid.py`` (``HybridVisionSystem`` for the
detection task with the global feature vector, ``ProductionHybridVision``,
``detect``). The segmentation and depth heads, RAG and the classifier are
not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.sinkhorn import sinkhorn_log_many
from .backbone import HybridVisionBackbone
from .fpn import OUT_CHANNELS, OUT_NAMES, FeaturePyramidNetwork
from .layers import Dense, ManifoldHyperConnection, init_weights
from .vit import HybridVisionEncoder
from .yolo_head import YOLODetectionHead, postprocess_detections


class HybridVisionSystem(nn.Module):
    """The flagship CNN+ViT detector on NHWC images in [0, 1].

    Defaults are the flagship's widths and the JAX model's training flags:
    the mHC constraints are computed in every forward (Sinkhorn with
    ``sk_iters`` iterations), ``dropout_rate`` reaches the ViT and the
    feature mHC (the head towers keep the layer default 0.1, backbone and FPN
    0, as in JAX), and ``monitor`` turns on the per-layer telemetry, returned
    under ``"stability"`` ({mHC module path: metrics}) as the JAX
    ``stability`` collection. Torch's ``train()``/``eval()`` take the part of
    JAX's ``deterministic`` flag. The model is built with a seeded, flax-like
    random init (``seed``) on ``device``: the CUDA card unless
    ``device="cpu"`` is passed. Real weights come from a flax tree through
    ``hvs_tpu_torch.convert.load_flax_params``.

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
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.sk_iters = sk_iters
        mhc = dict(sk_iters=sk_iters, monitor=monitor,
                   precomputed_constraints=precomputed_constraints)
        self.backbone = HybridVisionBackbone(base_channels, stage_blocks, stage_channels,
                                             dtype=dtype, **mhc)
        self.vit_encoder = HybridVisionEncoder(stage_channels[-1], vit_dim, vit_depth, vit_heads,
                                               dtype=dtype, dropout_rate=dropout_rate, **mhc)
        self.fpn = FeaturePyramidNetwork(tuple(stage_channels[1:]), fpn_channels, dtype=dtype,
                                         **mhc)
        self.detection_head = YOLODetectionHead(OUT_CHANNELS, num_classes, head_channels,
                                                dtype=dtype, **mhc)
        self.feature_proj = Dense(sum(OUT_CHANNELS), feature_dim, dtype=dtype)
        self.mhc_features = ManifoldHyperConnection(feature_dim, 1, 2, dtype=dtype,
                                                    dropout_rate=dropout_rate, **mhc)
        self._monitored = [(name, m) for name, m in self.named_modules()
                           if isinstance(m, ManifoldHyperConnection) and m.monitor]
        # Layers that project H_res in their forward, grouped by (iterations, tau).
        self._projecting: Dict[Tuple[int, float], List[ManifoldHyperConnection]] = {}
        for m in self.modules():
            if isinstance(m, ManifoldHyperConnection) and not m.precomputed_constraints:
                self._projecting.setdefault((m.sk_iters, m.tau), []).append(m)
        init_weights(self, seed)
        self.to(device)

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        for (iters, tau), layers in self._projecting.items():
            projected = sinkhorn_log_many([m.H_res_raw for m in layers], iters, tau)
            for m, h_res in zip(layers, projected):
                m.h_res_given = h_res
        try:
            return self._forward(images)
        finally:
            for layers in self._projecting.values():
                for m in layers:
                    m.h_res_given = None

    def _forward(self, images: torch.Tensor) -> Dict[str, Any]:
        scales = self.backbone(images)
        enhanced = self.vit_encoder(scales["scale_large"])
        scales["scale_large"] = 0.5 * scales["scale_large"] + 0.5 * enhanced
        fused = self.fpn(scales)
        det = self.detection_head(fused)
        pooled = torch.cat([fused[k].float().mean(dim=(1, 2)) for k in OUT_NAMES], dim=-1)
        feats = self.mhc_features(self.feature_proj(pooled.to(self.dtype)))
        out = {"detection": det, "features": feats, "fused_features": fused}
        if self._monitored:
            out["stability"] = {name: m.metrics for name, m in self._monitored}
        return out


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
           iou_threshold: float = 0.45, max_detections: int = 100, pre_nms_top_k: int = 512):
    """Forward + on-device postprocess; returns (NMSResult, raw outputs).
    The model's constraints must be installed (see ``constraints.py``)."""
    out = model(images)
    det = postprocess_detections(out["detection"], score_threshold, iou_threshold,
                                 max_detections, pre_nms_top_k)
    return det, out
