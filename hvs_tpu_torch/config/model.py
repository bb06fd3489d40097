"""Model configuration: nested dataclasses for every architectural block.

Counterpart of ``hvs_tpu/config/model.py`` with the same fields and
defaults. ``ModelConfig.build_model`` builds the port's
``HybridVisionSystem`` / ``ProductionHybridVision`` from the fields the JAX
method passes (``vit.enabled``, ``use_segmentation`` and ``use_depth``
included). ``mhc.use_pallas`` is kept for file compatibility and has no
effect: on the card every eligible mHC site runs the Hopper kernel, on the
CPU its plain version. ``rag.enabled`` builds the retrieval model, and
``production`` with ``quantization.enabled`` the int8 serve model.
``vit.use_manifold_attention`` is read by no ``build_model``, as in JAX: the
manifold-attention encoder is built directly (``models.HybridVisionEncoder``).
``vitdet.enabled`` builds the plain-ViT detector instead of the hybrid
(``models.vitdet``; a model of the port alone, with no JAX counterpart).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from ..device import DeviceLike
from .base import BaseConfig, from_dict


@dataclass
class MHCConfig:
    """mHC hyperparameters (reference: model_config.py:45-98)."""

    expansion_rate: int = 1
    mlp_ratio: int = 1
    sinkhorn_iterations: int = 20
    tau: float = 1.0
    alpha: float = 0.01  # manifold regularization weight
    gradient_clip: float = 0.5
    eigenvalue_threshold: float = 1.1
    dropout_rate: float = 0.1
    # Kept for file compatibility with the JAX config; no effect in the port.
    use_pallas: Optional[bool] = None

    def validate(self):
        assert self.sinkhorn_iterations > 0
        assert self.expansion_rate >= 1


@dataclass
class BackboneConfig:
    """CNN backbone (reference: model_config.py:100-179)."""

    base_channels: int = 32
    stage_blocks: Tuple[int, ...] = (2, 3, 4, 2)
    stage_channels: Tuple[int, ...] = (64, 128, 256, 512)
    use_se: bool = True
    use_mhc: bool = True

    def validate(self):
        assert len(self.stage_blocks) == len(self.stage_channels)


@dataclass
class ViTConfig:
    """ViT enhancement (reference: model_config.py:181-254)."""

    enabled: bool = True
    dim: int = 256
    depth: int = 6
    num_heads: int = 8
    use_manifold_attention: bool = False

    def validate(self):
        assert self.dim % self.num_heads == 0


@dataclass
class FusionConfig:
    """Feature fusion (reference: model_config.py:256-296; fpn/pan/bifpn enum)."""

    method: str = "fpn"
    fpn_channels: int = 256
    out_channels: Tuple[int, ...] = (256, 512, 1024)

    def validate(self):
        assert self.method in ("fpn", "adaptive", "multiscale")


@dataclass
class DetectionHeadConfig:
    """YOLO head (reference: model_config.py:298-378)."""

    num_classes: int = 80
    num_anchors: int = 3
    head_channels: int = 256
    score_threshold: float = 0.25
    iou_threshold: float = 0.45
    max_detections: int = 100
    pre_nms_top_k: int = 512
    nms_method: str = "hard"

    def validate(self):
        assert self.nms_method in ("hard", "soft", "matrix")


@dataclass
class RAGConfig:
    """Knowledge retrieval (reference: model_config.py:380-430)."""

    enabled: bool = False
    knowledge_dim: int = 128
    top_k: int = 5
    class_names: Optional[Tuple[str, ...]] = None  # KB seed; None -> COCO


@dataclass
class QuantizationConfig:
    """Int8 serving, W8A8 (``hvs_tpu_torch/ops/quant.py``): with ``enabled``,
    ``build_model(production=True)`` builds the int8 twin of the serve model
    (the backbone's convolutions and the head towers' in int8; the knobs
    below extend it), and ``InferenceEngine`` serves it with calibrated
    per-site activation scales: those embedded in its variables (``quant``),
    else the sidecar at ``scales_path``, which ``python -m
    hvs_tpu_torch.quantize`` writes with ``torch.save`` (``{site: fp32
    scalar}``; the JAX package writes a flax msgpack tree there), else a
    ``ValueError``. Float checkpoints load unchanged."""

    enabled: bool = False
    scales_path: Optional[str] = None
    # Calibration headroom lives at calibration time (python -m
    # hvs_tpu_torch.quantize --margin), not here: the engine only reads scales.
    # Extend int8 to the FPN laterals/refines/projections (a further ~11% of
    # serve bytes). Separate knob so its accuracy cost is measurable alone.
    quantize_fpn: bool = False
    # Extend int8 to the backbone channel-mHC matmul chains (the largest
    # remaining bf16 activation streams after the convs). Separate knob.
    quantize_mhc: bool = False
    # Extend int8 to the ViT encoder (QKV/out projections + mHC chains).
    quantize_vit: bool = False


@dataclass
class ViTDetConfig:
    """The plain-ViT detector (``models/vitdet.py``): ViTDet's backbone (Li,
    Mao, Girshick, He, arXiv:2203.16527; detectron2
    ``modeling/backbone/vit.py``) and simple feature pyramid, feeding the
    port's YOLO head. Defaults are ViT-B/16's. The global blocks' relative
    position tables are sized from ``ModelConfig.input_size``."""

    enabled: bool = False
    patch_size: int = 16
    dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    window_size: int = 14
    window_block_indexes: Tuple[int, ...] = (0, 1, 3, 4, 6, 7, 9, 10)
    pretrain_grid: int = 14  # side of the pretrained absolute position grid
    pyramid_scales: Tuple[float, ...] = (2.0, 1.0, 0.5)
    pyramid_channels: int = 256

    def validate(self):
        assert self.dim % self.num_heads == 0
        assert all(0 <= i < self.depth for i in self.window_block_indexes)


# Options of the hybrid that the plain-ViT detector does not have.
_HYBRID_ONLY = ("vit.enabled", "rag.enabled", "use_segmentation", "use_depth",
                "quantization.enabled")


@dataclass
class ModelConfig(BaseConfig):
    """Composed model config (reference: model_config.py:432-653)."""

    input_size: int = 416
    feature_dim: int = 256
    mhc: MHCConfig = field(default_factory=MHCConfig)
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    vit: ViTConfig = field(default_factory=ViTConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    detection: DetectionHeadConfig = field(default_factory=DetectionHeadConfig)
    rag: RAGConfig = field(default_factory=RAGConfig)
    quantization: QuantizationConfig = field(default_factory=QuantizationConfig)
    use_segmentation: bool = False
    use_depth: bool = False
    vitdet: ViTDetConfig = field(default_factory=ViTDetConfig)

    def __post_init__(self):
        # Re-hydrate nested dicts (YAML load path).
        for name, cls in (
            ("mhc", MHCConfig), ("backbone", BackboneConfig), ("vit", ViTConfig),
            ("fusion", FusionConfig), ("detection", DetectionHeadConfig),
            ("rag", RAGConfig), ("quantization", QuantizationConfig),
            ("vitdet", ViTDetConfig),
        ):
            value = getattr(self, name)
            if isinstance(value, dict):
                setattr(self, name, from_dict(cls, value))
        super().__post_init__()
        for sub in (self.mhc, self.backbone, self.vit, self.fusion, self.detection,
                    self.vitdet):
            sub.validate()

    def estimate_parameters(self) -> int:
        """Analytic parameter estimate (reference: model_config.py parameter
        estimator). Exact counts come from initializing the model."""
        est = 0
        chans = self.backbone.stage_channels
        blocks = self.backbone.stage_blocks
        prev = chans[0]
        est += 3 * self.backbone.base_channels * 9 + self.backbone.base_channels * prev * 9
        for c, n in zip(chans, blocks):
            mid = c // 2
            per_block = prev * mid + mid * mid * 9 + mid * c + 5 * mid * mid
            est += per_block + (n - 1) * (c * mid + mid * mid * 9 + mid * c + 5 * mid * mid)
            prev = c
        if self.vit.enabled:
            d = self.vit.dim
            est += self.vit.depth * (4 * d * d + 5 * d * d) + 2 * chans[-1] * d
        f = self.fusion.fpn_channels
        est += sum(c * f for c in chans[1:]) + 3 * (f * f * 9 + 5 * f * f)
        est += sum(f * o for o in self.fusion.out_channels)
        h = self.detection.head_channels
        est += sum(o * h + h * h * 9 + 5 * h * h + h * self.detection.num_anchors *
                   (5 + self.detection.num_classes) for o in self.fusion.out_channels)
        return est

    def output_shapes(self, batch: int = 1) -> Dict[str, Tuple[int, ...]]:
        """Static output-shape calculator (reference: model_config.py output-shape
        calculator)."""
        s = self.input_size
        a = self.detection.num_anchors
        c = self.detection.num_classes
        n = sum((s // st) ** 2 * a for st in (8, 16, 32))
        return {
            "boxes": (batch, n, 4),
            "scores": (batch, n, c),
            "features": (batch, self.feature_dim),
            "nms_boxes": (batch, self.detection.max_detections, 4),
        }

    def build_model(self, production: bool = False, monitor: bool = False,
                    device: DeviceLike = None, seed: int = 0, task: str = "detection"):
        """The port's model from this config, on ``device`` (default: the
        config's ``device``), with a seeded random init.

        ``production`` builds ``ProductionHybridVision`` (telemetry off,
        dropout 0, constraints computed at load); ``monitor`` turns on the
        per-layer stability telemetry of a training model. ``task`` is the
        task whose heads get parameters, as the flax model's ``init`` task
        decides it (``"multi_task"`` builds every head the flags enable).
        ``production`` with ``quantization.enabled`` builds the int8 twin (its
        scales are loaded separately: ``models.quantize.load_quant_scales``).
        With ``vitdet.enabled`` it builds ``ViTDetDetector`` (``task`` must
        be ``"detection"``), and raises ``ValueError`` if an option of the
        hybrid is also set."""
        from ..models import HybridVisionSystem, ProductionHybridVision

        if self.vitdet.enabled:
            return self._build_vitdet(production, monitor, device, seed, task)

        cls = ProductionHybridVision if production else HybridVisionSystem
        q = self.quantization
        int8 = production and q.enabled
        return cls(
            monitor=False if production else monitor,
            num_classes=self.detection.num_classes,
            use_vit=self.vit.enabled,
            use_segmentation=self.use_segmentation,
            use_depth=self.use_depth,
            # As JAX's build_model: the knowledge module keeps its own
            # knowledge_dim and top_k defaults.
            use_rag=self.rag.enabled,
            rag_classes=tuple(self.rag.class_names) if self.rag.class_names else None,
            task=task,
            sk_iters=self.mhc.sinkhorn_iterations,
            base_channels=self.backbone.base_channels,
            stage_blocks=tuple(self.backbone.stage_blocks),
            stage_channels=tuple(self.backbone.stage_channels),
            vit_dim=self.vit.dim,
            vit_depth=self.vit.depth,
            vit_heads=self.vit.num_heads,
            fpn_channels=self.fusion.fpn_channels,
            head_channels=self.detection.head_channels,
            feature_dim=self.feature_dim,
            dropout_rate=0.0 if production else self.mhc.dropout_rate,
            dtype=self.dtype(),
            device=self.device if device is None else device,
            seed=seed,
            act_quant=int8,
            act_quant_fpn=int8 and q.quantize_fpn,
            act_quant_mhc=int8 and q.quantize_mhc,
            act_quant_vit=int8 and q.quantize_vit,
        )

    def _build_vitdet(self, production: bool, monitor: bool, device: DeviceLike, seed: int,
                      task: str):
        from ..models.vitdet import ViTDetDetector

        on = [name for name in _HYBRID_ONLY if functools.reduce(getattr, name.split("."), self)]
        if on:
            raise ValueError(f"vitdet.enabled builds the plain-ViT detector, which has none of "
                             f"the hybrid's options: turn off {', '.join(on)}")
        if task != "detection":
            raise ValueError(f"the plain-ViT detector has only the detection task, not {task!r}")
        v = self.vitdet
        return ViTDetDetector(
            input_size=self.input_size, patch_size=v.patch_size, dim=v.dim, depth=v.depth,
            num_heads=v.num_heads, mlp_ratio=v.mlp_ratio, window_size=v.window_size,
            window_block_indexes=tuple(v.window_block_indexes), pretrain_grid=v.pretrain_grid,
            pyramid_scales=tuple(v.pyramid_scales), pyramid_channels=v.pyramid_channels,
            num_classes=self.detection.num_classes, num_anchors=self.detection.num_anchors,
            head_channels=self.detection.head_channels, sk_iters=self.mhc.sinkhorn_iterations,
            monitor=False if production else monitor, precomputed_constraints=production,
            dtype=self.dtype(), device=self.device if device is None else device, seed=seed)
