"""Inference/serving configuration.

Counterpart of ``hvs_tpu/config/inference.py`` with the same fields and
defaults. On the card, ``engine`` ``"jit"`` and ``"aot"`` mean the same
thing: ``InferenceEngine`` captures one CUDA graph per batch bucket (and per
registered raw source shape). ``performance.compile_cache_dir`` is accepted
and unused: nothing is compiled that a cache could keep.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from .base import BaseConfig, from_dict


@dataclass
class PreprocessingConfig:
    """(reference: inference_config.py:48-101 — letterbox, pad 114, ImageNet norm)"""

    image_size: int = 416
    letterbox: bool = True
    pad_color: int = 114
    bgr_to_rgb: bool = True
    normalize: bool = True
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    cache_size: int = 8  # shape-keyed preprocessing cache


@dataclass
class PostprocessingConfig:
    """(reference: inference_config.py PostprocessingConfig +
    src/inference/postprocessing.py:31-67)"""

    nms_method: str = "hard"  # hard | soft | matrix
    score_threshold: float = 0.25
    iou_threshold: float = 0.45
    max_detections: int = 100
    pre_nms_top_k: int = 512
    calibration_temperature: float = 1.0
    min_box_size: float = 2.0
    max_aspect_ratio: float = 20.0
    tracking: str = "none"  # none | iou | appearance
    # Return an L2-normalized ROI-pooled appearance embedding per detection
    # (device-side, from the fused small scale) — feeds AppearanceTracker
    # (reference DeepSORT attempt: src/inference/postprocessing.py:850-1119).
    return_embeddings: bool = False


@dataclass
class VisualizationConfig:
    """(reference: inference_config.py VisualizationConfig)"""

    box_thickness: int = 2
    font_scale: float = 0.5
    show_scores: bool = True
    show_fps: bool = True
    palette: str = "hsv"


@dataclass
class APIConfig:
    """(reference: inference_config.py APIConfig)"""

    host: str = "0.0.0.0"
    port: int = 8000
    max_upload_mb: int = 16
    enable_cors: bool = True
    enable_metrics: bool = True


@dataclass
class GRPCConfig:
    """(reference: inference_config.py GRPCConfig)"""

    host: str = "0.0.0.0"
    port: int = 50051
    max_workers: int = 4
    max_message_mb: int = 32


@dataclass
class PerformanceConfig:
    """Serving performance (reference: inference_config.py:380-406 —
    dynamic batching knobs, rebuilt as fixed-shape buckets)."""

    # One captured CUDA graph per bucket; requests pad into the smallest
    # bucket that fits them.
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16)
    max_queue_delay_ms: float = 10.0
    warmup_iterations: int = 3
    # Camera/source shapes (h, w) whose raw-frame graphs (letterbox on the
    # card inside the graph) are captured by register_raw_shape; other shapes
    # are letterboxed eagerly and served by the letterboxed graphs.
    warmup_raw_shapes: Tuple[Tuple[int, int], ...] = ()
    latency_target_ms: float = 50.0
    # Queueing-delay budget for admission-queue sizing (micro-batcher depth =
    # budget / measured per-item service time); 0 -> use latency_target_ms.
    queue_budget_ms: float = 0.0
    fps_target: float = 30.0
    compile_cache_dir: Optional[str] = ".jax_cache"  # unused in the port
    # Admission control: bound the micro-batch queue so
    # overload degrades by SHEDDING, not unbounded queueing (p95 stays within
    # the latency SLA). Depth in requests; 0 = 2x the largest bucket.
    # Policies: "reject" -> submit raises EngineOverloaded (API returns 429);
    # "shed_oldest" -> the oldest queued request is failed instead (the
    # reference's drop-oldest under pressure, preprocessing.py:489-497).
    max_queue_depth: int = 0
    overload_policy: str = "reject"


@dataclass
class InferenceConfig(BaseConfig):
    """(reference: inference_config.py:452-536)"""

    engine: str = "jit"  # jit | aot: both capture one CUDA graph per bucket
    checkpoint_path: Optional[str] = None
    use_ema: bool = True  # prefer EMA weights in checkpoints when present
    camera_source: int = 0
    max_image_pixels: int = 4096 * 4096
    safety_checks: bool = True
    preprocessing: PreprocessingConfig = field(default_factory=PreprocessingConfig)
    postprocessing: PostprocessingConfig = field(default_factory=PostprocessingConfig)
    visualization: VisualizationConfig = field(default_factory=VisualizationConfig)
    api: APIConfig = field(default_factory=APIConfig)
    grpc: GRPCConfig = field(default_factory=GRPCConfig)
    performance: PerformanceConfig = field(default_factory=PerformanceConfig)

    def __post_init__(self):
        for name, cls in (
            ("preprocessing", PreprocessingConfig),
            ("postprocessing", PostprocessingConfig),
            ("visualization", VisualizationConfig),
            ("api", APIConfig),
            ("grpc", GRPCConfig),
            ("performance", PerformanceConfig),
        ):
            value = getattr(self, name)
            if isinstance(value, dict):
                setattr(self, name, from_dict(cls, value))
        super().__post_init__()
        assert self.engine in ("jit", "aot")
        assert self.postprocessing.nms_method in ("hard", "soft", "matrix")
