"""Utilities (counterpart of ``hvs_tpu/utils``' metrics)."""

from .metrics import DetectionEvaluator, InferenceMetrics, StabilityMetrics

__all__ = ["DetectionEvaluator", "InferenceMetrics", "StabilityMetrics"]
