"""Utilities (counterpart of ``hvs_tpu/utils``): metrics, structured
logging and profiling."""

from .logging import StructuredLogger, setup_logger
from .metrics import DetectionEvaluator, InferenceMetrics, StabilityMetrics
from .profiler import InferenceProfiler, ModelProfiler, ProfileReport, ResourceMonitor

__all__ = ["DetectionEvaluator", "InferenceMetrics", "StabilityMetrics", "StructuredLogger",
           "setup_logger", "ModelProfiler", "InferenceProfiler", "ResourceMonitor",
           "ProfileReport"]
