"""Utilities (counterpart of the parts of ``hvs_tpu/utils`` that serving needs)."""

from .metrics import InferenceMetrics

__all__ = ["InferenceMetrics"]
