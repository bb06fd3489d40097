"""Models of the port: the flagship with its detection, segmentation, depth
and classification heads and its retrieval module (``rag.py``), the
lightweight variant, their layers, and the int8 calibration of the serve
model."""

from .constraints import compute_constraints, load_constraints, param_tree
from .hybrid import (DepthHead, HybridVisionSystem, LightweightHybridVision,
                     ProductionHybridVision, SegmentationHead, detect)
from .quantize import calibrate_quant_scales, load_quant_scales

__all__ = [
    "HybridVisionSystem", "LightweightHybridVision", "ProductionHybridVision",
    "SegmentationHead", "DepthHead", "detect", "compute_constraints", "load_constraints",
    "param_tree", "calibrate_quant_scales", "load_quant_scales",
]
