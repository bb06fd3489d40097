"""Models of the port: the flagship with its detection, segmentation, depth
and classification heads, the lightweight variant, and their layers."""

from .constraints import compute_constraints, load_constraints, param_tree
from .hybrid import (DepthHead, HybridVisionSystem, LightweightHybridVision,
                     ProductionHybridVision, SegmentationHead, detect)

__all__ = [
    "HybridVisionSystem", "LightweightHybridVision", "ProductionHybridVision",
    "SegmentationHead", "DepthHead", "detect", "compute_constraints", "load_constraints",
    "param_tree",
]
