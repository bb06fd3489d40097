"""Models of the port: the flagship detector and its layers."""

from .constraints import compute_constraints, load_constraints, param_tree
from .hybrid import HybridVisionSystem, ProductionHybridVision, detect

__all__ = [
    "HybridVisionSystem", "ProductionHybridVision", "detect",
    "compute_constraints", "load_constraints", "param_tree",
]
