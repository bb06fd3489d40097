"""Birkhoff-polytope tangent projection for the mHC optimizer.

Counterpart of ``birkhoff_tangent_project`` in ``hvs_tpu/ops/manifold.py``.
"""

from __future__ import annotations

import torch


def birkhoff_tangent_project(point: torch.Tensor, vector: torch.Tensor) -> torch.Tensor:
    """Project ``vector`` onto the tangent space of the Birkhoff polytope at
    ``point``: {V : V 1 = 0, V^T 1 = 0}. The closed form subtracts the row and
    column means and adds back the grand mean (``point`` is not needed)."""
    del point
    row_mean = vector.mean(dim=-1, keepdim=True)
    col_mean = vector.mean(dim=-2, keepdim=True)
    grand_mean = vector.mean(dim=(-1, -2), keepdim=True)
    return vector - row_mean - col_mean + grand_mean
