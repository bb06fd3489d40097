"""ROI pooling for per-detection appearance embeddings.

Counterpart of ``hvs_tpu/models/rag.py::roi_pool_bilinear`` (this function
only: the knowledge-retrieval modules wait for ROADMAP queue 1, item 9). It
feeds the serving engine's ``return_embeddings`` option.
"""

from __future__ import annotations

import torch


def roi_pool_bilinear(feature_map: torch.Tensor, boxes: torch.Tensor,
                      samples: int = 4) -> torch.Tensor:
    """Lightweight ROI-align: bilinear-sample a ``samples`` x ``samples``
    grid inside each box and average.

    Args:
        feature_map: [B, H, W, C].
        boxes: [B, K, 4] normalized xyxy.
    Returns: [B, K, C] region features in fp32.
    """
    bsz, h, w, c = feature_map.shape
    k = boxes.shape[1]
    frac = (torch.arange(samples, dtype=torch.float32, device=boxes.device) + 0.5) / samples
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    xs = x1[..., None] + (x2 - x1)[..., None] * frac  # [B, K, S]
    ys = y1[..., None] + (y2 - y1)[..., None] * frac
    px = torch.clamp(xs * w - 0.5, 0.0, w - 1.0)
    py = torch.clamp(ys * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(px).long()
    y0 = torch.floor(py).long()
    x1i = torch.clamp(x0 + 1, max=w - 1)
    y1i = torch.clamp(y0 + 1, max=h - 1)
    fx = px - x0.float()
    fy = py - y0.float()
    fm = feature_map.float().reshape(bsz, h * w, c)

    def corner(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        # Rows yi and columns xi [B, K, S] -> [B, K, S, S, C].
        flat = (yi[..., :, None] * w + xi[..., None, :]).reshape(bsz, -1)
        picked = torch.gather(fm, 1, flat[..., None].expand(-1, -1, c))
        return picked.reshape(bsz, k, samples, samples, c)

    c00, c01 = corner(y0, x0), corner(y0, x1i)
    c10, c11 = corner(y1i, x0), corner(y1i, x1i)
    wy = fy[..., :, None, None]
    wx = fx[..., None, :, None]
    top = c00 * (1 - wx) + c01 * wx
    bot = c10 * (1 - wx) + c11 * wx
    return (top * (1 - wy) + bot * wy).mean(dim=(2, 3))
