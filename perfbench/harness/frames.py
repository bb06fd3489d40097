"""Seeded camera frames: raw BGR uint8, made on the device in a few draws
and handed to the program as host arrays, as a camera hands them over."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .weights import generator


def make_frames(n: int, h: int, w: int, seed: int, device: torch.device) -> torch.Tensor:
    """[n, h, w, 3] uint8 on ``device``: smooth colour fields (bilinear from
    an eighth of the size) with pixel noise, so each frame has structure at
    every scale."""
    g = generator(seed, device, 1)
    coarse = torch.rand(n, 3, -(-h // 8), -(-w // 8), generator=g, device=device) * 255.0
    fine = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    noise = (torch.rand(n, 3, h, w, generator=g, device=device) - 0.5) * 48.0
    return (fine + noise).clamp_(0, 255).round_().to(torch.uint8).permute(0, 2, 3, 1).contiguous()
