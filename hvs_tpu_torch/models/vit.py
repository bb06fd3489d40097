"""ViT encoder with mHC blocks, and the CNN <-> ViT bridge.

Counterpart of ``hvs_tpu/models/vit.py`` (``interpolate_pos_embed``,
``VisionTransformerEncoder``, ``HybridVisionEncoder``). Token math runs in
``dtype`` with an fp32 softmax.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, LayerNorm, ManifoldHyperConnection, MHCTransformerBlock

POS_GRID = 13  # side of the learned position-embedding grid


def interpolate_pos_embed(pos: torch.Tensor, src_grid: Tuple[int, int],
                          dst_grid: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of grid position embeddings [1, 1 + h*w, d]; the cls
    position passes through. Antialiased like ``jax.image.resize``, which
    matters when the grid shrinks (inputs below 416²)."""
    src_grid, dst_grid = tuple(src_grid), tuple(dst_grid)
    if src_grid == dst_grid:
        return pos
    cls_pos, grid_pos = pos[:, :1], pos[:, 1:]
    d = grid_pos.shape[-1]
    grid = grid_pos.reshape(1, src_grid[0], src_grid[1], d).permute(0, 3, 1, 2)
    resized = F.interpolate(grid, size=dst_grid, mode="bilinear", align_corners=False,
                            antialias=True)
    return torch.cat([cls_pos, resized.permute(0, 2, 3, 1).reshape(1, -1, d)], dim=1)


class VisionTransformerEncoder(nn.Module):
    """``depth`` pre-norm mHC transformer blocks and a final LayerNorm;
    ``dropout_rate``, ``act_quant`` and the mHC options ``mhc`` go to every
    block."""

    def __init__(self, dim: int = 256, depth: int = 6, num_heads: int = 8,
                 dtype: torch.dtype = torch.bfloat16, dropout_rate: float = 0.1,
                 act_quant: bool = False, **mhc):
        super().__init__()
        self.dtype = dtype
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i}", MHCTransformerBlock(
                dim, num_heads, dtype=dtype, dropout_rate=dropout_rate, act_quant=act_quant,
                **mhc))
        self.final_norm = LayerNorm(dim, dtype=dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = tokens.to(self.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.final_norm(x)


class HybridVisionEncoder(nn.Module):
    """CNN <-> ViT bridge on the backbone's ``scale_large`` map [B, h, w, C]:
    1x1 to tokens, + position embeddings, a cls token, the encoder, the cls
    vector broadcast back over the grid, 1x1 back to C channels, added to the
    input and fused by an mHC layer at width C. ``dropout_rate``, the mHC
    options ``mhc`` and ``act_quant`` (the JAX model's ``act_quant_vit``: the
    blocks' projections and mHC chains and the fusion's chain in int8; the
    token convs stay float) go to the encoder and the fusion layer."""

    def __init__(self, cnn_channels: int = 512, dim: int = 256, depth: int = 6,
                 num_heads: int = 8, dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.1, act_quant: bool = False, **mhc):
        super().__init__()
        self.dtype, self.dim = dtype, dim
        self.to_tokens = Conv(cnn_channels, dim, (1, 1), dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, POS_GRID * POS_GRID + 1, dim))
        self.encoder = VisionTransformerEncoder(dim, depth, num_heads, dtype=dtype,
                                                dropout_rate=dropout_rate, act_quant=act_quant,
                                                **mhc)
        self.to_cnn = Conv(dim, cnn_channels, (1, 1), dtype=dtype)
        self.mhc_fuse = ManifoldHyperConnection(cnn_channels, 1, 1, dtype=dtype,
                                                dropout_rate=dropout_rate, act_quant=act_quant,
                                                quant_sites=True, **mhc)

    def reset_parameters(self, g) -> None:
        with torch.no_grad():
            self.cls_token.normal_(0.0, 0.02, generator=g)
            self.pos_embed.normal_(0.0, 0.02, generator=g)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = feat.shape
        dt = self.dtype
        feat = feat.to(dt)
        tokens = self.to_tokens(feat).reshape(b, h * w, self.dim)
        pos = interpolate_pos_embed(self.pos_embed, (POS_GRID, POS_GRID), (h, w))
        tokens = tokens + pos[:, 1:].to(dt)
        cls_tok = (self.cls_token + pos[:, :1]).to(dt).expand(b, 1, self.dim)
        tokens = self.encoder(torch.cat([cls_tok, tokens], dim=1))
        grid_out = tokens[:, 1:].reshape(b, h, w, self.dim)
        combined = grid_out + tokens[:, :1, None, :]
        return self.mhc_fuse(feat + self.to_cnn(combined))
