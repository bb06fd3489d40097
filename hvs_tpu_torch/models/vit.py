"""Patch embedding, the ViT encoder with mHC blocks, the query decoder, and
the CNN <-> ViT bridge.

Counterpart of ``hvs_tpu/models/vit.py`` (every module there). Token math
runs in ``dtype`` with an fp32 softmax. ``use_manifold_attention`` gives the
encoder's blocks ``MultiHeadManifoldAttention``; as in JAX, no model of the
package sets it (``ViTConfig.use_manifold_attention`` is read by no
``build_model``), so it is reached by building the encoder directly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Conv, Dense, DenseAttention, LayerNorm, ManifoldHyperConnection,
                     MHCTransformerBlock, attend, gelu)

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


class PatchEmbedding(nn.Module):
    """Images [B, H, W, C] to tokens [B, 1 + gh·gw, dim]: a ``patch_size``
    stride-``patch_size`` convolution with flax's SAME pads (``proj``), a cls
    token, and position embeddings learned on a ``reference_grid`` square
    grid, resized to the image's grid."""

    def __init__(self, in_channels: int = 3, dim: int = 256, patch_size: int = 16,
                 reference_grid: int = 26, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype, self.dim, self.reference_grid = dtype, dim, reference_grid
        self.proj = Conv(in_channels, dim, (patch_size, patch_size), (patch_size, patch_size),
                         dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, reference_grid * reference_grid + 1, dim))

    def reset_parameters(self, g) -> None:
        with torch.no_grad():
            self.cls_token.normal_(0.0, 0.02, generator=g)
            self.pos_embed.normal_(0.0, 0.02, generator=g)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = self.proj(images.to(dt))
        b, gh, gw, _ = x.shape
        grid = (self.reference_grid, self.reference_grid)
        pos = interpolate_pos_embed(self.pos_embed, grid, (gh, gw))
        x = x.reshape(b, gh * gw, self.dim) + pos[:, 1:].to(dt)
        cls_tok = (self.cls_token + pos[:, :1]).to(dt).expand(b, 1, self.dim)
        return torch.cat([cls_tok, x], dim=1)


class VisionTransformerEncoder(nn.Module):
    """``depth`` pre-norm mHC transformer blocks and a final LayerNorm;
    ``dropout_rate``, ``act_quant``, ``use_manifold_attention`` and the mHC
    options ``mhc`` go to every block."""

    def __init__(self, dim: int = 256, depth: int = 6, num_heads: int = 8,
                 dtype: torch.dtype = torch.bfloat16, dropout_rate: float = 0.1,
                 act_quant: bool = False, use_manifold_attention: bool = False, **mhc):
        super().__init__()
        self.dtype = dtype
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i}", MHCTransformerBlock(
                dim, num_heads, dtype=dtype, dropout_rate=dropout_rate, act_quant=act_quant,
                use_manifold_attention=use_manifold_attention, **mhc))
        self.final_norm = LayerNorm(dim, dtype=dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = tokens.to(self.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.final_norm(x)


class VisionTransformerDecoder(nn.Module):
    """Learned queries [num_queries, dim] that attend to encoder tokens
    ``memory`` [B, T, memory_dim] (``dim`` unless given): per layer a
    ``DenseAttention`` over the queries (``self_attn{i}``), a cross-attention
    into the memory (``xq{i}``, ``xk{i}``, ``xv{i}``, ``xproj{i}``; no
    dropout, as in JAX) and a tanh-GELU FFN of width 2·dim, each pre-norm
    with a residual add, then ``final_norm``. The unnamed flax submodules
    keep their auto-names: ``LayerNorm_{3i}``, ``LayerNorm_{3i+1}`` and
    ``LayerNorm_{3i+2}`` of layer i, and its FFN ``Dense_{2i}`` and
    ``Dense_{2i+1}``."""

    def __init__(self, dim: int = 256, depth: int = 2, num_heads: int = 8,
                 num_queries: int = 64, dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16, memory_dim: Optional[int] = None):
        super().__init__()
        self.dim, self.depth, self.num_heads, self.dtype = dim, depth, num_heads, dtype
        mem = dim if memory_dim is None else memory_dim
        self.queries = nn.Parameter(torch.empty(1, num_queries, dim))
        for i in range(depth):
            self.add_module(f"LayerNorm_{3 * i}", LayerNorm(dim, dtype=dtype))
            self.add_module(f"self_attn{i}", DenseAttention(dim, num_heads, dtype=dtype,
                                                            dropout_rate=dropout_rate))
            self.add_module(f"LayerNorm_{3 * i + 1}", LayerNorm(dim, dtype=dtype))
            for name, d_in in (("xq", dim), ("xk", mem), ("xv", mem), ("xproj", dim)):
                self.add_module(f"{name}{i}", Dense(d_in, dim, dtype=dtype))
            self.add_module(f"LayerNorm_{3 * i + 2}", LayerNorm(dim, dtype=dtype))
            self.add_module(f"Dense_{2 * i}", Dense(dim, 2 * dim, dtype=dtype))
            self.add_module(f"Dense_{2 * i + 1}", Dense(2 * dim, dim, dtype=dtype))
        self.final_norm = LayerNorm(dim, dtype=dtype)

    def reset_parameters(self, g) -> None:
        with torch.no_grad():
            self.queries.normal_(0.0, 0.02, generator=g)

    def _cross_attention(self, i: int, y: torch.Tensor, mem: torch.Tensor) -> torch.Tensor:
        out = attend(getattr(self, f"xq{i}")(y), getattr(self, f"xk{i}")(mem),
                     getattr(self, f"xv{i}")(mem), self.num_heads, self.dtype)
        return getattr(self, f"xproj{i}")(out)

    def forward(self, memory: torch.Tensor) -> torch.Tensor:
        b = memory.shape[0]
        x = self.queries.expand(b, -1, -1).to(self.dtype)
        mem = memory.to(self.dtype)
        for i in range(self.depth):
            x = x + getattr(self, f"self_attn{i}")(getattr(self, f"LayerNorm_{3 * i}")(x))
            x = x + self._cross_attention(i, getattr(self, f"LayerNorm_{3 * i + 1}")(x), mem)
            y = getattr(self, f"Dense_{2 * i}")(getattr(self, f"LayerNorm_{3 * i + 2}")(x))
            x = x + getattr(self, f"Dense_{2 * i + 1}")(gelu(y))
        return self.final_norm(x)


class HybridVisionEncoder(nn.Module):
    """CNN <-> ViT bridge on the backbone's ``scale_large`` map [B, h, w, C]:
    1x1 to tokens, + position embeddings, a cls token, the encoder, the cls
    vector broadcast back over the grid, 1x1 back to C channels, added to the
    input and fused by an mHC layer at width C. ``dropout_rate``, the mHC
    options ``mhc`` and ``act_quant`` (the JAX model's ``act_quant_vit``: the
    blocks' projections and mHC chains and the fusion's chain in int8; the
    token convs stay float) go to the encoder and the fusion layer;
    ``use_manifold_attention`` to the encoder."""

    def __init__(self, cnn_channels: int = 512, dim: int = 256, depth: int = 6,
                 num_heads: int = 8, dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.1, act_quant: bool = False,
                 use_manifold_attention: bool = False, **mhc):
        super().__init__()
        self.dtype, self.dim = dtype, dim
        self.to_tokens = Conv(cnn_channels, dim, (1, 1), dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, POS_GRID * POS_GRID + 1, dim))
        self.encoder = VisionTransformerEncoder(dim, depth, num_heads, dtype=dtype,
                                                dropout_rate=dropout_rate, act_quant=act_quant,
                                                use_manifold_attention=use_manifold_attention,
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
