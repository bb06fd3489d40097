"""Multi-scale feature fusion on NHWC maps: the top-down FPN with an mHC
layer per level, and the fusion variants (resize-concat-project, attention
across scale summaries, learned softmax weights over scales).

Counterpart of ``hvs_tpu/models/fpn.py`` (every module there). Nearest
resizes sample at half-pixel centres, as ``jax.image.resize(...,
"nearest")`` does (``F.interpolate``'s ``"nearest-exact"``; its
``"nearest"`` agrees only at integer factors).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import quantize_tensor
from .layers import (Conv, Dense, ManifoldHyperConnection, QuantConv, QuantSites, attend,
                     group_norm, silu_norm)

SCALES = ("scale_small", "scale_medium", "scale_large")
OUT_NAMES = ("fused_small", "fused_medium", "fused_large")
OUT_CHANNELS = (256, 512, 1024)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NHWC map (a repeat of each pixel)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (b, *size, c), "nearest")`` of an NHWC map."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="nearest-exact")
    return y.permute(0, 2, 3, 1)


class FeaturePyramidNetwork(QuantSites, nn.Module):
    """1x1 laterals to ``fpn_channels``, top-down nearest upsample + add, a 3x3
    refine, GroupNorm + SiLU, a channel mHC per level (none with
    ``use_mhc=False``: no ``mhc{i}`` parameters), and 1x1 projections to
    ``out_channels``. Input: the backbone's three scales. ``mhc`` are keyword
    options of the mHC layers (their dropout rate is ``dropout_rate``, 0 as in
    JAX).

    ``act_quant`` (the JAX model's ``act_quant_fpn``): ``lateral{i}``,
    ``refine{i}`` and ``out{i}`` take int8 inputs (sites ``lat{i}_scale``,
    ``td{i}_scale``, ``y{i}_scale``); the top-down adds and the mHC layers
    stay bf16, as in JAX."""

    def __init__(self, in_channels: Sequence[int] = (128, 256, 512), fpn_channels: int = 256,
                 dtype: torch.dtype = torch.bfloat16, dropout_rate: float = 0.0,
                 act_quant: bool = False, out_channels: Sequence[int] = OUT_CHANNELS,
                 use_mhc: bool = True, **mhc):
        super().__init__()
        self.dtype = dtype
        self.act_quant = act_quant
        self.use_mhc = use_mhc
        conv = QuantConv if act_quant else partial(Conv, use_bias=False)
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", conv(c, fpn_channels, (1, 1), dtype=dtype))
        for i, out_ch in enumerate(out_channels):
            self.add_module(f"refine{i}", conv(fpn_channels, fpn_channels, (3, 3), dtype=dtype))
            self.add_module(f"GroupNorm_{i}", group_norm(fpn_channels, dtype))
            if use_mhc:
                self.add_module(f"mhc{i}", ManifoldHyperConnection(
                    fpn_channels, 1, 1, dtype=dtype, dropout_rate=dropout_rate, **mhc))
            self.add_module(f"out{i}", conv(fpn_channels, out_ch, (1, 1), dtype=dtype))
        sites = tuple(f"{kind}{i}_scale" for kind in ("lat", "td", "y") for i in range(3))
        self._init_quant(sites, sites if act_quant else ())

    def _conv(self, name: str, x: torch.Tensor, site: str) -> torch.Tensor:
        if self.act_quant:
            scale = self.act_scale(site)
            return getattr(self, name)(quantize_tensor(x, scale), scale)
        self.record(site, x)
        return getattr(self, name)(x)

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        laterals = [self._conv(f"lateral{i}", features[k].to(self.dtype), f"lat{i}_scale")
                    for i, k in enumerate(SCALES)]
        td2 = laterals[2]
        td1 = laterals[1] + upsample2x(td2)
        td0 = laterals[0] + upsample2x(td1)
        outputs = {}
        for i, (name, td) in enumerate(zip(OUT_NAMES, (td0, td1, td2))):
            y = self._conv(f"refine{i}", td, f"td{i}_scale")
            y = silu_norm(getattr(self, f"GroupNorm_{i}"), y)
            if self.use_mhc:
                y = getattr(self, f"mhc{i}")(y)
            outputs[name] = self._conv(f"out{i}", y, f"y{i}_scale")
        return outputs


class MultiScaleFeatureFusion(nn.Module):
    """The three scales resized (nearest) to ``scale_small``'s grid,
    concatenated, projected by a 1x1 convolution (``Conv_0``, no bias) to
    ``out_channels``, then GroupNorm (``GroupNorm_0``) and SiLU: one map."""

    def __init__(self, in_channels: Sequence[int] = (128, 256, 512), out_channels: int = 256,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(sum(in_channels), out_channels, (1, 1), use_bias=False, dtype=dtype)
        self.GroupNorm_0 = group_norm(out_channels, dtype)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        small = features["scale_small"].to(self.dtype)
        maps = [small] + [resize_nearest(features[k].to(self.dtype), small.shape[1:3])
                          for k in SCALES[1:]]
        return silu_norm(self.GroupNorm_0, self.Conv_0(torch.cat(maps, dim=-1)))


class CrossScaleAttention(nn.Module):
    """Each scale projected by a 1x1 convolution (``proj_<scale>``) to
    ``channels`` and averaged to a summary vector (fp32 mean); attention with
    ``num_heads`` heads over the three summaries (``q``, ``k``, ``v``; fp32
    softmax); each attended summary gates its projected map channel-wise
    through ``gate_<scale>`` and a sigmoid. Returns the gated maps by scale."""

    def __init__(self, in_channels: Sequence[int] = (128, 256, 512), channels: int = 256,
                 num_heads: int = 4, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        for k, c in zip(SCALES, in_channels):
            self.add_module(f"proj_{k}", Conv(c, channels, (1, 1), use_bias=False, dtype=dtype))
        for name in ("q", "k", "v"):
            self.add_module(name, Dense(channels, channels, dtype=dtype))
        for k in SCALES:
            self.add_module(f"gate_{k}", Dense(channels, channels, dtype=dtype))

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        projected = {k: getattr(self, f"proj_{k}")(features[k].to(self.dtype)) for k in SCALES}
        s = torch.stack([projected[k].float().mean(dim=(1, 2)) for k in SCALES],
                        dim=1).to(self.dtype)  # [B, 3, C]
        out = attend(self.q(s), self.k(s), self.v(s), self.num_heads, self.dtype)
        return {k: projected[k] * torch.sigmoid(getattr(self, f"gate_{k}")(out[:, i]))[
            :, None, None, :] for i, k in enumerate(SCALES)}


class AdaptiveFeatureFusion(nn.Module):
    """Each scale projected by a 1x1 convolution (``proj_<scale>``) to
    ``out_channels`` and resized (nearest) to ``scale_small``'s grid, then
    summed with the softmax of the learned ``scale_weights`` (zeros at init:
    an equal blend). The weighted sum is a contraction over the 3 scales, so
    it is taken in fp32 and rounded to ``dtype`` once, as XLA's dot does."""

    def __init__(self, in_channels: Sequence[int] = (128, 256, 512), out_channels: int = 256,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        for k, c in zip(SCALES, in_channels):
            self.add_module(f"proj_{k}", Conv(c, out_channels, (1, 1), use_bias=False,
                                              dtype=dtype))
        self.scale_weights = nn.Parameter(torch.zeros(len(SCALES)))

    def reset_parameters(self, g) -> None:
        nn.init.zeros_(self.scale_weights)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        size = features["scale_small"].shape[1:3]
        maps = []
        for k in SCALES:
            f = getattr(self, f"proj_{k}")(features[k].to(self.dtype))
            maps.append(f if f.shape[1:3] == size else resize_nearest(f, size))
        w = torch.softmax(self.scale_weights, dim=0).to(self.dtype).float()
        return torch.einsum("s,sbhwc->bhwc", w, torch.stack(maps).float()).to(self.dtype)
