"""Top-down FPN with an mHC layer per level (NHWC).

Counterpart of ``hvs_tpu/models/fpn.py`` (``upsample2x``,
``FeaturePyramidNetwork`` with its int8 sites). The fusion variants there
are not ported yet.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import quantize_tensor
from .layers import Conv, ManifoldHyperConnection, QuantConv, QuantSites, group_norm

SCALES = ("scale_small", "scale_medium", "scale_large")
OUT_NAMES = ("fused_small", "fused_medium", "fused_large")
OUT_CHANNELS = (256, 512, 1024)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NHWC map (a repeat of each pixel)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class FeaturePyramidNetwork(QuantSites, nn.Module):
    """1x1 laterals to ``fpn_channels``, top-down nearest upsample + add, a 3x3
    refine, GroupNorm + SiLU, a channel mHC per level, and 1x1 projections to
    ``OUT_CHANNELS``. Input: the backbone's three scales. ``mhc`` are keyword
    options of the mHC layers (their dropout rate is ``dropout_rate``, 0 as in
    JAX).

    ``act_quant`` (the JAX model's ``act_quant_fpn``): ``lateral{i}``,
    ``refine{i}`` and ``out{i}`` take int8 inputs (sites ``lat{i}_scale``,
    ``td{i}_scale``, ``y{i}_scale``); the top-down adds and the mHC layers
    stay bf16, as in JAX."""

    def __init__(self, in_channels: Sequence[int] = (128, 256, 512), fpn_channels: int = 256,
                 dtype: torch.dtype = torch.bfloat16, dropout_rate: float = 0.0,
                 act_quant: bool = False, **mhc):
        super().__init__()
        self.dtype = dtype
        self.act_quant = act_quant
        conv = QuantConv if act_quant else partial(Conv, use_bias=False)
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", conv(c, fpn_channels, (1, 1), dtype=dtype))
        for i, out_ch in enumerate(OUT_CHANNELS):
            self.add_module(f"refine{i}", conv(fpn_channels, fpn_channels, (3, 3), dtype=dtype))
            self.add_module(f"GroupNorm_{i}", group_norm(fpn_channels, dtype))
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
            y = getattr(self, f"mhc{i}")(F.silu(getattr(self, f"GroupNorm_{i}")(y)))
            outputs[name] = self._conv(f"out{i}", y, f"y{i}_scale")
        return outputs
