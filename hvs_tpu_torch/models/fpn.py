"""Top-down FPN with an mHC layer per level (NHWC).

Counterpart of ``hvs_tpu/models/fpn.py`` (``upsample2x``,
``FeaturePyramidNetwork``). The fusion variants there are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, ManifoldHyperConnection, group_norm

SCALES = ("scale_small", "scale_medium", "scale_large")
OUT_NAMES = ("fused_small", "fused_medium", "fused_large")
OUT_CHANNELS = (256, 512, 1024)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NHWC map (a repeat of each pixel)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class FeaturePyramidNetwork(nn.Module):
    """1x1 laterals to ``fpn_channels``, top-down nearest upsample + add, a 3x3
    refine, GroupNorm + SiLU, a channel mHC per level, and 1x1 projections to
    ``OUT_CHANNELS``. Input: the backbone's three scales. ``mhc`` are keyword
    options of the mHC layers (their dropout rate is ``dropout_rate``, 0 as in
    JAX)."""

    def __init__(self, in_channels: Sequence[int] = (128, 256, 512), fpn_channels: int = 256,
                 dtype: torch.dtype = torch.bfloat16, dropout_rate: float = 0.0, **mhc):
        super().__init__()
        self.dtype = dtype
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", Conv(c, fpn_channels, (1, 1), use_bias=False,
                                                dtype=dtype))
        for i, out_ch in enumerate(OUT_CHANNELS):
            self.add_module(f"refine{i}", Conv(fpn_channels, fpn_channels, (3, 3),
                                               use_bias=False, dtype=dtype))
            self.add_module(f"GroupNorm_{i}", group_norm(fpn_channels, dtype))
            self.add_module(f"mhc{i}", ManifoldHyperConnection(
                fpn_channels, 1, 1, dtype=dtype, dropout_rate=dropout_rate, **mhc))
            self.add_module(f"out{i}", Conv(fpn_channels, out_ch, (1, 1), use_bias=False,
                                            dtype=dtype))

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        laterals = [getattr(self, f"lateral{i}")(features[k].to(self.dtype))
                    for i, k in enumerate(SCALES)]
        td2 = laterals[2]
        td1 = laterals[1] + upsample2x(td2)
        td0 = laterals[0] + upsample2x(td1)
        outputs = {}
        for i, (name, td) in enumerate(zip(OUT_NAMES, (td0, td1, td2))):
            y = getattr(self, f"refine{i}")(td)
            y = getattr(self, f"mhc{i}")(F.silu(getattr(self, f"GroupNorm_{i}")(y)))
            outputs[name] = getattr(self, f"out{i}")(y)
        return outputs
