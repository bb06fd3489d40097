"""Hybrid CNN backbone with channel-wise mHC, NHWC at every boundary.

Counterpart of ``hvs_tpu/models/backbone.py`` (``ConvMHCBlock`` with the
standard and the fused serve tail, ``HybridVisionBackbone``, and their int8
paths through ``QuantConv``, ``models/layers.py``).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import dequantize_tensor, quantize_tensor
from .layers import Conv, ManifoldHyperConnection, QuantConv, QuantSites, SqueezeExcite, \
    group_norm


class ConvMHCBlock(QuantSites, nn.Module):
    """Bottleneck residual block: 1x1 reduce -> 3x3 (optionally strided) ->
    channel mHC at the bottleneck width -> 1x1 expand -> tail.

    Standard tail (training, and any forward of a model that computes its
    constraints per forward): GroupNorm -> SE gate -> + shortcut (GroupNorm
    when projected) -> SiLU, rounding to ``dtype`` after each step as JAX's.

    Fused serve tail (serve constraints, eval mode): folds GroupNorm, the SE
    gate, the shortcut and SiLU into one elementwise pass over the expanded
    map: GroupNorm is ``y*s + t`` once its statistics are known, the SE input
    is the spatial mean of that map (``ch_mean*s + t``), and the SE gate is
    per channel, so the tail is ``silu(y*(s*g) + t*g + shortcut)``.

    int8 (``act_quant``): the four convolutions are ``QuantConv``s. The block
    input is quantized once (site ``x_scale``) and shared by ``reduce``, the
    projection ``shortcut`` and, dequantized, the identity shortcut;
    ``spatial`` reads ``y1_scale`` and ``expand`` ``y2_scale``; the tail is
    the standard one. ``act_quant_mhc`` puts the mHC layer on its int8
    chain. A float block records its three sites while calibrating, and
    then takes the standard tail.

    ``bottleneck_ratio``, ``use_mhc`` and ``use_se`` as JAX's: the bottleneck
    width is ``max(16, int(channels * bottleneck_ratio))``; without the mHC
    layer (``use_mhc=False``; the block then holds no ``mhc`` parameters)
    the bottleneck map goes straight to ``expand``; without SE the tail has
    no gate (g = 1 in the fold). A GroupNorm replaced by ``nn.Identity``
    after construction (an ablation) folds as s = 1, t = 0 and computes no
    statistics. ``mhc`` are keyword options of the mHC layer (``sk_iters``,
    ``monitor``, ``precomputed_constraints``); its dropout rate is
    ``dropout_rate``.
    """

    SITES = ("x_scale", "y1_scale", "y2_scale")

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16, dropout_rate: float = 0.0,
                 act_quant: bool = False, act_quant_mhc: bool = False,
                 bottleneck_ratio: float = 0.5, use_mhc: bool = True, use_se: bool = True,
                 **mhc):
        super().__init__()
        mid = max(16, int(channels * bottleneck_ratio))  # bottleneck width
        self.dtype = dtype
        self.act_quant = act_quant
        self.precomputed_constraints = mhc.get("precomputed_constraints", False)
        conv = QuantConv if act_quant else partial(Conv, use_bias=False)
        self.reduce = conv(in_channels, mid, (1, 1), dtype=dtype)
        self.GroupNorm_0 = group_norm(mid, dtype)
        self.spatial = conv(mid, mid, (3, 3), (stride, stride), dtype=dtype)
        self.GroupNorm_1 = group_norm(mid, dtype)
        self.mhc = (ManifoldHyperConnection(mid, 1, 1, dtype=dtype, dropout_rate=dropout_rate,
                                            act_quant=act_quant_mhc, quant_sites=True, **mhc)
                    if use_mhc else None)
        self.expand = conv(mid, channels, (1, 1), dtype=dtype)
        self.GroupNorm_2 = group_norm(channels, dtype)
        self.se = SqueezeExcite(channels, dtype=dtype) if use_se else None
        if stride != 1 or in_channels != channels:
            self.shortcut = conv(in_channels, channels, (1, 1), (stride, stride), dtype=dtype)
            self.GroupNorm_3 = group_norm(channels, dtype)
        else:
            self.shortcut = None
        self._init_quant(self.SITES, self.SITES if act_quant else ())

    def _mhc(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.mhc is None else self.mhc(y)

    def _se(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.se is None else self.se(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.act_quant:
            return self._forward_int8(x)
        self.record("x_scale", x)
        y = F.silu(self.GroupNorm_0(self.reduce(x)))
        self.record("y1_scale", y)
        y = F.silu(self.GroupNorm_1(self.spatial(y)))
        y = self._mhc(y)
        self.record("y2_scale", y)
        y = self.expand(y)
        if not (self.precomputed_constraints and not self.training) or self.calibrating:
            shortcut = x if self.shortcut is None else self.GroupNorm_3(self.shortcut(x))
            return F.silu(self._se(self.GroupNorm_2(y)) + shortcut)

        y32 = y.float()
        s = t = ch_mean = None
        if not isinstance(self.GroupNorm_2, nn.Identity):
            ch_mean = y32.mean(dim=(1, 2))
            s, t = self.GroupNorm_2.affine_from_channel_stats(
                ch_mean, y32.square().mean(dim=(1, 2)))
        if self.se is not None:
            if ch_mean is None:
                ch_mean = y32.mean(dim=(1, 2))
            pooled = ch_mean if s is None else ch_mean * s + t  # mean of the normalized map
            g = self.se(pooled=pooled.to(self.dtype), return_gates=True).float()
            s, t = (g, None) if s is None else (s * g, t * g)
        out = y32 if s is None else y32 * s[:, None, None, :]
        if t is not None:
            out = out + t[:, None, None, :]
        if self.shortcut is None:
            out = out + x.float()
        elif isinstance(self.GroupNorm_3, nn.Identity):
            out = out + self.shortcut(x).float()
        else:
            sc32 = self.shortcut(x).float()
            s2, t2 = self.GroupNorm_3.affine_from_channel_stats(
                sc32.mean(dim=(1, 2)), sc32.square().mean(dim=(1, 2)))
            out = out + sc32 * s2[:, None, None, :] + t2[:, None, None, :]
        return F.silu(out).to(self.dtype)

    def _forward_int8(self, x: torch.Tensor) -> torch.Tensor:
        x_s, y1_s, y2_s = (self.act_scale(site) for site in self.SITES)
        x_q = quantize_tensor(x, x_s)
        y = F.silu(self.GroupNorm_0(self.reduce(x_q, x_s)))
        y = F.silu(self.GroupNorm_1(self.spatial(quantize_tensor(y, y1_s), y1_s)))
        y = self._mhc(y)
        y = self.expand(quantize_tensor(y, y2_s), y2_s)
        if self.shortcut is not None:
            shortcut = self.GroupNorm_3(self.shortcut(x_q, x_s))
        else:
            shortcut = dequantize_tensor(x_q, x_s, self.dtype)
        return F.silu(self._se(self.GroupNorm_2(y)) + shortcut)


class HybridVisionBackbone(QuantSites, nn.Module):
    """Stem (two stride-2 convs) and four stages of ``ConvMHCBlock``.

    [B, H, W, 3] -> {"scale_small": stride 8, "scale_medium": stride 16,
    "scale_large": stride 32}, with stage_channels[1:] channels. With
    ``act_quant`` ``stem2`` takes its input in int8 (site ``stem2_scale``;
    ``stem1``'s 3 input channels stay float) and so do the blocks;
    ``act_quant_mhc``, ``use_mhc`` and ``use_se`` go to the blocks.
    """

    SCALE_NAMES = {1: "scale_small", 2: "scale_medium", 3: "scale_large"}

    def __init__(self, base_channels: int = 32, stage_blocks: Sequence[int] = (2, 3, 4, 2),
                 stage_channels: Sequence[int] = (64, 128, 256, 512),
                 dtype: torch.dtype = torch.bfloat16, act_quant: bool = False,
                 act_quant_mhc: bool = False, use_mhc: bool = True, use_se: bool = True,
                 **mhc):
        super().__init__()
        self.dtype = dtype
        self.act_quant = act_quant
        self.stage_channels = tuple(stage_channels)
        self.stem1 = Conv(3, base_channels, (3, 3), (2, 2), use_bias=False, dtype=dtype)
        self.GroupNorm_0 = group_norm(base_channels, dtype)
        conv = QuantConv if act_quant else partial(Conv, use_bias=False)
        self.stem2 = conv(base_channels, stage_channels[0], (3, 3), (2, 2), dtype=dtype)
        self.GroupNorm_1 = group_norm(stage_channels[0], dtype)
        self.stages = []  # per stage: the block names, in order
        in_ch = stage_channels[0]
        for stage_idx, (n_blocks, ch) in enumerate(zip(stage_blocks, stage_channels)):
            names = []
            for block_idx in range(n_blocks):
                stride = 2 if (block_idx == 0 and stage_idx > 0) else 1
                name = f"stage{stage_idx + 1}_block{block_idx}"
                self.add_module(name, ConvMHCBlock(in_ch, ch, stride, dtype=dtype,
                                                   act_quant=act_quant,
                                                   act_quant_mhc=act_quant_mhc,
                                                   use_mhc=use_mhc, use_se=use_se, **mhc))
                names.append(name)
                in_ch = ch
            self.stages.append(names)
        self._init_quant(("stem2_scale",), ("stem2_scale",) if act_quant else ())

    def get_output_channels(self) -> Dict[str, int]:
        """Channels of each output scale."""
        return {name: self.stage_channels[i] for i, name in self.SCALE_NAMES.items()}

    @staticmethod
    def compute_flops(input_size: Tuple[int, int] = (416, 416)) -> int:
        """JAX's rough count of the flagship backbone's convolution FLOPs at
        ``input_size``, from its fixed architecture (stem, then 2/3/4/2
        bottlenecks at 64/128/256/512 channels), whatever this instance's
        widths."""
        h, w = input_size
        flops = 2 * (h // 2) * (w // 2) * 3 * 32 * 9
        flops += 2 * (h // 4) * (w // 4) * 32 * 64 * 9
        for s, c, n in zip((4, 8, 16, 32), (64, 128, 256, 512), (2, 3, 4, 2)):
            mid = c // 2
            flops += (h // s) * (w // s) * (c * mid + mid * mid * 9 + mid * c) * 2 * n
        return flops

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.silu(self.GroupNorm_0(self.stem1(x.to(self.dtype))))
        if self.act_quant:
            scale = self.act_scale("stem2_scale")
            x = self.stem2(quantize_tensor(x, scale), scale)
        else:
            self.record("stem2_scale", x)
            x = self.stem2(x)
        x = F.silu(self.GroupNorm_1(x))
        outputs = {}
        for stage_idx, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if stage_idx in self.SCALE_NAMES:
                outputs[self.SCALE_NAMES[stage_idx]] = x
        return outputs
