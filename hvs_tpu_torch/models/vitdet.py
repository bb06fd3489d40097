"""ViTDet: a plain ViT backbone with windowed and global attention and
decomposed relative positions, its simple feature pyramid, and the port's
YOLO head on the pyramid.

Li, Mao, Girshick, He, "Exploring Plain Vision Transformer Backbones for
Object Detection" (arXiv:2203.16527); detectron2
``modeling/backbone/vit.py`` (``ViT``, ``Block``, ``Attention``,
``add_decomposed_rel_pos``, ``get_abs_pos``, ``window_partition``,
``window_unpartition``, ``SimpleFeaturePyramid``). A model of the port alone:
the JAX package has no counterpart.

NHWC maps throughout. The backbone: a p x p patch embedding (stride p, with
bias), an absolute position embedding pretrained on a ``pretrain_grid``²
grid with a cls row (the row is dropped and the grid interpolated
bicubically, ``align_corners=False``, in fp32 at every forward, as two
products with ``bicubic_matrix``), then
``depth`` pre-norm blocks: LayerNorm (eps 1e-6), attention over 14 x 14
windows (the map zero-padded at the bottom and right, padded keys attended
like any other, padded outputs cropped after the projection) or over the
whole map, the residual; LayerNorm, an MLP with exact (erf) GELU, the
residual. No final norm. Attention adds ViTDet's decomposed relative
positions: ``(q / 8) . k + rel_h[t, ky] + rel_w[t, kx]``, with ``rel_h`` and
``rel_w`` the unscaled query's products with a (2·side - 1) x 64 table per
axis (``ops/relpos_attention.py``). A CUDA map with autograd off takes
``hvs::relpos_attention_tables``, the Hopper kernel, which computes the
terms from q and the tables itself; every other map makes them first
(``relative_terms``) and attends with the plain version, through
``hvs::relpos_attention`` with autograd off. The global tables are sized
from the input, so a model serves one input size.

Linear layers and LayerNorms compute as detectron2's ``nn.Linear`` and
``nn.LayerNorm`` do (``Linear``, ``TorchLayerNorm``: the bias added in the
product's epilogue, two-pass statistics, one kernel each), on the
parameters of the port's ``Dense`` and ``LayerNorm`` (which follow flax's:
a separate bias add, E[x²] - E[x]², for the hybrid's parity with JAX).

The pyramid, from the stride-16 map, one level per scale of
``pyramid_scales``: a transposed 2 x 2 convolution (stride 8), the map
itself (16) or a 2 x 2 max-pool (32); then a 1 x 1 and a 3 x 3 convolution
without bias, each followed by a channel LayerNorm (eps 1e-6). Its maps are
the YOLO head's ``fused_small``, ``fused_medium`` and ``fused_large``.
Drop-path (0.1 in ViTDet's training) is not built: the port serves this
model.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, device_constant, resolve_device
from ..ops import relpos_attention as rp
from ..ops.relpos_attention import relative_terms
from .layers import Conv, Dense, Generator, LayerNorm, init_weights, lecun_normal_
from .yolo_head import NUM_ANCHORS, SCALE_ORDER, YOLODetectionHead

POS_STD = 0.02  # detectron2's trunc_normal_ init of the position embedding and tables


def _trunc_normal_(t: torch.Tensor, std: float, g: Generator) -> None:
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


class Linear(Dense):
    """``nn.Linear``'s function on ``Dense``'s parameters (kernel [in, out]):
    ``F.linear`` in ``dtype``, its bias added in the product's epilogue."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.kernel.to(dt).t(), self.bias.to(dt))


class TorchLayerNorm(LayerNorm):
    """``nn.LayerNorm``'s function (eps 1e-6) on ``LayerNorm``'s parameters:
    ``F.layer_norm`` in ``dtype`` (fp32 statistics inside, one pass over
    the map)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.layer_norm(x.to(dt), self.scale.shape, self.scale.to(dt), self.bias.to(dt),
                            self.epsilon)


def bicubic_matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """[n_out, n_in]: ``F.interpolate(mode="bicubic", align_corners=False)``
    along one axis as a matrix (the resize is linear and separable), kept on
    ``device``. Two products with it resize the position grid: PyTorch's
    bicubic kernel took 2.4 ms a b16 forward on an H100 for the 14² x 768
    grid."""
    return device_constant(("bicubic", n_in, n_out), device, lambda: F.interpolate(
        torch.eye(n_in)[None, :, :, None], size=(n_out, 1), mode="bicubic",
        align_corners=False)[0, :, :, 0].T.tolist())


def window_partition(x: torch.Tensor, window: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """[B, H, W, C] -> [B·nh·nw, window, window, C], the map zero-padded at
    the bottom and right to multiples of ``window``; also the padded (H, W)."""
    b, h, w, c = x.shape
    ph, pw = -h % window, -w % window
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // window, window, wp // window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window, window, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, window: int, padded: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    """The inverse of ``window_partition``, the padding cropped (a view)."""
    hp, wp = padded
    b = windows.shape[0] // (hp // window * wp // window)
    x = windows.view(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :hw[0], :hw[1]]


class RelPosAttention(nn.Module):
    """Multi-head attention over a [N, kh, kw, C] map with decomposed
    relative positions; ``grid`` is the side its tables serve (the window,
    or the whole map), ``windowed`` which kind it is (the kernel's
    counters)."""

    def __init__(self, dim: int, num_heads: int, grid: int, windowed: bool,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads, self.windowed = num_heads, windowed
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.rel_pos_h = nn.Parameter(torch.empty(2 * grid - 1, dim // num_heads))
        self.rel_pos_w = nn.Parameter(torch.empty(2 * grid - 1, dim // num_heads))

    def reset_parameters(self, g: Generator) -> None:
        _trunc_normal_(self.rel_pos_h, POS_STD, g)
        _trunc_normal_(self.rel_pos_w, POS_STD, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, kh, kw, c = x.shape
        q, k, v = self.qkv(x).view(n, kh, kw, 3, self.num_heads, -1).unbind(3)
        if q.is_cuda and not torch.is_grad_enabled():
            out = rp.relpos_attention_tables(q, k, v, self.rel_pos_h, self.rel_pos_w,
                                             self.windowed)
        else:
            rel_h, rel_w = relative_terms(q, self.rel_pos_h, self.rel_pos_w)
            attend = rp.relpos_attention_plain if torch.is_grad_enabled() else rp.relpos_attention
            out = attend(q, k, v, rel_h, rel_w, self.windowed)
        return self.proj(out.view(n, kh, kw, c))


class ViTDetBlock(nn.Module):
    """Pre-norm transformer block over the [B, H, W, C] map; ``window`` > 0
    attends within windows of that side, 0 over the whole ``grid``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int, window: int, grid: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.window = window
        self.norm1 = TorchLayerNorm(dim, dtype=dtype)
        self.attn = RelPosAttention(dim, num_heads, window or grid, window > 0, dtype=dtype)
        self.norm2 = TorchLayerNorm(dim, dtype=dtype)
        self.fc1 = Linear(dim, dim * mlp_ratio, dtype=dtype)
        self.fc2 = Linear(dim * mlp_ratio, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        if self.window:
            hw = y.shape[1:3]
            y, padded = window_partition(y, self.window)
            y = window_unpartition(self.attn(y), self.window, padded, hw)
        else:
            y = self.attn(y)
        x = x + y
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class ViTDetBackbone(nn.Module):
    """Patch embedding, the interpolated absolute positions and the blocks;
    returns the stride-``patch_size`` map [B, grid, grid, dim]."""

    def __init__(self, input_size: int, patch_size: int, dim: int, depth: int, num_heads: int,
                 mlp_ratio: int, window_size: int, window_block_indexes: Sequence[int],
                 pretrain_grid: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if input_size % patch_size:
            raise ValueError(f"input_size {input_size} is not a multiple of the patch "
                             f"{patch_size}")
        self.dtype = dtype
        self.grid = input_size // patch_size
        self.patch_embed = Conv(3, dim, (patch_size, patch_size), (patch_size, patch_size),
                                dtype=dtype)
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + pretrain_grid ** 2, dim))
        for i in range(depth):
            window = window_size if i in window_block_indexes else 0
            self.add_module(f"block{i}", ViTDetBlock(dim, num_heads, mlp_ratio, window,
                                                     self.grid, dtype=dtype))
        self.depth = depth

    def reset_parameters(self, g: Generator) -> None:
        _trunc_normal_(self.pos_embed, POS_STD, g)

    def abs_pos(self) -> torch.Tensor:
        """The position embedding without its cls row, resized bicubically
        to the map's grid: [1, grid, grid, dim], fp32."""
        pos = self.pos_embed[:, 1:].float()
        side = math.isqrt(pos.shape[1])
        pos = pos.reshape(side, side, -1)
        if side != self.grid:
            m = bicubic_matrix(side, self.grid, pos.device)
            pos = torch.einsum("xj,yjc->yxc", m, torch.einsum("yi,ixc->yxc", m, pos))
        return pos[None]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(images)
        if x.shape[1:3] != (self.grid, self.grid):
            raise ValueError(f"this ViTDet serves a {self.grid} x {self.grid} patch grid (its "
                             f"global tables are sized from its input), got "
                             f"{tuple(x.shape[1:3])}")
        x = (x.float() + self.abs_pos()).to(self.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return x


class ConvTranspose2x2(nn.Module):
    """``nn.ConvTranspose2d(in, out, 2, stride=2)`` on NHWC maps: each pixel
    becomes a 2 x 2 block. The kernel is torch's [in, out, 2, 2]."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features, 2, 2))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, g: Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], g)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.to(self.dtype).permute(0, 3, 1, 2), self.kernel.to(self.dtype),
                               self.bias.to(self.dtype), stride=2)
        return y.permute(0, 2, 3, 1)


class PyramidLevel(nn.Module):
    """One level of the simple pyramid: ``scale`` 2 (transposed 2 x 2
    convolution to dim / 2), 1 (the map) or 0.5 (2 x 2 max-pool), then a
    1 x 1 and a 3 x 3 convolution without bias, each with a channel
    LayerNorm."""

    def __init__(self, dim: int, scale: float, channels: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if scale not in (2.0, 1.0, 0.5):
            raise ValueError(f"pyramid scale {scale}: the port builds 2, 1 and 0.5 (strides "
                             f"8, 16 and 32, the levels its head reads)")
        self.scale = scale
        if scale == 2.0:
            self.up = ConvTranspose2x2(dim, dim // 2, dtype=dtype)
            dim //= 2
        self.lateral = Conv(dim, channels, (1, 1), use_bias=False, dtype=dtype)
        self.lateral_norm = TorchLayerNorm(channels, dtype=dtype)
        self.output = Conv(channels, channels, (3, 3), use_bias=False, dtype=dtype)
        self.output_norm = TorchLayerNorm(channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.scale == 2.0:
            x = self.up(x)
        elif self.scale == 0.5:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        x = self.lateral_norm(self.lateral(x))
        return self.output_norm(self.output(x))


class ViTDetDetector(nn.Module):
    """ViTDet's backbone and simple pyramid with the port's YOLO head on
    its three levels (``detection_head.head_fused_small``, ``_medium``,
    ``_large`` at strides 8, 16 and 32), on normalised NHWC images of
    ``input_size``². ``forward`` returns ``{"detection": the head's outputs,
    "fused_features": the pyramid's maps}``, what ``hybrid.detect`` and the
    serving engine read; it has no global-feature head. ``sk_iters``,
    ``monitor`` and ``precomputed_constraints`` go to the head's mHC layers
    (their constraints computed at load when serving). Seeded init on
    ``device``, as ``HybridVisionSystem``'s."""

    def __init__(self, input_size: int = 1024, patch_size: int = 16, dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: int = 4,
                 window_size: int = 14,
                 window_block_indexes: Sequence[int] = (0, 1, 3, 4, 6, 7, 9, 10),
                 pretrain_grid: int = 14, pyramid_scales: Sequence[float] = (2.0, 1.0, 0.5),
                 pyramid_channels: int = 256, num_classes: int = 80,
                 num_anchors: int = NUM_ANCHORS, head_channels: int = 256, sk_iters: int = 20,
                 monitor: bool = False, precomputed_constraints: bool = True,
                 dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None, seed: int = 0):
        super().__init__()
        if len(pyramid_scales) != len(SCALE_ORDER):
            raise ValueError(f"the head reads {len(SCALE_ORDER)} levels, got pyramid scales "
                             f"{tuple(pyramid_scales)}")
        device = resolve_device(device)
        self.dtype = dtype
        self.input_size = input_size
        self.backbone = ViTDetBackbone(input_size, patch_size, dim, depth, num_heads, mlp_ratio,
                                       window_size, window_block_indexes, pretrain_grid,
                                       dtype=dtype)
        self.pyramid = nn.ModuleDict({
            f"simfp_{int(math.log2(patch_size / s))}": PyramidLevel(dim, s, pyramid_channels,
                                                                     dtype=dtype)
            for s in pyramid_scales})
        self.detection_head = YOLODetectionHead(
            (pyramid_channels,) * len(SCALE_ORDER), num_classes, head_channels, dtype=dtype,
            num_anchors=num_anchors, sk_iters=sk_iters, monitor=monitor,
            precomputed_constraints=precomputed_constraints)
        init_weights(self, seed)
        self.to(device)

    def features(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The pyramid's maps by the head's scale names, fine to coarse."""
        x = self.backbone(images)
        maps: List[torch.Tensor] = [level(x) for level in self.pyramid.values()]
        return dict(zip(SCALE_ORDER, maps))

    def forward(self, images: torch.Tensor) -> Dict[str, object]:
        fused = self.features(images)
        return {"detection": self.detection_head(fused), "fused_features": fused}
