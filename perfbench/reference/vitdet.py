"""Plain reference of the ViTDet detector: the serve path from raw camera
frames to per-frame detections, in fp32 plain PyTorch.

It follows the published backbone and pyramid (Li, Mao, Girshick, He,
arXiv:2203.16527; detectron2 ``modeling/backbone/vit.py``: ``ViT``,
``Block``, ``Attention``, ``add_decomposed_rel_pos``, ``get_rel_pos``,
``get_abs_pos``, ``window_partition``, ``window_unpartition``;
``SimpleFeaturePyramid``), written here again from that description, in
detectron2's own order of operations: a patch embedding, the absolute
position embedding without its cls row interpolated bicubically to the
grid, pre-norm blocks with attention over zero-padded 14 x 14 windows or
over the whole grid and ``attn = (q * scale) @ k^T + rel_h + rel_w`` from
the unscaled q, exact GELU, no final norm; the pyramid's levels by a
transposed 2 x 2 convolution, the map, a 2 x 2 max-pool, each then a 1 x 1
and a 3 x 3 convolution without bias with a channel LayerNorm.

Departures from the published detector, as the benchmark's configuration
records them: the head is the HumanoidVision YOLO head of ``hybrid.py``
(its towers with GroupNorm, SiLU and an mHC layer; anchor decode and
class-aware greedy NMS), not Mask R-CNN's RPN and ROI heads; the pyramid's
stride-4 level and ``p6`` are not built, as no head reads them; frames are
letterboxed as ``hybrid.preprocess`` does (centred, grey 114), not with
LSJ's bottom-right zero pad; no drop-path (serving). Weights come from the
seed, the relative position tables drawn like a dense kernel of fan-in 64
(std 0.125) rather than zero, and the position embedding with std 1/sqrt(2)
(the RMS of the fixed sine-cosine table of the MAE weights ViTDet starts
from) rather than detectron2's 0.02, so that neither mechanism is inert.

Nothing here imports the program under test. Every product, convolution
and relative-position einsum goes through ``hybrid.Precision``: fp32 (TF32
is off in the judge) or, for the control, operands rounded to float8.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import hybrid
from perfbench.reference.hybrid import (SCALES, Precision, box_filter, decode, iou_matrix,
                                        letterbox_geometry, nms, prepare, preprocess,
                                        to_pixels)

__all__ = ["SCALES", "Precision", "Model", "param_spec", "prepare", "preprocess", "decode",
           "nms", "to_pixels", "box_filter", "letterbox_geometry", "iou_matrix"]

Tensor = torch.Tensor


def _levels(cfg) -> List[Tuple[str, float]]:
    """(name, scale) of each pyramid level: ``simfp_<log2 of its stride>``."""
    return [(f"pyramid.simfp_{int(math.log2(cfg['patch_size'] / s))}", s)
            for s in cfg["pyramid_scales"]]


def _window(cfg, i: int) -> int:
    return cfg["window_size"] if i in cfg["window_block_indexes"] else 0


def param_spec(cfg):
    """Every parameter of the model ``cfg`` describes, in the port's names,
    with its init (kinds as ``hybrid.param_spec``'s)."""
    s = hybrid._Spec()
    dim, heads, p = cfg["embed_dim"], cfg["num_heads"], cfg["patch_size"]
    grid = cfg["input_size"] // p
    # std 1/sqrt(2): the RMS of the fixed sine-cosine table ViTDet's MAE weights carry
    s.add("backbone.pos_embed", (1, 1 + cfg["pretrain_grid"] ** 2, dim), "normal", 2)
    s.conv("backbone.patch_embed", 3, dim, p, bias=True)
    hidden = dim * cfg["mlp_ratio"]
    for i in range(cfg["depth"]):
        b = f"backbone.block{i}"
        side = _window(cfg, i) or grid
        s.norm(f"{b}.norm1", dim)
        for axis in ("h", "w"):
            s.add(f"{b}.attn.rel_pos_{axis}", (2 * side - 1, dim // heads), "normal",
                  dim // heads)
        s.dense(f"{b}.attn.qkv", dim, 3 * dim)
        s.dense(f"{b}.attn.proj", dim, dim)
        s.norm(f"{b}.norm2", dim)
        s.dense(f"{b}.fc1", dim, hidden)
        s.dense(f"{b}.fc2", hidden, dim)
    ch = cfg["pyramid_channels"]
    for name, scale in _levels(cfg):
        cin = dim
        if scale == 2.0:
            s.add(f"{name}.up.kernel", (dim, dim // 2, 2, 2), "normal", dim)
            s.add(f"{name}.up.bias", (dim // 2,), "zeros")
            cin = dim // 2
        s.conv(f"{name}.lateral", cin, ch, 1)
        s.norm(f"{name}.lateral_norm", ch)
        s.conv(f"{name}.output", ch, ch, 3)
        s.norm(f"{name}.output_norm", ch)
    h, a, c = cfg["head_channels"], cfg["num_anchors"], cfg["num_classes"]
    for key in SCALES:
        p_ = f"detection_head.head_{key}"
        s.conv(f"{p_}.reduce", ch, h, 1)
        s.norm(f"{p_}.GroupNorm_0", h)
        s.conv(f"{p_}.conv", h, h, 3)
        s.norm(f"{p_}.GroupNorm_1", h)
        s.mhc(f"{p_}.mhc", h, h, h)
        s.conv(f"{p_}.predict", h, a * (5 + c), 1, bias=True, bias_init="predict")
    return s.items


def get_abs_pos(abs_pos: Tensor, hw: Tuple[int, int]) -> Tensor:
    """detectron2's ``get_abs_pos`` with a cls token: [1, h, w, C]."""
    abs_pos = abs_pos[:, 1:]
    size = int(math.sqrt(abs_pos.shape[1]))
    grid = abs_pos.reshape(1, size, size, -1).permute(0, 3, 1, 2)
    if (size, size) != tuple(hw):
        grid = F.interpolate(grid, size=hw, mode="bicubic", align_corners=False)
    return grid.permute(0, 2, 3, 1)


def get_rel_pos(q_size: int, k_size: int, rel_pos: Tensor) -> Tensor:
    """detectron2's ``get_rel_pos`` for a table of 2·max(q, k) - 1 rows (no
    resizing): [q_size, k_size, C]."""
    assert rel_pos.shape[0] == 2 * max(q_size, k_size) - 1
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[relative.long().to(rel_pos.device)]


def window_partition(x: Tensor, window: int):
    b, h, w, c = x.shape
    pad_h = (window - h % window) % window
    pad_w = (window - w % window) % window
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // window, window, wp // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window, window, c), (hp, wp)


def window_unpartition(windows: Tensor, window: int, pad_hw, hw) -> Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window // window)
    x = windows.view(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, hp, wp, -1)
    if hp > h or wp > w:
        x = x[:, :h, :w, :].contiguous()
    return x


class Model(hybrid.Model):
    """The served detector over prepared weights (``prepare``); the head,
    its mHC layers and the convolutions and products are ``hybrid.Model``'s."""

    def attention(self, x: Tensor, name: str) -> Tensor:
        P, prec = self.P, self.prec
        b, h, w, _ = x.shape
        heads = self.cfg["num_heads"]
        qkv = self.dense(x, f"{name}.qkv").reshape(b, h * w, 3, heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * heads, h * w, -1).unbind(0)
        scale = q.shape[-1] ** -0.5
        attn = prec.mm(q * scale, k.transpose(-2, -1))
        rh = get_rel_pos(h, h, P[f"{name}.rel_pos_h"])
        rw = get_rel_pos(w, w, P[f"{name}.rel_pos_w"])
        r_q = prec.q(q).reshape(b * heads, h, w, -1)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, prec.q(rh))
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, prec.q(rw))
        attn = (attn.view(b * heads, h, w, h, w) + rel_h[:, :, :, :, None]
                + rel_w[:, :, :, None, :]).view(b * heads, h * w, h * w)
        out = prec.mm(attn.softmax(dim=-1), v)
        out = out.view(b, heads, h, w, -1).permute(0, 2, 3, 1, 4).reshape(b, h, w, -1)
        return self.dense(out, f"{name}.proj")

    def block(self, x: Tensor, i: int) -> Tensor:
        P, p = self.P, f"backbone.block{i}"
        shortcut = x
        x = hybrid.layer_norm(x, P[f"{p}.norm1.scale"], P[f"{p}.norm1.bias"])
        window = _window(self.cfg, i)
        if window:
            hw = (x.shape[1], x.shape[2])
            x, pad_hw = window_partition(x, window)
        x = self.attention(x, f"{p}.attn")
        if window:
            x = window_unpartition(x, window, pad_hw, hw)
        x = shortcut + x
        y = hybrid.layer_norm(x, P[f"{p}.norm2.scale"], P[f"{p}.norm2.bias"])
        return x + self.dense(F.gelu(self.dense(y, f"{p}.fc1")), f"{p}.fc2")

    def level(self, x: Tensor, name: str, scale: float) -> Tensor:
        P = self.P
        if scale == 2.0:
            w = P[f"{name}.up.kernel"]
            x = F.conv_transpose2d(self.prec.q(x).permute(0, 3, 1, 2), self.prec.q(w),
                                   P[f"{name}.up.bias"], stride=2).permute(0, 2, 3, 1)
        elif scale == 0.5:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        for part in ("lateral", "output"):
            x = hybrid.layer_norm(self.conv(x, f"{name}.{part}"), P[f"{name}.{part}_norm.scale"],
                                  P[f"{name}.{part}_norm.bias"])
        return x

    def raw(self, images: Tensor) -> List[Tensor]:
        """Normalised NHWC images -> the YOLO logits [B, H, W, A, 5 + C] per
        scale, fine to coarse."""
        x = self.conv(images, "backbone.patch_embed", self.cfg["patch_size"])
        x = x + get_abs_pos(self.P["backbone.pos_embed"], (x.shape[1], x.shape[2]))
        for i in range(self.cfg["depth"]):
            x = self.block(x, i)
        maps = [self.level(x, name, scale) for name, scale in _levels(self.cfg)]
        return [self.head(m, key) for m, key in zip(maps, SCALES)]
