"""Plain reference of the HumanoidVision detector: the serve path from raw
camera frames to per-frame detections, in fp32 plain PyTorch.

It follows the published model (nazimurahman/humanoid-vision-system,
``src/models/hybrid_vision.py``): a CNN backbone of bottleneck blocks whose
bottleneck is a channel mHC layer, an optional ViT on the coarsest map, a
top-down FPN with an mHC layer per level, YOLO towers with an mHC layer
each, anchor decode and class-aware greedy NMS. An mHC layer is
``LN2(x @ H_res + MLP(LN1(x) @ H_pre) @ H_post)`` with ``H_pre =
sigmoid(H_pre_raw)``, ``H_post = 2 sigmoid(H_post_raw)`` and ``H_res`` the
log-domain Sinkhorn projection of ``H_res_raw``.

Nothing here imports the program under test. Weights arrive as a dict
{dotted name: tensor} whose names are those of ``param_spec``; everything
derived from them (the constrained matrices, the folded first product) is
worked out here again by ``prepare``. Every product and convolution goes
through ``Precision``: fp32 with TF32 off for the reference, or its
operands rounded to float8 (e4m3, one scale per tensor) for the control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Params = Dict[str, Tensor]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
POS_GRID = 13  # side of the ViT's learned position grid
# COCO anchors in pixels at a 416 input, fine to coarse, and the grid sides
# they were set at; at another input they keep their pixel size.
ANCHORS_416 = (((10, 13), (16, 30), (33, 23)), ((30, 61), (62, 45), (59, 119)),
               ((116, 90), (156, 198), (373, 326)))
ANCHOR_GRIDS = (52, 26, 13)
WH_CLIP = 4.0
SCALES = ("fused_small", "fused_medium", "fused_large")
FP8_MAX = 448.0


class Precision:
    """How products are computed: ``"fp32"`` (the reference) or ``"fp8"``
    (the control: both operands rounded to e4m3 with a per-tensor scale,
    then multiplied in fp32)."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"precision {mode!r}")
        self.mode = mode

    def q(self, x: Tensor) -> Tensor:
        if self.mode == "fp32":
            return x
        scale = x.abs().amax().clamp(min=1e-12) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        return self.q(a) @ self.q(b)

    def conv(self, x: Tensor, w: Tensor, bias: Optional[Tensor], stride: int) -> Tensor:
        """SAME convolution of NHWC ``x`` with an OIHW kernel, padded as XLA
        pads it (the extra pixel at the high end)."""
        k = w.shape[-1]
        pads = []
        for size in (x.shape[2], x.shape[1]):
            out = -(-size // stride)
            total = max((out - 1) * stride + k - size, 0)
            pads += [total // 2, total - total // 2]
        xc = F.pad(self.q(x).permute(0, 3, 1, 2), pads)
        return F.conv2d(xc, self.q(w), bias, stride).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Parameters


def _groups(c: int) -> int:
    g = 8
    while c % g:
        g //= 2
    return g


class _Spec:
    """The parameter list: (name, shape, init, fan) in order."""

    def __init__(self):
        self.items: List[Tuple[str, Tuple[int, ...], str, int]] = []

    def add(self, name, shape, init, fan=0):
        self.items.append((name, tuple(shape), init, fan))

    def conv(self, name, cin, cout, k, bias=False, bias_init="zeros"):
        self.add(f"{name}.kernel", (cout, cin, k, k), "normal", cin * k * k)
        if bias:
            self.add(f"{name}.bias", (cout,), bias_init)

    def norm(self, name, c):
        self.add(f"{name}.scale", (c,), "ones")
        self.add(f"{name}.bias", (c,), "zeros")

    def dense(self, name, din, dout):
        self.add(f"{name}.kernel", (din, dout), "normal", din)
        self.add(f"{name}.bias", (dout,), "zeros")

    def mhc(self, name, d, hidden, mlp):
        for raw, shape in (("H_pre_raw", (d, hidden)), ("H_post_raw", (hidden, d)),
                           ("H_res_raw", (d, d))):
            self.add(f"{name}.{raw}", shape, "mhc")
        self.add(f"{name}.mlp_in_kernel", (hidden, mlp), "normal", hidden)
        self.add(f"{name}.mlp_in_bias", (mlp,), "zeros")
        self.add(f"{name}.mlp_out_kernel", (mlp, hidden), "normal", mlp)
        self.add(f"{name}.mlp_out_bias", (hidden,), "zeros")
        for n in ("norm_pre", "norm_post"):
            self.add(f"{name}.{n}_scale", (d,), "ones")
            self.add(f"{name}.{n}_bias", (d,), "zeros")


def _blocks(cfg) -> List[Tuple[str, int, int, int]]:
    """(name, in channels, channels, stride) of every backbone block."""
    out, cin = [], cfg["stage_channels"][0]
    for s, (n, ch) in enumerate(zip(cfg["stage_blocks"], cfg["stage_channels"])):
        for b in range(n):
            out.append((f"stage{s + 1}_block{b}", cin, ch, 2 if b == 0 and s > 0 else 1))
            cin = ch
    return out


def param_spec(cfg) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """Every parameter of the model ``cfg`` describes, with its init:
    ``normal`` (std sqrt(1/fan), cut at 2 std), ``mhc`` (the mHC
    matrices' logits, uniform), ``ones``, ``zeros``, ``pos``
    (normal, std 0.02) and ``predict`` (the YOLO logits' bias)."""
    s = _Spec()
    base, chans = cfg["base_channels"], cfg["stage_channels"]
    s.conv("backbone.stem1", 3, base, 3)
    s.norm("backbone.GroupNorm_0", base)
    s.conv("backbone.stem2", base, chans[0], 3)
    s.norm("backbone.GroupNorm_1", chans[0])
    for name, cin, ch, stride in _blocks(cfg):
        p, mid = f"backbone.{name}", max(16, int(ch * 0.5))
        s.conv(f"{p}.reduce", cin, mid, 1)
        s.norm(f"{p}.GroupNorm_0", mid)
        s.conv(f"{p}.spatial", mid, mid, 3)
        s.norm(f"{p}.GroupNorm_1", mid)
        s.mhc(f"{p}.mhc", mid, mid, mid)
        s.conv(f"{p}.expand", mid, ch, 1)
        s.norm(f"{p}.GroupNorm_2", ch)
        s.dense(f"{p}.se.Dense_0", ch, ch // 4)
        s.dense(f"{p}.se.Dense_1", ch // 4, ch)
        if stride != 1 or cin != ch:
            s.conv(f"{p}.shortcut", cin, ch, 1)
            s.norm(f"{p}.GroupNorm_3", ch)
    if cfg["use_vit"]:
        d, c = cfg["vit_dim"], chans[-1]
        s.conv("vit_encoder.to_tokens", c, d, 1, bias=True)
        s.add("vit_encoder.cls_token", (1, 1, d), "pos")
        s.add("vit_encoder.pos_embed", (1, POS_GRID * POS_GRID + 1, d), "pos")
        for i in range(cfg["vit_depth"]):
            p = f"vit_encoder.encoder.block{i}"
            s.norm(f"{p}.LayerNorm_0", d)
            s.dense(f"{p}.attn.qkv", d, 3 * d)
            s.dense(f"{p}.attn.proj", d, d)
            s.mhc(f"{p}.mhc_ffn", d, d, 2 * d)
        s.norm("vit_encoder.encoder.final_norm", d)
        s.conv("vit_encoder.to_cnn", d, c, 1, bias=True)
        s.mhc("vit_encoder.mhc_fuse", c, c, c)
    f, outs = cfg["fpn_channels"], cfg["fusion_out_channels"]
    for i, c in enumerate(chans[1:]):
        s.conv(f"fpn.lateral{i}", c, f, 1)
    for i, o in enumerate(outs):
        s.conv(f"fpn.refine{i}", f, f, 3)
        s.norm(f"fpn.GroupNorm_{i}", f)
        s.mhc(f"fpn.mhc{i}", f, f, f)
        s.conv(f"fpn.out{i}", f, o, 1)
    h, a, c = cfg["head_channels"], cfg["num_anchors"], cfg["num_classes"]
    for key, o in zip(SCALES, outs):
        p = f"detection_head.head_{key}"
        s.conv(f"{p}.reduce", o, h, 1)
        s.norm(f"{p}.GroupNorm_0", h)
        s.conv(f"{p}.conv", h, h, 3)
        s.norm(f"{p}.GroupNorm_1", h)
        s.mhc(f"{p}.mhc", h, h, h)
        s.conv(f"{p}.predict", h, a * (5 + c), 1, bias=True, bias_init="predict")
    fd = cfg["feature_dim"]
    s.dense("feature_proj", sum(outs), fd)
    s.mhc("mhc_features", fd, fd, 2 * fd)
    return s.items


def _mhc_prefixes(params: Params) -> List[str]:
    return [n[: -len(".H_res_raw")] for n in params if n.endswith(".H_res_raw")]


def sinkhorn(logits: Tensor, iters: int, tau: float = 1.0) -> Tensor:
    """Log-domain Sinkhorn: ``iters`` row and column updates of the
    potentials, one more row update, then exp(L + f + g), L = logits / tau."""
    x = logits.float() / tau
    f = x.new_zeros(x.shape[:-1])
    g = x.new_zeros(x.shape[:-1])
    for _ in range(iters):
        f = -torch.logsumexp(x + g[..., None, :], dim=-1)
        g = -torch.logsumexp(x + f[..., :, None], dim=-2)
    f = -torch.logsumexp(x + g[..., None, :], dim=-1)
    return torch.exp(x + f[..., :, None] + g[..., None, :])


@torch.no_grad()
def prepare(params: Params, sk_iters: int) -> Params:
    """The weights in fp32 with each mHC layer's constrained matrices added
    (``<layer>.h_pre``, ``.h_post``, ``.h_res`` and ``.w1`` = h_pre @
    mlp_in_kernel), as a served model holds them."""
    out = {k: v.float() for k, v in params.items()}
    for p in _mhc_prefixes(params):
        h_pre = torch.sigmoid(out[f"{p}.H_pre_raw"])
        out[f"{p}.h_pre"] = h_pre
        out[f"{p}.h_post"] = 2.0 * torch.sigmoid(out[f"{p}.H_post_raw"])
        out[f"{p}.h_res"] = sinkhorn(out[f"{p}.H_res_raw"], sk_iters)
        out[f"{p}.w1"] = h_pre @ out[f"{p}.mlp_in_kernel"]
    return out


# ---------------------------------------------------------------------------
# Layers (NHWC maps, fp32)


def gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="tanh")


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor, eps: float = 1e-6) -> Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def group_norm(x: Tensor, P: Params, name: str, eps: float = 1e-5) -> Tensor:
    b, c = x.shape[0], x.shape[-1]
    g = _groups(c)
    xg = x.reshape(b, -1, g, c // g)
    mu = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mu).square().mean(dim=(1, 3), keepdim=True)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * P[f"{name}.scale"] + P[f"{name}.bias"]


class Model:
    """The served detector over prepared weights (``prepare``)."""

    def __init__(self, cfg, P: Params, precision: Precision = Precision()):
        self.cfg, self.P, self.prec = cfg, P, precision
        # When a list: each mHC layer's (rows, d, hidden, mlp width) per call.
        self.sites: Optional[List[Tuple[int, int, int, int]]] = None

    def conv(self, x, name, stride=1):
        return self.prec.conv(x, self.P[f"{name}.kernel"], self.P.get(f"{name}.bias"), stride)

    def dense(self, x, name):
        return self.prec.mm(x, self.P[f"{name}.kernel"]) + self.P[f"{name}.bias"]

    def mhc(self, x, name):
        P, mm = self.P, self.prec.mm
        if self.sites is not None:
            w1 = P[f"{name}.w1"]
            self.sites.append((x.numel() // x.shape[-1], x.shape[-1], P[f"{name}.h_post"].shape[0],
                               w1.shape[1]))
        y = layer_norm(x, P[f"{name}.norm_pre_scale"], P[f"{name}.norm_pre_bias"])
        y = gelu(mm(y, P[f"{name}.w1"]) + P[f"{name}.mlp_in_bias"])
        y = gelu(mm(y, P[f"{name}.mlp_out_kernel"]) + P[f"{name}.mlp_out_bias"])
        out = mm(x, P[f"{name}.h_res"]) + mm(y, P[f"{name}.h_post"])
        return layer_norm(out, P[f"{name}.norm_post_scale"], P[f"{name}.norm_post_bias"])

    def block(self, x, name, stride, projected):
        p = f"backbone.{name}"
        y = F.silu(group_norm(self.conv(x, f"{p}.reduce"), self.P, f"{p}.GroupNorm_0"))
        y = F.silu(group_norm(self.conv(y, f"{p}.spatial", stride), self.P, f"{p}.GroupNorm_1"))
        y = self.conv(self.mhc(y, f"{p}.mhc"), f"{p}.expand")
        y = group_norm(y, self.P, f"{p}.GroupNorm_2")
        pooled = y.mean(dim=(1, 2), keepdim=True)
        gate = torch.sigmoid(self.dense(F.silu(self.dense(pooled, f"{p}.se.Dense_0")),
                                        f"{p}.se.Dense_1"))
        shortcut = x
        if projected:
            shortcut = group_norm(self.conv(x, f"{p}.shortcut", stride), self.P,
                                  f"{p}.GroupNorm_3")
        return F.silu(y * gate + shortcut)

    def backbone(self, x):
        P = self.P
        x = F.silu(group_norm(self.conv(x, "backbone.stem1", 2), P, "backbone.GroupNorm_0"))
        x = F.silu(group_norm(self.conv(x, "backbone.stem2", 2), P, "backbone.GroupNorm_1"))
        last = {}
        for name, cin, ch, stride in _blocks(self.cfg):
            x = self.block(x, name, stride, stride != 1 or cin != ch)
            last[name.split("_")[0]] = x
        stages = [f"stage{i + 1}" for i in range(len(self.cfg["stage_blocks"]))]
        return [last[s] for s in stages[1:4]]

    def attention(self, x, name):
        b, t, d = x.shape
        heads = self.cfg["vit_heads"]
        q, k, v = self.dense(x, f"{name}.qkv").chunk(3, dim=-1)

        def split(a):
            return a.reshape(b, t, heads, d // heads).transpose(1, 2)

        logits = self.prec.mm(split(q), split(k).transpose(-1, -2)) / math.sqrt(d // heads)
        out = self.prec.mm(torch.softmax(logits, dim=-1), split(v))
        return self.dense(out.transpose(1, 2).reshape(b, t, d), f"{name}.proj")

    def vit(self, feat):
        P, d = self.P, self.cfg["vit_dim"]
        b, h, w, _ = feat.shape
        tokens = self.conv(feat, "vit_encoder.to_tokens").reshape(b, h * w, d)
        pos = P["vit_encoder.pos_embed"]
        grid = pos[:, 1:].reshape(1, POS_GRID, POS_GRID, d).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(h, w), mode="bilinear", align_corners=False,
                             antialias=True).permute(0, 2, 3, 1).reshape(1, h * w, d)
        cls = (P["vit_encoder.cls_token"] + pos[:, :1]).expand(b, 1, d)
        x = torch.cat([cls, tokens + grid], dim=1)
        for i in range(self.cfg["vit_depth"]):
            p = f"vit_encoder.encoder.block{i}"
            y = layer_norm(x, P[f"{p}.LayerNorm_0.scale"], P[f"{p}.LayerNorm_0.bias"])
            x = self.mhc(x + self.attention(y, f"{p}.attn"), f"{p}.mhc_ffn")
        x = layer_norm(x, P["vit_encoder.encoder.final_norm.scale"],
                       P["vit_encoder.encoder.final_norm.bias"])
        combined = x[:, 1:].reshape(b, h, w, d) + x[:, :1, None, :]
        return self.mhc(feat + self.conv(combined, "vit_encoder.to_cnn"), "vit_encoder.mhc_fuse")

    def fpn(self, scales):
        lat = [self.conv(x, f"fpn.lateral{i}") for i, x in enumerate(scales)]

        def up(x):
            return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

        td2 = lat[2]
        td1 = lat[1] + up(td2)
        td0 = lat[0] + up(td1)
        out = []
        for i, td in enumerate((td0, td1, td2)):
            y = F.silu(group_norm(self.conv(td, f"fpn.refine{i}"), self.P, f"fpn.GroupNorm_{i}"))
            out.append(self.conv(self.mhc(y, f"fpn.mhc{i}"), f"fpn.out{i}"))
        return out

    def head(self, x, key):
        p = f"detection_head.head_{key}"
        y = F.silu(group_norm(self.conv(x, f"{p}.reduce"), self.P, f"{p}.GroupNorm_0"))
        y = F.silu(group_norm(self.conv(y, f"{p}.conv"), self.P, f"{p}.GroupNorm_1"))
        out = self.conv(self.mhc(y, f"{p}.mhc"), f"{p}.predict")
        b, h, w, _ = out.shape
        return out.reshape(b, h, w, self.cfg["num_anchors"], -1)

    def raw(self, images: Tensor) -> List[Tensor]:
        """Normalised NHWC images -> the YOLO logits [B, H, W, A, 5 + C] per
        scale, fine to coarse."""
        scales = self.backbone(images)
        if self.cfg["use_vit"]:
            scales[2] = 0.5 * scales[2] + 0.5 * self.vit(scales[2])
        fused = self.fpn(scales)
        return [self.head(x, key) for x, key in zip(fused, SCALES)]


# ---------------------------------------------------------------------------
# Frames in, detections out


def letterbox_geometry(h: int, w: int, size: int):
    scale = size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    return scale, (nh, nw), ((size - nw) // 2, (size - nh) // 2)


def preprocess(frames_u8: Tensor, size: int) -> Tensor:
    """Raw BGR uint8 frames [B, h, w, 3] -> normalised RGB [B, size, size, 3]:
    bilinear resize (half-pixel centres, no antialias) into a centred canvas
    of grey 114."""
    x = frames_u8.flip(-1).float() / 255.0
    b, h, w, _ = x.shape
    _, (nh, nw), (px, py) = letterbox_geometry(h, w, size)
    if (nh, nw) != (h, w):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1)
    canvas = torch.full((b, size, size, 3), 114.0 / 255.0, device=x.device)
    canvas[:, py:py + nh, px:px + nw] = x
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (canvas - mean) / std


def decode(raw: Sequence[Tensor]) -> Tuple[Tensor, Tensor]:
    """Every anchor's box (normalised xyxy, [B, N, 4]) and its score for every
    class (objectness x class probability, [B, N, C])."""
    boxes, scores = [], []
    for s, r in enumerate(raw):
        b, h, w, a, _ = r.shape
        f = ANCHOR_GRIDS[s] / float(h)
        anchors = torch.tensor([[aw / 416 * f, ah / 416 * f] for aw, ah in ANCHORS_416[s]],
                               device=r.device)
        gy, gx = torch.meshgrid(torch.arange(h, device=r.device, dtype=torch.float32),
                                torch.arange(w, device=r.device, dtype=torch.float32),
                                indexing="ij")
        xy = torch.sigmoid(r[..., 0:2])
        cx = (gx[None, :, :, None] + xy[..., 0]) / w
        cy = (gy[None, :, :, None] + xy[..., 1]) / h
        wh = torch.exp(torch.clamp(r[..., 2:4], -WH_CLIP, WH_CLIP)) * anchors
        box = torch.stack([cx - wh[..., 0] / 2, cy - wh[..., 1] / 2,
                           cx + wh[..., 0] / 2, cy + wh[..., 1] / 2], dim=-1)
        boxes.append(box.reshape(b, -1, 4))
        score = torch.sigmoid(r[..., 4:5]) * torch.sigmoid(r[..., 5:])
        scores.append(score.reshape(b, h * w * a, -1))
    return torch.cat(boxes, dim=1), torch.cat(scores, dim=1)


def iou_matrix(a: Tensor, b: Tensor) -> Tensor:
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(dim=-1)
    area_a = (a[:, 2:] - a[:, :2]).clamp(min=0).prod(dim=-1)
    area_b = (b[:, 2:] - b[:, :2]).clamp(min=0).prod(dim=-1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-7)


def nms(boxes: Tensor, scores: Tensor, cfg) -> Tuple[Tensor, Tensor, Tensor]:
    """Class-aware greedy NMS of one frame's anchors, on the best class of
    each: the ``pre_nms_top_k`` best at or above the score threshold, each
    kept unless a kept higher-scored box of its class overlaps it by more
    than the IoU threshold; the ``max_detections`` best kept. Returns boxes,
    scores and classes of the kept."""
    best, cls = scores.max(dim=-1)
    order = torch.argsort(best, descending=True, stable=True)[: cfg["pre_nms_top_k"]]
    order = order[best[order] >= cfg["score_threshold"]]
    b, s, c = boxes[order], best[order], cls[order]
    overlap = (iou_matrix(b, b) > cfg["iou_threshold"]) & (c[:, None] == c[None, :])
    overlap = overlap.cpu()
    keep: List[int] = []
    for i in range(len(order)):
        if not any(bool(overlap[j, i]) for j in keep):
            keep.append(i)
    keep = keep[: cfg["max_detections"]]
    idx = torch.tensor(keep, dtype=torch.long, device=boxes.device)
    return b[idx], s[idx], c[idx]


def to_pixels(boxes: Tensor, frame_hw: Tuple[int, int], size: int) -> Tensor:
    """Normalised letterbox xyxy -> the frame's pixels, clipped to it."""
    h, w = frame_hw
    scale, _, (px, py) = letterbox_geometry(h, w, size)
    b = boxes * size
    x = ((b[..., 0::2] - px) / scale).clamp(0, w)
    y = ((b[..., 1::2] - py) / scale).clamp(0, h)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)


def box_filter(boxes_px: Tensor, min_size: float, max_aspect: float) -> Tensor:
    """The served boxes' validity filter: both sides above ``min_size`` and
    an aspect ratio inside (1/max_aspect, max_aspect)."""
    wh = boxes_px[..., 2:] - boxes_px[..., :2]
    ar = wh[..., 0].clamp(min=1e-3) / wh[..., 1].clamp(min=1e-3)
    return (wh > min_size).all(dim=-1) & (ar < max_aspect) & (ar > 1.0 / max_aspect)
