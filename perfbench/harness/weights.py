"""Seeded weights, made on the device in a few large draws."""

from __future__ import annotations

import math
from typing import Dict

import torch

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device: torch.device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one use (``stream``) of a run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) & SEED_MASK)
    return g


def make_weights(cfg, ref, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Every parameter of ``cfg``'s model (as its reference ``ref`` names
    them), fp32 on ``device``, by name: one
    normal and one uniform draw for the whole model, cut into the
    parameters (inits as ``param_spec`` names them; the mHC matrices'
    logits uniform in +-``mhc_logit_limit``, the YOLO logits' bias
    ``predict_bias``)."""
    spec = ref.param_spec(cfg)
    numel = {n: math.prod(s) for n, s, _, _ in spec}
    n_normal = sum(numel[n] for n, _, init, _ in spec if init in ("normal", "pos"))
    n_uniform = sum(numel[n] for n, _, init, _ in spec if init == "mhc")
    g = generator(seed, device, 0)
    normal = torch.randn(n_normal, generator=g, device=device).clamp_(-2.0, 2.0)
    uniform = torch.rand(n_uniform, generator=g, device=device).mul_(2.0).sub_(1.0)
    bias = cfg["predict_bias"]
    out, i, j = {}, 0, 0
    for name, shape, init, fan in spec:
        k = numel[name]
        if init == "normal":
            t = normal[i:i + k].view(shape) * math.sqrt(1.0 / fan)
            i += k
        elif init == "pos":
            t = normal[i:i + k].view(shape) * 0.02
            i += k
        elif init == "mhc":
            t = uniform[j:j + k].view(shape) * cfg["mhc_logit_limit"]
            j += k
        elif init == "ones":
            t = torch.ones(shape, device=device)
        elif init == "zeros":
            t = torch.zeros(shape, device=device)
        elif init == "predict":
            t = torch.zeros(cfg["num_anchors"], 5 + cfg["num_classes"], device=device)
            t[:, 4] = bias["objectness"]
            t[:, 5:] = bias["class"]
            t = t.reshape(shape)
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
        out[name] = t
    return out


@torch.no_grad()
def calibrate_objectness(cfg, ref, weights: Dict[str, torch.Tensor], frames_u8: torch.Tensor,
                         size: int) -> float:
    """Shift the objectness logits' bias (in place, in ``weights``) so that
    the reference finds ``candidates_per_frame`` anchors at or above the
    score threshold on these frames, on average; returns the shift (to
    1e-3). Random weights leave the logits' offset to the seed, and with it
    whether a frame has one candidate or thousands; a trained detector has
    tens. The reference runs on the CPU, so that the card's libraries are
    first loaded by the program's own set-up."""
    cpu = {k: v.cpu() for k, v in weights.items()}
    model = ref.Model(cfg, ref.prepare(cpu, cfg["sinkhorn_iterations"]))
    raw = model.raw(ref.preprocess(frames_u8.cpu(), size))
    obj = torch.cat([r[..., 4].reshape(-1) for r in raw])
    cls = torch.cat([torch.sigmoid(r[..., 5:].amax(dim=-1)).reshape(-1) for r in raw])
    want = cfg["candidates_per_frame"] * frames_u8.shape[0]
    lo, hi = -30.0, 30.0
    for _ in range(40):
        mid = (lo + hi) / 2
        n = int((torch.sigmoid(obj + mid) * cls >= cfg["score_threshold"]).sum())
        lo, hi = (mid, hi) if n < want else (lo, mid)
    shift = round((lo + hi) / 2, 3)
    a = cfg["num_anchors"]
    for key in ref.SCALES:
        bias = weights[f"detection_head.head_{key}.predict.bias"].view(a, -1)
        bias[:, 4] += shift
    return shift
