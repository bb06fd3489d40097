"""Fused serve-path mHC block: the Hopper kernel's wrapper and its plain version.

Replaces the TPU kernel ``hvs_tpu/ops/pallas/mhc_pallas.py::mhc_block_pallas_packed``
(kernel body ``_mhc_packed_kernel``). The CUDA source is
``hvs_tpu_torch/csrc/mhc_block.cu``; it is built with nvcc at first use.

Per token row: LN1 (fp32 statistics, eps 1e-6) -> ``@ W1_folded + b1`` -> GELU
(tanh) -> ``@ W2 + b2`` -> GELU -> ``@ H_post``; plus ``x @ H_res``; add; LN2.
bf16 operands, fp32 accumulation, a round to bf16 after LN1, after each
product, each bias add, each GELU and the residual add.

What bounds it on an H100: 8·N·d² FLOP against 4·N·d activation bytes
(+ ~10·d² weight bytes), about 2·d FLOP per byte, so it is memory-bound at
d <= 128 and tensor-core-bound at d >= 256 (the card's bf16 ridge is ~295
FLOP/byte). The design reads x once and writes the output once, keeps every
intermediate in shared memory, and streams the [d, d] weights from L2 in
double-buffered k-chunks (they do not fit in shared memory at d >= 256); the
source's header says more.

Unlike the TPU path there is no batch or token gate: every eligible site
launches the kernel at every batch size.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

SUPPORTED_WIDTHS = (32, 64, 128, 256, 512)

# Kernel launches made by ``mhc_block`` in this process (CUDA tensors only).
launches = 0

_argtypes = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_void_p] * 11
)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics (two-pass variance)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * scale + bias


def mhc_block_plain(x, w1_folded, b1, w2, b2, h_post, h_res,
                    ln1_scale, ln1_bias, ln2_scale, ln2_bias) -> torch.Tensor:
    """The kernel's function in plain PyTorch, rounding at the same points.
    ``x`` [N, d]; returns [N, d] in ``x.dtype``."""
    bf = torch.bfloat16
    y = layernorm(x, ln1_scale, ln1_bias).to(bf)
    y = F.gelu(y @ w1_folded.to(bf) + b1.to(bf), approximate="tanh")
    y = F.gelu(y @ w2.to(bf) + b2.to(bf), approximate="tanh")
    y = y @ h_post.to(bf)
    res = x.to(bf) @ h_res.to(bf)
    return layernorm(res + y, ln2_scale, ln2_bias).to(x.dtype)


def _check(x, mats, vecs) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"mhc_block kernel takes bf16 x, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] not in SUPPORTED_WIDTHS:
        raise ValueError(
            f"mhc_block kernel takes x [N, d] with d in {SUPPORTED_WIDTHS}, got {tuple(x.shape)}"
        )
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("mhc_block kernel takes a contiguous, 16-byte aligned x")
    d = x.shape[1]
    for name, m in mats.items():
        if m.device != x.device or m.dtype != torch.bfloat16 or m.shape != (d, d) \
                or not m.is_contiguous() or m.data_ptr() % 16:
            raise ValueError(
                f"mhc_block kernel takes {name} as a contiguous [{d}, {d}] bf16 tensor on "
                f"{x.device}, got {tuple(m.shape)} {m.dtype} on {m.device}"
            )
    for name, v in vecs.items():
        if v.device != x.device or v.dtype != torch.float32 or v.shape != (d,) \
                or not v.is_contiguous():
            raise ValueError(
                f"mhc_block kernel takes {name} as a contiguous [{d}] fp32 tensor on "
                f"{x.device}, got {tuple(v.shape)} {v.dtype} on {v.device}"
            )


def _library():
    from .. import build

    lib = build.load("mhc_block")
    fn = lib.hvs_mhc_block
    if fn.argtypes is None:
        fn.argtypes = _argtypes
        fn.restype = ctypes.c_int
    return fn


def mhc_block(x, w1_folded, b1, w2, b2, h_post, h_res,
              ln1_scale, ln1_bias, ln2_scale, ln2_bias) -> torch.Tensor:
    """Fused serve-path mHC block on ``x`` [N, d].

    A CPU ``x`` takes the plain version. A CUDA ``x`` must be bf16 and
    contiguous, the matrices [d, d] bf16 and the vectors [d] fp32 on the same
    device; the kernel is launched on the current stream, or this raises.
    """
    if x.device.type == "cpu":
        return mhc_block_plain(x, w1_folded, b1, w2, b2, h_post, h_res,
                               ln1_scale, ln1_bias, ln2_scale, ln2_bias)
    if x.device.type != "cuda":
        raise ValueError(f"mhc_block runs on cuda or cpu tensors, got {x.device}")
    mats = {"w1_folded": w1_folded, "w2": w2, "h_post": h_post, "h_res": h_res}
    vecs = {"b1": b1, "b2": b2, "ln1_scale": ln1_scale, "ln1_bias": ln1_bias,
            "ln2_scale": ln2_scale, "ln2_bias": ln2_bias}
    _check(x, mats, vecs)
    fn = _library()
    out = torch.empty_like(x)
    n, d = x.shape
    if n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), out.data_ptr(), n, d,
            w1_folded.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            h_post.data_ptr(), h_res.data_ptr(),
            ln1_scale.data_ptr(), ln1_bias.data_ptr(),
            ln2_scale.data_ptr(), ln2_bias.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"mhc_block kernel launch failed with CUDA error {err}")
    global launches
    launches += 1
    return out
