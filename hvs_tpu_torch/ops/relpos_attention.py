"""Attention with ViTDet's decomposed relative positions: the Hopper kernel's
wrapper and its plain version.

For each image (or window) n, head h and query t = (y, x) of a kh x kw grid,
over every key s = (ky, kx) of the same grid:

    logits[t, s] = (q[t] / sqrt(64)) . k[s] + rel_h[t, ky] + rel_w[t, kx]
    out[t]       = softmax_s(logits[t]) @ v

``rel_h`` and ``rel_w`` are the query's products with the relative position
tables (``models/vitdet.py::relative_terms``), computed in fp32 before the
call. The kernel, ``hvs_tpu_torch/csrc/relpos_attention.cu``, built with nvcc
at first use, is flash-style: no [T, T] tensor reaches memory (at 1024² a
global block's fp32 logits would be 805 MB a frame). It replaces no TPU
kernel: the JAX package has no ViTDet.

Layout (the operator's contract): q, k, v [N, kh, kw, H, 64] bf16, any
strides whose last is 1 and the others multiples of 8 (views of the qkv
projection's output [N, kh, kw, 3, H, 64] are taken as they are), k and v
strided as q; rel_h [N, kh, kw, H, kh] and rel_w [N, kh, kw, H, kw] fp32, any
strides whose last is 1 (the strided views ``relative_terms`` returns);
1 <= kh, kw <= 64. The output is a new contiguous [N, kh, kw, H, 64] bf16
tensor, the layout the output projection reads.

It is the registered operator ``hvs::relpos_attention``, whose CPU version is
the plain one, so capture, ``torch.export`` and an operation count see the
same call on either device. It has no backward: with autograd on, the model
runs the plain version itself (``relpos_attention_plain``), on either device.
With autograd off a CUDA map launches the kernel or the wrapper raises:
nothing falls back to the plain chain on the card.

``windowed`` says which counter a launch counts in (``launches_window`` or
``launches_global``); the kernel does not read it.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

HEAD_DIM = 64  # the kernel's head width
MAX_SIDE = 64  # the kernel's bound on kh and kw (its shared-memory tables)

# Kernel launches in this process (CUDA tensors only), by the attention's
# kind. An empty map launches nothing and counts none.
launches_window = 0
launches_global = 0


def relpos_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           rel_h: torch.Tensor, rel_w: torch.Tensor,
                           windowed: bool = False) -> torch.Tensor:
    """The operator in plain PyTorch, in fp32: ``softmax(q k^T / sqrt(D) +
    rel_h + rel_w) v``, rounded to q's dtype, as a contiguous [N, kh, kw, H,
    D] tensor. Differentiable; takes any head width and grid."""
    n, kh, kw, h, d = q.shape
    t = kh * kw

    def heads(a):
        return a.float().reshape(n, t, h, d).transpose(1, 2)

    logits = (heads(q) * d ** -0.5) @ heads(k).transpose(-1, -2)
    bias = (rel_h.float().permute(0, 3, 1, 2, 4)[..., :, None]
            + rel_w.float().permute(0, 3, 1, 2, 4)[..., None, :])
    logits = logits + bias.reshape(n, h, t, t)
    out = torch.softmax(logits, dim=-1) @ heads(v)
    return out.transpose(1, 2).reshape(n, kh, kw, h, d).to(q.dtype).contiguous()


# ---------------------------------------------------------------------------
# The kernel's contract and launch


def _check(q, k, v, rel_h, rel_w, addresses: bool = True) -> None:
    if q.dim() != 5 or q.shape[-1] != HEAD_DIM or q.dtype != torch.bfloat16:
        raise TypeError(f"relpos_attention kernel takes bf16 q [N, kh, kw, H, {HEAD_DIM}], "
                        f"got {q.dtype} {tuple(q.shape)}")
    n, kh, kw, h, _ = q.shape
    if not (1 <= kh <= MAX_SIDE and 1 <= kw <= MAX_SIDE):
        raise ValueError(f"relpos_attention kernel takes grids up to {MAX_SIDE} x {MAX_SIDE}, "
                         f"got {kh} x {kw}")
    for name, a in (("k", k), ("v", v)):
        if a.shape != q.shape or a.dtype != q.dtype or a.device != q.device \
                or a.stride() != q.stride():
            raise ValueError(f"relpos_attention kernel takes {name} shaped, typed, placed and "
                             f"strided as q {tuple(q.shape)} {q.stride()}, got "
                             f"{tuple(a.shape)} {a.dtype} {a.stride()} on {a.device}")
        if addresses and a.data_ptr() % 16:
            raise ValueError(f"relpos_attention kernel takes a 16-byte aligned {name}")
    if q.stride(-1) != 1 or any(s % 8 for s in q.stride()[:-1]) \
            or (addresses and q.data_ptr() % 16):
        raise ValueError(f"relpos_attention kernel takes q, k, v with unit last stride and the "
                         f"others multiples of 8, 16-byte aligned; got strides {q.stride()}")
    for name, a, side in (("rel_h", rel_h, kh), ("rel_w", rel_w, kw)):
        if tuple(a.shape) != (n, kh, kw, h, side) or a.dtype != torch.float32 \
                or a.device != q.device or a.stride(-1) != 1:
            raise ValueError(f"relpos_attention kernel takes {name} as fp32 "
                             f"[{n}, {kh}, {kw}, {h}, {side}] on {q.device} with unit last "
                             f"stride, got {tuple(a.shape)} {a.dtype} {a.stride()} on "
                             f"{a.device}")


_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_int64] * 12
             + [ctypes.c_void_p])


def _relpos_attention_cuda(q, k, v, rel_h, rel_w, windowed) -> torch.Tensor:
    global launches_window, launches_global
    _check(q, k, v, rel_h, rel_w)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if not q.numel():
        return out
    from .. import build

    fn = build.load("relpos_attention").hvs_relpos_attention
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    n, kh, kw, h, _ = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
                 out.data_ptr(), n, kh, kw, h, *q.stride()[:4], *rel_h.stride()[:4],
                 *rel_w.stride()[:4], stream)
    if err != 0:
        raise RuntimeError(f"relpos_attention kernel launch failed with CUDA error {err}")
    if windowed:
        launches_window += 1
    else:
        launches_global += 1
    return out


def _relpos_attention_fake(q, k, v, rel_h, rel_w, windowed) -> torch.Tensor:
    if q.is_cuda:
        _check(q, k, v, rel_h, rel_w, addresses=False)
    return q.new_empty(q.shape)


# Registered through ``torch.library.Library`` as ``hvs::mhc_block`` is
# (ops/mhc_block.py says why not ``custom_op``).
_LIB = torch.library.Library("hvs", "FRAGMENT")
_LIB.define("relpos_attention(Tensor q, Tensor k, Tensor v, Tensor rel_h, Tensor rel_w, "
            "bool windowed) -> Tensor")
_LIB.impl("relpos_attention", _relpos_attention_cuda, "CUDA")
_LIB.impl("relpos_attention", relpos_attention_plain, "CPU")
torch.library.register_fake("hvs::relpos_attention", _relpos_attention_fake, lib=_LIB)
relpos_attention_op = torch.ops.hvs.relpos_attention.default


@register_flop_formula(torch.ops.hvs.relpos_attention)
def _relpos_attention_flops(q_shape, *shapes, out_shape=None, **kwargs) -> int:
    """The two products, q k^T and p v: 4·N·H·T²·D."""
    n, kh, kw, h, d = q_shape
    return 4 * n * h * (kh * kw) ** 2 * d


def relpos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel_h: torch.Tensor,
                     rel_w: torch.Tensor, windowed: bool) -> torch.Tensor:
    """The attention through ``hvs::relpos_attention`` (see the module's
    contract). A CPU map takes the plain version; a CUDA map launches the
    kernel on the current stream, or this raises."""
    return relpos_attention_op(q, k, v, rel_h, rel_w, windowed)
