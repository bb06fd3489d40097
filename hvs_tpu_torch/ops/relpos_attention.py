"""Attention with ViTDet's decomposed relative positions: the Hopper kernel's
wrapper and its plain version.

For each image (or window) n, head h and query t = (y, x) of a kh x kw grid,
over every key s = (ky, kx) of the same grid:

    rel_h[t, ky] = q[t] . table_h[kh - 1 + y - ky]
    rel_w[t, kx] = q[t] . table_w[kw - 1 + x - kx]
    logits[t, s] = (q[t] / sqrt(64)) . k[s] + rel_h[t, ky] + rel_w[t, kx]
    out[t]       = softmax_s(logits[t]) @ v

Two registered operators, so that capture, ``torch.export`` and an operation
count see the same call on either device:

- ``hvs::relpos_attention_tables(q, k, v, table_h, table_w, windowed)`` takes
  the two tables. On a CUDA map it launches the kernel,
  ``hvs_tpu_torch/csrc/relpos_attention.cu`` (built with nvcc at first use),
  which computes the relative terms itself from its q tile and the tables,
  flash-style: neither a [T, T] tensor nor the terms reach memory (at 1024² a
  global block's fp32 logits would be 805 MB a frame, its terms 50 MB). Its
  CPU version is the plain chain, ``relative_terms`` then
  ``relpos_attention_plain``.
- ``hvs::relpos_attention(q, k, v, rel_h, rel_w, windowed)`` takes the terms
  made beforehand by ``relative_terms``. It has only its CPU version, the
  plain one: on a CUDA map it raises, since no kernel reads materialised
  terms.

Neither has a backward: with autograd on, the model runs the plain chain
itself, on either device. With autograd off a CUDA map launches the kernel
or the wrapper raises: nothing falls back to the plain chain on the card.
The kernel replaces no TPU kernel: the JAX package has no ViTDet.

The kernel's contract: q, k, v [N, kh, kw, H, 64] bf16, any strides whose
last is 1 and the others multiples of 8 (views of the qkv projection's
output [N, kh, kw, 3, H, 64] are taken as they are), k and v strided as q;
table_h [2kh - 1, 64] and table_w [2kw - 1, 64] contiguous fp32, on q's
card; 1 <= kh, kw <= 64. The output is a new contiguous [N, kh, kw, H, 64]
bf16 tensor, the layout the output projection reads.

``windowed`` says which counter a launch counts in (``launches_window`` or
``launches_global``); the kernel does not read it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

HEAD_DIM = 64  # the kernel's head width
MAX_SIDE = 64  # the kernel's bound on kh and kw (its shared-memory rows)

# Kernel launches in this process (CUDA tensors only), by the attention's
# kind. An empty map launches nothing and counts none.
launches_window = 0
launches_global = 0


def relative_terms(q: torch.Tensor, table_h: torch.Tensor, table_w: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ViTDet's ``rel_h`` and ``rel_w`` for q [N, kh, kw, H, D] (any
    strides): fp32 [N, kh, kw, H, kh] and [N, kh, kw, H, kw], with
    ``rel_h[.., y, x, :, ky] = q[.., y, x, :] . table_h[kh - 1 + y - ky]``
    and ``rel_w`` alike along x.

    One fp32 product of every query with both tables reversed, [N·kh·kw·H,
    (2kh - 1) + (2kw - 1)]; the two terms are strided views of it (the row
    a query needs starts kh - 1 - y columns in, so one step in y is one
    row's length less one column)."""
    n, kh, kw, h, d = q.shape
    if table_h.shape[0] != 2 * kh - 1 or table_w.shape[0] != 2 * kw - 1:
        raise ValueError(f"relative position tables of {table_h.shape[0]} and "
                         f"{table_w.shape[0]} rows do not serve a {kh} x {kw} grid")
    jh = table_h.shape[0]
    tables = torch.cat([table_h.flip(0), table_w.flip(0)]).float()
    proj = q.float().reshape(-1, d) @ tables.T
    j = proj.shape[1]
    row = h * j
    base = proj.storage_offset()
    rel_h = proj.as_strided((n, kh, kw, h, kh), (kh * kw * row, kw * row - 1, row, j, 1),
                            base + kh - 1)
    rel_w = proj.as_strided((n, kh, kw, h, kw), (kh * kw * row, kw * row, row - 1, j, 1),
                            base + jh + kw - 1)
    return rel_h, rel_w


def relpos_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           rel_h: torch.Tensor, rel_w: torch.Tensor,
                           windowed: bool = False) -> torch.Tensor:
    """The attention in plain PyTorch, in fp32, on terms made beforehand:
    ``softmax(q k^T / sqrt(D) + rel_h + rel_w) v``, rounded to q's dtype, as
    a contiguous [N, kh, kw, H, D] tensor. Differentiable; takes any head
    width and grid."""
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


def relpos_attention_tables_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  table_h: torch.Tensor, table_w: torch.Tensor,
                                  windowed: bool = False) -> torch.Tensor:
    """``hvs::relpos_attention_tables``'s plain version: the terms by
    ``relative_terms``, then ``relpos_attention_plain``."""
    return relpos_attention_plain(q, k, v, *relative_terms(q, table_h, table_w))


# ---------------------------------------------------------------------------
# The kernel's contract and launch


def _check(q, k, v, table_h, table_w, addresses: bool = True) -> None:
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
    for name, t, side in (("table_h", table_h, kh), ("table_w", table_w, kw)):
        if t.dtype != torch.float32:
            raise TypeError(f"relpos_attention kernel takes an fp32 {name}, got {t.dtype}")
        if tuple(t.shape) != (2 * side - 1, HEAD_DIM) or t.device != q.device \
                or not t.is_contiguous() or (addresses and t.data_ptr() % 16):
            raise ValueError(f"relpos_attention kernel takes {name} as a contiguous, 16-byte "
                             f"aligned [{2 * side - 1}, {HEAD_DIM}] on {q.device} (a {kh} x "
                             f"{kw} grid), got {tuple(t.shape)} {t.stride()} on {t.device}")


_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_int64] * 4
             + [ctypes.c_void_p])


def _relpos_attention_tables_cuda(q, k, v, table_h, table_w, windowed) -> torch.Tensor:
    global launches_window, launches_global
    _check(q, k, v, table_h, table_w)
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
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), table_h.data_ptr(),
                 table_w.data_ptr(), out.data_ptr(), n, kh, kw, h, *q.stride()[:4], stream)
    if err != 0:
        raise RuntimeError(f"relpos_attention kernel launch failed with CUDA error {err}")
    if windowed:
        launches_window += 1
    else:
        launches_global += 1
    return out


def _relpos_attention_tables_fake(q, k, v, table_h, table_w, windowed) -> torch.Tensor:
    if q.is_cuda:
        _check(q, k, v, table_h, table_w, addresses=False)
    return q.new_empty(q.shape)


_NO_TERMS_KERNEL = ("hvs::relpos_attention takes materialised relative terms, which no kernel "
                    "reads: on a CUDA map call hvs::relpos_attention_tables "
                    "(relpos_attention_tables) with the two tables")


def _relpos_attention_cuda(q, k, v, rel_h, rel_w, windowed) -> torch.Tensor:
    raise RuntimeError(_NO_TERMS_KERNEL)


def _relpos_attention_fake(q, k, v, rel_h, rel_w, windowed) -> torch.Tensor:
    if q.is_cuda:
        raise RuntimeError(_NO_TERMS_KERNEL)
    return q.new_empty(q.shape)


# Registered through ``torch.library.Library`` as ``hvs::mhc_block`` is
# (ops/mhc_block.py says why not ``custom_op``).
_LIB = torch.library.Library("hvs", "FRAGMENT")
_LIB.define("relpos_attention_tables(Tensor q, Tensor k, Tensor v, Tensor table_h, "
            "Tensor table_w, bool windowed) -> Tensor")
_LIB.impl("relpos_attention_tables", _relpos_attention_tables_cuda, "CUDA")
_LIB.impl("relpos_attention_tables", relpos_attention_tables_plain, "CPU")
torch.library.register_fake("hvs::relpos_attention_tables", _relpos_attention_tables_fake,
                            lib=_LIB)
relpos_attention_tables_op = torch.ops.hvs.relpos_attention_tables.default
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


@register_flop_formula(torch.ops.hvs.relpos_attention_tables)
def _relpos_attention_tables_flops(q_shape, k_shape, v_shape, table_h_shape, table_w_shape,
                                   *args, out_shape=None, **kwargs) -> int:
    """What the plain chain's products count: q with both tables,
    2·N·T·H·D·((2kh - 1) + (2kw - 1)), and the attention's 4·N·H·T²·D."""
    n, kh, kw, h, d = q_shape
    rows = table_h_shape[0] + table_w_shape[0]
    return 2 * n * kh * kw * h * d * rows + _relpos_attention_flops(q_shape)


def relpos_attention_tables(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            table_h: torch.Tensor, table_w: torch.Tensor,
                            windowed: bool) -> torch.Tensor:
    """The attention through ``hvs::relpos_attention_tables`` (see the
    module's contract). A CPU map takes the plain chain; a CUDA map launches
    the kernel on the current stream, or this raises."""
    return relpos_attention_tables_op(q, k, v, table_h, table_w, windowed)


def relpos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel_h: torch.Tensor,
                     rel_w: torch.Tensor, windowed: bool) -> torch.Tensor:
    """The attention on terms made beforehand, through
    ``hvs::relpos_attention``: the plain version on a CPU map; a CUDA map
    raises (``relpos_attention_tables`` is the card's)."""
    return relpos_attention_op(q, k, v, rel_h, rel_w, windowed)
