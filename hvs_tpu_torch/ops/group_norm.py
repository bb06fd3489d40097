"""GroupNorm on NHWC maps: the Hopper kernel pair's wrappers and their plain
versions.

Two kernels in ``hvs_tpu_torch/csrc/group_norm.cu``, built with nvcc at first
use: ``gn_stats`` reads a map (bf16 on the serve path; fp16 or fp32 in a
model of that precision) once and writes fp32 partial sums of x and x² per
(image, slice of rows, channel); ``gn_apply`` sums its image's partials to
the group statistics in its prologue and streams the map once, writing
``T(x*s + t)`` in the map's type T (``models/layers.py::GroupNorm``),
optionally followed by SiLU, or, in tail mode, the folded serve tail of
``models/backbone.py::ConvMHCBlock``: ``T(silu(y*s + t + shortcut'))``
with the SE gate already in s and t and ``shortcut'`` the shortcut as it is
or normalised by its own partials. The kernel pair replaces no TPU kernel:
XLA fused this glue into its neighbours on the TPU. In plain PyTorch it was a
chain of fp32 passes over the map (about 48 bytes per element for
GroupNorm + SiLU, 60 for the tail).

Each is a registered operator (``hvs::gn_stats``, ``hvs::gn_apply``,
``hvs::gn_apply_tail``) whose CPU version is the plain one, so capture,
``torch.export`` and an operation count see the same calls on either device.
They have no backward.

Dispatch rule (``engaged``): every GroupNorm takes the operators when
autograd is off (``torch.no_grad`` or ``inference_mode``). Then a CUDA tensor
launches the kernels, or the wrapper raises if the map is outside their
contract (a float type, C a multiple of 4 up to ``MAX_CHANNELS``, contiguous
and 16-byte aligned): nothing falls back to the plain chain on the card. A
CPU tensor runs their plain versions, which take any map, round where the
plain chain rounds and give its bits. With autograd on (every training step)
the model runs the plain chain itself (``spatial_means``, ``affine``,
``normalize``), on either device.

Rounding: GroupNorm + SiLU rounds the normalised map to the map's type, takes
SiLU in fp32 of the rounded value and rounds again, as
``F.silu(GroupNorm(x))``; the tail stays in fp32 to one rounding at the end.
The kernels round each product and sum where the plain version does (no fma
contraction); only the statistics are summed in another order.

What bounds it on an H100: bytes alone, 6 per bf16 element for GroupNorm +
SiLU (read for the statistics, read and write for the apply), 8 for the tail
with an identity shortcut and 10 with a projected one; twice that in fp32.
``gn_apply`` runs right after ``gn_stats`` so that a map up to ~50 MB is read
again from L2. A block of 256 threads takes one image and one slice of rows,
each thread 8 channels (16-byte loads of bf16, two of fp32), or 4 where 8
does not divide C; the slice count (``num_slices``) grows with sqrt(HW) and
not with the batch, so every image is cut alike and a bucket's batch size
does not change its bits. No atomics: the same input gives the same bits on
every run.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

THREADS = 256  # threads per block, as csrc/group_norm.cu's kThreads
MAX_CHANNELS = 1024  # the kernels' shared-memory bound on C
# The map types the kernels take, by the code their entry points name them.
DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

# Kernel launches in this process (CUDA tensors only): ``gn_stats``, and
# ``gn_apply`` in either mode. An empty map launches nothing and counts none.
launches_stats = 0
launches_apply = 0


def engaged() -> bool:
    """Whether a GroupNorm takes the operators: autograd is off (see the
    module's dispatch rule)."""
    return not torch.is_grad_enabled()


def vec_width(c: int) -> int:
    """Channels per thread, as csrc/group_norm.cu's V: 8 where 8 divides C
    (one 16-byte access of bf16), else 4 (C a multiple of 4 on the card)."""
    return 8 if c % 8 == 0 else 4


def num_slices(hw: int, c: int) -> int:
    """Slices of rows per image: about sqrt(HW / 8), so that the apply
    prologue's read of the partials (8·S·C bytes per block) stays at about
    half the block's share of the map, and at most one slice per block's
    pass of rows (256 / (C/V) rows)."""
    rows_per_pass = THREADS // max(1, c // vec_width(c))
    return max(1, min(math.isqrt(hw // 8), -(-hw // rows_per_pass)))


def _dims(x: torch.Tensor) -> Tuple[int, int, int]:
    """(B, HW, C) of an NHWC map, HW every axis between the first and last."""
    return x.shape[0], math.prod(x.shape[1:-1]), x.shape[-1]


# ---------------------------------------------------------------------------
# Plain versions


def spatial_means(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-channel spatial means of x and x², each [B, C], of the fp32
    NHWC map ``x32``: the plain chain's statistics."""
    spatial = tuple(range(1, x32.dim() - 1))
    return x32.mean(dim=spatial), x32.square().mean(dim=spatial)


def gn_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """The statistics as ``gn_stats`` lays them out, [B, S, 2, C] fp32 with
    S = ``num_slices``: summed over S they are the per-channel spatial means
    of x and x². The plain version puts both means in slice 0 and zeros in
    the others, so the sum gives the plain chain's means bit for bit."""
    b, hw, c = _dims(x)
    means = torch.stack(spatial_means(x.float()), dim=1)
    rest = means.new_zeros(b, num_slices(hw, c) - 1, 2, c)
    return torch.cat((means[:, None], rest), dim=1)


def channel_means(stats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-channel means of x and x², each [B, C], from [B, S, 2, C]
    statistics."""
    m = stats.sum(dim=1)
    return m[:, 0], m[:, 1]


def affine(ch_mean: torch.Tensor, ch_m2: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           groups: int, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s, t), each [B, C], with GroupNorm(x) = x*s + t, from the per-channel
    means of x and x²: the group means of the channel means, then
    rsqrt(E[x²] - E[x]² + eps), s = scale·rs and t = bias - E[x]·s."""
    b, c = ch_mean.shape
    gm = ch_mean.reshape(b, groups, c // groups).mean(dim=-1)
    gm2 = ch_m2.reshape(b, groups, c // groups).mean(dim=-1)
    rs = torch.rsqrt(gm2 - gm.square() + eps)
    s = scale[None, :] * rs.repeat_interleave(c // groups, dim=-1)
    t = bias[None, :] - gm.repeat_interleave(c // groups, dim=-1) * s
    return s, t


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[B, C] reshaped to broadcast over the NHWC map ``x``."""
    return v.reshape((x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],))


def normalize(x32: torch.Tensor, s: torch.Tensor, t: torch.Tensor, silu: bool,
              dtype: torch.dtype) -> torch.Tensor:
    """The plain chain's apply: ``x32*s + t`` in fp32 (s, t [B, C]), rounded
    to ``dtype``; with ``silu``, SiLU of that."""
    y = (x32 * _per_channel(s, x32) + _per_channel(t, x32)).to(dtype)
    return F.silu(y) if silu else y


def gn_apply_plain(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, groups: int, eps: float, silu: bool) -> torch.Tensor:
    """``gn_apply`` in plain PyTorch: GroupNorm of ``x`` from its statistics,
    fp32, rounded to x's dtype; with ``silu``, SiLU of that."""
    s, t = affine(*channel_means(stats), scale, bias, groups, eps)
    return normalize(x.float(), s, t, silu, x.dtype)


def gn_apply_tail_plain(y: torch.Tensor, s: Optional[torch.Tensor], t: Optional[torch.Tensor],
                        shortcut: torch.Tensor, shortcut_stats: Optional[torch.Tensor] = None,
                        shortcut_scale: Optional[torch.Tensor] = None,
                        shortcut_bias: Optional[torch.Tensor] = None, groups: int = 1,
                        eps: float = 0.0) -> torch.Tensor:
    """The folded serve tail in plain PyTorch, all in fp32 and rounded to y's
    dtype once: ``silu(y*s + t + shortcut')`` (s, t [B, C], either None for
    none), ``shortcut'`` the shortcut as it is or, with ``shortcut_stats``,
    ``shortcut*s2 + t2`` from its statistics, scale and bias."""
    out = y.float()
    if s is not None:
        out = out * _per_channel(s, y)
    if t is not None:
        out = out + _per_channel(t, y)
    if shortcut_stats is None:
        out = out + shortcut.float()
    else:
        s2, t2 = affine(*channel_means(shortcut_stats), shortcut_scale, shortcut_bias, groups,
                        eps)
        out = out + shortcut.float() * _per_channel(s2, y) + _per_channel(t2, y)
    return F.silu(out).to(y.dtype)


# ---------------------------------------------------------------------------
# The kernels' contract and launches


def _check_map(x: torch.Tensor, name: str, addresses: bool = True) -> None:
    if x.dtype not in DTYPES or x.dim() < 3:
        raise TypeError(f"group_norm kernels take a bf16, fp16 or fp32 NHWC {name}, got "
                        f"{x.dtype} {tuple(x.shape)}")
    c = x.shape[-1]
    if c % 4 or c > MAX_CHANNELS:
        raise ValueError(f"group_norm kernels take C a multiple of 4 up to {MAX_CHANNELS}, "
                         f"got {name} with C = {c}")
    if not x.is_contiguous() or (addresses and x.data_ptr() % 16):
        raise ValueError(f"group_norm kernels take a contiguous, 16-byte aligned {name}")


def _check_stats(stats: torch.Tensor, x: torch.Tensor, name: str) -> None:
    b, hw, c = _dims(x)
    want = (b, num_slices(hw, c), 2, c)
    if stats.device != x.device or stats.dtype != torch.float32 \
            or tuple(stats.shape) != want or not stats.is_contiguous():
        raise ValueError(f"group_norm kernels take {name} as a contiguous {list(want)} fp32 "
                         f"tensor on {x.device}, got {tuple(stats.shape)} {stats.dtype} "
                         f"on {stats.device}")


def _check_vector(v: torch.Tensor, shape: Tuple[int, ...], x: torch.Tensor, name: str) -> None:
    if v.device != x.device or v.dtype != torch.float32 or tuple(v.shape) != shape \
            or not v.is_contiguous():
        raise ValueError(f"group_norm kernels take {name} as a contiguous {list(shape)} fp32 "
                         f"tensor on {x.device}, got {tuple(v.shape)} {v.dtype} on {v.device}")


def _check_groups(groups: int, c: int) -> None:
    if groups < 1 or c % groups:
        raise ValueError(f"group_norm kernels take groups dividing C = {c}, got {groups}")


_ARGTYPES = {
    "hvs_gn_stats": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "hvs_gn_apply": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "hvs_gn_apply_tail": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6
    + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
}


def _launch(entry: str, x: torch.Tensor, *args) -> None:
    """Launches ``entry`` on the current stream for the map ``x``, with its
    (B, HW, C, slices, type) and then ``args`` (tensors as their addresses,
    None as a null pointer)."""
    from .. import build

    fn = getattr(build.load("group_norm"), entry)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
    b, hw, c = _dims(x)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(ptrs[0], ptrs[1], b, hw, c, num_slices(hw, c), DTYPES[x.dtype], *ptrs[2:],
                 stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed with CUDA error {err}")


def _gn_stats_cuda(x: torch.Tensor) -> torch.Tensor:
    global launches_stats
    _check_map(x, "x")
    b, hw, c = _dims(x)
    stats = torch.empty(b, num_slices(hw, c), 2, c, dtype=torch.float32, device=x.device)
    if x.numel():
        _launch("hvs_gn_stats", x, x, stats)
        launches_stats += 1
    return stats


# The fake versions hold a CUDA map to the kernels' contract, as the CUDA
# versions do; a CPU map takes the plain versions, which take any map.


def _gn_stats_fake(x: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        _check_map(x, "x", addresses=False)
    b, hw, c = _dims(x)
    return x.new_empty(b, num_slices(hw, c), 2, c, dtype=torch.float32)


def _check_apply(x, stats, scale, bias, groups, addresses: bool = True) -> None:
    _check_map(x, "x", addresses)
    c = x.shape[-1]
    _check_stats(stats, x, "stats")
    _check_vector(scale, (c,), x, "scale")
    _check_vector(bias, (c,), x, "bias")
    _check_groups(groups, c)


def _gn_apply_cuda(x, stats, scale, bias, groups, eps, silu) -> torch.Tensor:
    global launches_apply
    _check_apply(x, stats, scale, bias, groups)
    out = torch.empty_like(x)
    if x.numel():
        _launch("hvs_gn_apply", x, x, out, stats, scale, bias, groups, eps, int(silu))
        launches_apply += 1
    return out


def _gn_apply_fake(x, stats, scale, bias, groups, eps, silu) -> torch.Tensor:
    if x.is_cuda:
        _check_apply(x, stats, scale, bias, groups, addresses=False)
    return torch.empty_like(x)


def _check_tail(y, s, t, shortcut, shortcut_stats, shortcut_scale, shortcut_bias,
                groups, addresses: bool = True) -> None:
    _check_map(y, "y", addresses)
    _check_map(shortcut, "shortcut", addresses)
    if shortcut.shape != y.shape or shortcut.device != y.device \
            or shortcut.dtype != y.dtype:
        raise ValueError(f"group_norm tail takes a shortcut shaped as y {tuple(y.shape)} "
                         f"{y.dtype} on {y.device}, got {tuple(shortcut.shape)} "
                         f"{shortcut.dtype} on {shortcut.device}")
    b, c = y.shape[0], y.shape[-1]
    for name, v in (("s", s), ("t", t)):
        if v is not None:
            _check_vector(v, (b, c), y, name)
    if shortcut_stats is not None:
        if shortcut_scale is None or shortcut_bias is None:
            raise ValueError("group_norm tail takes the shortcut's scale and bias with its stats")
        _check_stats(shortcut_stats, shortcut, "shortcut_stats")
        _check_vector(shortcut_scale, (c,), y, "shortcut_scale")
        _check_vector(shortcut_bias, (c,), y, "shortcut_bias")
        _check_groups(groups, c)


def _gn_apply_tail_cuda(y, s, t, shortcut, shortcut_stats, shortcut_scale, shortcut_bias,
                        groups, eps) -> torch.Tensor:
    global launches_apply
    _check_tail(y, s, t, shortcut, shortcut_stats, shortcut_scale, shortcut_bias, groups)
    out = torch.empty_like(y)
    if y.numel():
        _launch("hvs_gn_apply_tail", y, y, out, s, t, shortcut, shortcut_stats,
                shortcut_scale, shortcut_bias, groups, eps)
        launches_apply += 1
    return out


def _gn_apply_tail_fake(y, s, t, shortcut, shortcut_stats, shortcut_scale, shortcut_bias,
                        groups, eps) -> torch.Tensor:
    if y.is_cuda:
        _check_tail(y, s, t, shortcut, shortcut_stats, shortcut_scale, shortcut_bias, groups,
                    addresses=False)
    return torch.empty_like(y)


# The operators, registered through ``torch.library.Library`` as
# ``hvs::mhc_block`` is (ops/mhc_block.py says why not ``custom_op``).
_LIB = torch.library.Library("hvs", "FRAGMENT")
_LIB.define("gn_stats(Tensor x) -> Tensor")
_LIB.define("gn_apply(Tensor x, Tensor stats, Tensor scale, Tensor bias, int groups, "
            "float eps, bool silu) -> Tensor")
_LIB.define("gn_apply_tail(Tensor y, Tensor? s, Tensor? t, Tensor shortcut, "
            "Tensor? shortcut_stats, Tensor? shortcut_scale, Tensor? shortcut_bias, "
            "int groups, float eps) -> Tensor")
for _name, _cuda, _cpu, _fake in (
        ("gn_stats", _gn_stats_cuda, gn_stats_plain, _gn_stats_fake),
        ("gn_apply", _gn_apply_cuda, gn_apply_plain, _gn_apply_fake),
        ("gn_apply_tail", _gn_apply_tail_cuda, gn_apply_tail_plain, _gn_apply_tail_fake)):
    _LIB.impl(_name, _cuda, "CUDA")
    _LIB.impl(_name, _cpu, "CPU")
    torch.library.register_fake(f"hvs::{_name}", _fake, lib=_LIB)


def gn_stats(x: torch.Tensor) -> torch.Tensor:
    """Statistics of the NHWC map ``x`` through ``hvs::gn_stats``: [B, S, 2,
    C] fp32 partials whose sums over S are the per-channel means of x and x²
    (``channel_means``)."""
    return torch.ops.hvs.gn_stats.default(x.contiguous())


def gn_apply(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             groups: int, eps: float, silu: bool) -> torch.Tensor:
    """GroupNorm of ``x`` from its ``gn_stats``, with SiLU after it when
    ``silu``, through ``hvs::gn_apply``; x's dtype out."""
    return torch.ops.hvs.gn_apply.default(x.contiguous(), stats, scale, bias, groups, eps, silu)


def gn_apply_tail(y: torch.Tensor, s: Optional[torch.Tensor], t: Optional[torch.Tensor],
                  shortcut: torch.Tensor, shortcut_stats: Optional[torch.Tensor] = None,
                  shortcut_scale: Optional[torch.Tensor] = None,
                  shortcut_bias: Optional[torch.Tensor] = None, groups: int = 1,
                  eps: float = 0.0) -> torch.Tensor:
    """The folded serve tail (``gn_apply_tail_plain``) through
    ``hvs::gn_apply_tail``."""
    return torch.ops.hvs.gn_apply_tail.default(
        y.contiguous(), s, t, shortcut.contiguous(), shortcut_stats, shortcut_scale,
        shortcut_bias, groups, eps)
