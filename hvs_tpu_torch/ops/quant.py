"""Int8 post-training quantization of the serve path (W8A8).

Counterpart of ``hvs_tpu/ops/quant.py``, with its functions and its
arithmetic: activations take one symmetric per-tensor scale, calibrated
offline as max|x| over a calibration set (``calib_maxabs``, merged by max or
by percentile, times a margin); weights take one symmetric scale per output
channel. Codes are ``clip(round(x·(127/max(s, 1e-8))), -127, 127)`` in fp32,
rounding half to even. Products multiply int8 by int8 into int32
accumulators, which are rescaled once by ``(a_s/127)·(w_scale/127)`` in fp32
and cast to the output dtype.

Every division is of two tensors (``_div``), so that each quotient is
correctly rounded, as JAX's are: the codes then come out equal.

Layouts: convolution kernels are OIHW here (HWIO in JAX) and dense kernels
[in, out], so the per-channel weight scale is the max over axes (1, 2, 3) of
a conv kernel and over axis 0 of a dense one. A prepared weight
(``prepare_conv_weight``, ``prepare_dense_weight``) is ``(q, scale)`` with
``q`` int8 [N, K]: one row per output channel, in the order of the
activation's im2col columns ((kh, kw, C_in) for a convolution). It depends on
the weights only, so the serve model computes it once at load.

Products (``int_mm``): on a CUDA tensor, ``torch._int_mm`` (int8 tensor-core
GEMM into int32), with M, K and N padded by zero rows and columns where they
fall outside its limits (zero is exact in int8 under a symmetric scale);
``launches`` counts its calls. On a CPU tensor, the plain version
(``int_mm_plain``): the exact integer product. The accumulators are equal.
There is no product of dequantized values on either path. A convolution is
the product over an int8 im2col of its input with XLA's SAME pads (a
stride-2 3x3 conv over an even size pads (0, 1)).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

INT8_MAX = 127.0

# torch._int_mm's limits on CUDA: M > 16, K and N multiples of 8.
_MIN_M = 17
_ALIGN = 8

# Calls of torch._int_mm on CUDA tensors in this process.
launches = 0


def calib_maxabs(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor max|x| in fp32: the statistic every int8 site records."""
    return x.float().abs().amax()


def _clamped(scale) -> torch.Tensor:
    return torch.as_tensor(scale, dtype=torch.float32).clamp_min(1e-8)


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` correctly rounded, with 127 for a number: torch computes a
    number over a tensor as a reciprocal times the number, and on CUDA a
    tensor over a number as a product with its reciprocal; both can miss
    the quotient by an ulp, and a code by one, against JAX's division."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return a / b


def quantize_tensor(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric per-tensor int8: ``clip(round(x·(127/max(scale, 1e-8))))``."""
    s = _clamped(scale)
    q = torch.round(x.float() * _div(INT8_MAX, s))
    return q.clamp(-INT8_MAX, INT8_MAX).to(torch.int8)


def dequantize_tensor(q: torch.Tensor, scale, dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """Inverse of :func:`quantize_tensor`."""
    s = _clamped(scale)
    return (q.float() * _div(s, INT8_MAX)).to(dtype)


def quantize_weight_per_channel(kernel: torch.Tensor, out_axis: int = 0
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 weights, in the kernel's layout.

    ``out_axis`` is the output-channel axis: 0 for the port's OIHW conv
    kernels, -1 for [in, out] dense kernels. Returns ``(q int8, scale fp32
    [C_out])``, ``scale`` being max|w| over every other axis; a dead
    (all-zero) channel gets scale 1.
    """
    k32 = kernel.float()
    out_axis %= k32.dim()
    axes = tuple(a for a in range(k32.dim()) if a != out_axis)
    w_scale = k32.abs().amax(dim=axes)
    w_scale = torch.where(w_scale > 0, w_scale, torch.ones_like(w_scale))
    shape = [1] * k32.dim()
    shape[out_axis] = -1
    q = torch.round(k32 * _div(INT8_MAX, w_scale).reshape(shape))
    return q.clamp(-INT8_MAX, INT8_MAX).to(torch.int8), w_scale


def prepare_conv_weight(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """An OIHW conv kernel as ``(q [O, kh·kw·I] int8, scale [O])``."""
    q, scale = quantize_weight_per_channel(kernel, 0)
    return q.permute(0, 2, 3, 1).reshape(q.shape[0], -1).contiguous(), scale


def prepare_dense_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A dense [K, N] kernel as ``(q [N, K] int8, scale [N])``."""
    q, scale = quantize_weight_per_channel(w, -1)
    return q.t().contiguous(), scale


def int_mm_plain(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """The exact integer product ``a @ b_t.T`` (int8 [M, K] by int8 [N, K]
    into int32 [M, N]), computed on the CPU."""
    return torch._int_mm(a.cpu().contiguous(), b_t.cpu().t())


def _pad_dim(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    extra = size - t.shape[dim]
    if extra <= 0:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, extra]
    return F.pad(t, pad)


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """``a @ b_t.T``: int8 [M, K] by int8 [N, K] into int32 [M, N].

    On a CUDA tensor, ``torch._int_mm`` (counted in ``launches``), with zero
    padding to its limits; a failed call raises. On a CPU tensor, the plain
    version. Nothing here computes in floating point."""
    if a.dtype != torch.int8 or b_t.dtype != torch.int8:
        raise TypeError(f"int_mm takes int8 operands, got {a.dtype} and {b_t.dtype}")
    m, k = a.shape
    n = b_t.shape[0]
    if b_t.shape[1] != k:
        raise ValueError(f"int_mm: a is [{m}, {k}] but b_t is {tuple(b_t.shape)}")
    if a.device.type == "cpu":
        return int_mm_plain(a, b_t)
    if a.device.type != "cuda" or b_t.device != a.device:
        raise ValueError(f"int_mm runs on cuda or cpu tensors, got {a.device} and {b_t.device}")
    kp = -(-k // _ALIGN) * _ALIGN
    np_ = -(-n // _ALIGN) * _ALIGN
    a_p = _pad_dim(_pad_dim(a, 1, kp), 0, _MIN_M).contiguous()
    b_p = _pad_dim(_pad_dim(b_t, 1, kp), 0, np_)
    out = torch._int_mm(a_p, b_p.t())
    global launches
    launches += 1
    if out.shape != (m, n):
        out = out[:m, :n]
    return out


def _rescale(acc: torch.Tensor, act_scale, w_scale: torch.Tensor,
             out_dtype: torch.dtype) -> torch.Tensor:
    rescale = _div(_clamped(act_scale), INT8_MAX) * _div(w_scale, INT8_MAX)
    return (acc.float() * rescale).to(out_dtype)


def im2col(x_q: torch.Tensor, kernel_size: Sequence[int], strides: Sequence[int]
           ) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """An NHWC int8 map as its [B·Ho·Wo, kh·kw·C] patches under SAME
    padding; returns them with (B, Ho, Wo)."""
    from ..models.layers import same_padding

    kh, kw = kernel_size
    sh, sw = strides
    b, h, w, c = x_q.shape
    (pt, pb), (pl, pr) = same_padding(h, kh, sh), same_padding(w, kw, sw)
    if (kh, kw, sh, sw) == (1, 1, 1, 1):
        return x_q.reshape(-1, c), (b, h, w)
    xp = F.pad(x_q, (0, 0, pl, pr, pt, pb)).contiguous()
    hp, wp = h + pt + pb, w + pl + pr
    ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    s_b, s_h, s_w, s_c = xp.stride()
    patches = xp.as_strided((b, ho, wo, kh, kw, c), (s_b, s_h * sh, s_w * sw, s_h, s_w, s_c))
    return patches.reshape(b * ho * wo, kh * kw * c), (b, ho, wo)


def conv_int8_prepared(x_q: torch.Tensor, q: torch.Tensor, w_scale: torch.Tensor, act_scale,
                       kernel_size: Sequence[int], strides: Sequence[int] = (1, 1),
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 NHWC activation (quantized with ``act_scale``) conv a prepared
    weight (``prepare_conv_weight``), SAME padding; fp output [B, Ho, Wo, O]."""
    cols, (b, ho, wo) = im2col(x_q, kernel_size, strides)
    acc = int_mm(cols, q)
    return _rescale(acc, act_scale, w_scale, out_dtype).reshape(b, ho, wo, q.shape[0])


def conv_int8(x_q: torch.Tensor, kernel: torch.Tensor, act_scale,
              strides: Sequence[int] = (1, 1), out_dtype: torch.dtype = torch.bfloat16
              ) -> torch.Tensor:
    """int8 activation conv the float OIHW ``kernel`` (quantized per output
    channel here), as JAX's ``conv_int8`` on the HWIO kernel."""
    q, w_scale = prepare_conv_weight(kernel)
    return conv_int8_prepared(x_q, q, w_scale, act_scale, kernel.shape[2:], strides, out_dtype)


def matmul_int8_prepared(x_q: torch.Tensor, q: torch.Tensor, w_scale: torch.Tensor, act_scale,
                         out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 activation [..., K] times a prepared weight
    (``prepare_dense_weight``); fp output [..., N]."""
    lead = x_q.shape[:-1]
    acc = int_mm(x_q.reshape(-1, x_q.shape[-1]), q)
    return _rescale(acc, act_scale, w_scale, out_dtype).reshape(*lead, q.shape[0])


def matmul_int8(x_q: torch.Tensor, w: torch.Tensor, act_scale,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 activation [..., K] times the float [K, N] matrix ``w``
    (quantized per output column here), as JAX's ``matmul_int8``."""
    q, w_scale = prepare_dense_weight(w)
    return matmul_int8_prepared(x_q, q, w_scale, act_scale, out_dtype)


def quantization_error(x: torch.Tensor, scale) -> torch.Tensor:
    """Mean |x - dequant(quant(x))|: the calibration's quality on ``x``."""
    q = quantize_tensor(x, scale)
    return (x.float() - dequantize_tensor(q, scale, torch.float32)).abs().mean()


# ---------------------------------------------------------------------------
# Calibration statistics. The port keeps them flat, {dotted site name:
# value}; the names are the flax paths of the ``quant`` collection.

Stats = Dict[str, torch.Tensor]


def build_quant_collection(stats: Dict[str, object], margin: float = 1.0) -> Stats:
    """Scales from merged statistics: each site's value (the max, where a
    site holds several) times ``margin``, as fp32 scalars."""
    out = {}
    for name, value in stats.items():
        values = value if isinstance(value, (tuple, list)) else (value,)
        out[name] = torch.tensor(max(float(v) for v in values) * margin, dtype=torch.float32)
    return out


def _check_sites(trees: Sequence[Stats]) -> List[str]:
    names = sorted(trees[0])
    for t in trees[1:]:
        if sorted(t) != names:
            raise ValueError("calibration batches recorded different sites: "
                             f"{sorted(set(t) ^ set(names))[:8]}")
    return names


def merge_max_stats(trees: Sequence[Stats]) -> Stats:
    """Site by site, the max over the calibration batches' statistics."""
    if not trees:
        return {}
    return {name: torch.stack([torch.as_tensor(t[name], dtype=torch.float32)
                               for t in trees]).amax()
            for name in _check_sites(trees)}


def merge_percentile_stats(trees: Sequence[Stats], percentile: float = 99.0) -> Stats:
    """Site by site, a percentile (linear interpolation, as
    ``jnp.percentile``) of the batches' max-abs values: one outlier batch
    then does not widen a site's range for every other."""
    if not trees:
        return {}
    return {name: torch.quantile(torch.stack([torch.as_tensor(t[name], dtype=torch.float32)
                                              for t in trees]), percentile / 100.0)
            for name in _check_sites(trees)}
