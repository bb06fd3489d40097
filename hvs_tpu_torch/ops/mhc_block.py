"""Fused mHC block: the Hopper kernel's wrappers and their plain versions.

``mhc_block`` (serve mode) replaces the TPU kernel
``hvs_tpu/ops/pallas/mhc_pallas.py::mhc_block_pallas_packed`` (kernel body
``_mhc_packed_kernel``); ``mhc_block_unfolded`` replaces ``mhc_block_pallas``
(kernel body ``_mhc_kernel``), the chain with a separate ``@ H_pre`` that a
deterministic forward of the training model runs. Both are modes of one
CUDA source, ``hvs_tpu_torch/csrc/mhc_block.cu``, built with nvcc at first
use. Neither has a backward: training differentiates the plain chain.

Per token row: LN1 (fp32 statistics, eps 1e-6) -> ``@ W1_folded + b1`` -> GELU
(tanh) -> ``@ W2 + b2`` -> GELU -> ``@ H_post``; plus ``x @ H_res``; add; LN2.
bf16 operands, fp32 accumulation, a round to bf16 after LN1, after each
product, each bias add and each GELU; the residual sum and LN2 stay in fp32
(as XLA compiles the JAX layer and its Pallas kernels) and the output is
rounded once. The kernel's GELU
takes the exact fp32 tanh in the order of PyTorch's CUDA
``gelu(approximate="tanh")``, so it rounds the GELU to bf16 as the plain
version does in nearly every element.

The unfolded mode rounds ``LN1(x) @ H_pre`` to bf16 before ``@ W1``.

What bounds it on an H100: 8·N·d² FLOP (10·N·d² unfolded) against 4·N·d
activation bytes (+ ~8-10·d² weight bytes), about 2·d FLOP per byte, so it is memory-bound at
d <= 128 and tensor-core-bound at d >= 256 (the card's bf16 ridge is ~295
FLOP/byte). The kernel reads x once and writes the output once, keeps every
intermediate in shared memory, and runs the products on the tensor cores
(mma.sync) with the rounding, bias, GELU and residual epilogues in
registers; the [d, d] weights stream from L2 through a ring of k-chunks.
One block runs per tile of ``ROW_TILE[d]`` token rows. The source's header
says more.

Unlike the TPU path there is no batch or token gate: every eligible site
launches the kernel at every batch size.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

SUPPORTED_WIDTHS = (32, 64, 128, 256, 512)
# Token rows per block, threads per block, and the weight ring (rows per
# streamed chunk, chunks) of each width, as csrc/mhc_block.cu's Config<d>
# sets them.
ROW_TILE = {32: 128, 64: 128, 128: 64, 256: 64, 512: 32}
THREADS = 256
RING = {32: (32, 3), 64: (64, 3), 128: (64, 3), 256: (32, 2), 512: (16, 2)}

# Kernel launches in this process (CUDA tensors only): ``mhc_block`` (serve
# mode) and ``mhc_block_unfolded``.
launches = 0
launches_unfolded = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]


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
    y = layernorm(x, ln1_scale, ln1_bias).to(torch.bfloat16)
    return _chain(x, y, w1_folded, b1, w2, b2, h_post, h_res, ln2_scale, ln2_bias)


def mhc_block_unfolded_plain(x, h_pre, w1, b1, w2, b2, h_post, h_res,
                             ln1_scale, ln1_bias, ln2_scale, ln2_bias) -> torch.Tensor:
    """The unfolded kernel's function in plain PyTorch: ``LN1(x) @ H_pre``
    rounded to bf16, then the serve chain with ``w1`` in place of W1_folded."""
    y = _mm(layernorm(x, ln1_scale, ln1_bias), h_pre)
    return _chain(x, y, w1, b1, w2, b2, h_post, h_res, ln2_scale, ln2_bias)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` on bf16 operands, summed in fp32 and rounded to bf16 once,
    whatever the process's matmul flags: bf16 values are exact in fp32 and
    in TF32, so neither TF32 nor a reduced-precision bf16 reduction can
    change the product."""
    bf = torch.bfloat16
    return (a.to(bf).float() @ b.to(bf).float()).to(bf)


def _chain(x, y, w1, b1, w2, b2, h_post, h_res, ln2_scale, ln2_bias) -> torch.Tensor:
    bf = torch.bfloat16
    y = F.gelu(_mm(y, w1) + b1.to(bf), approximate="tanh")
    y = F.gelu(_mm(y, w2) + b2.to(bf), approximate="tanh")
    y = _mm(y, h_post)
    res = _mm(x, h_res)
    return layernorm(res.float() + y.float(), ln2_scale, ln2_bias).to(x.dtype)


# The kernels' operands after x, in the order of their C entry points; the
# vectors are [d] fp32, the rest [d, d] bf16.
SERVE_OPERANDS = ("w1_folded", "b1", "w2", "b2", "h_post", "h_res",
                  "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")
UNFOLDED_OPERANDS = ("h_pre", "w1") + SERVE_OPERANDS[1:]
_VECTORS = ("b1", "b2", "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")


def _check(x, names, args, addresses: bool = True) -> None:
    """The kernel's contract on x and its operands: dtypes, shapes, devices,
    contiguity, and (with ``addresses``; a fake tensor has none) 16-byte
    alignment of x and the matrices."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"mhc_block kernel takes bf16 x, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] not in SUPPORTED_WIDTHS:
        raise ValueError(
            f"mhc_block kernel takes x [N, d] with d in {SUPPORTED_WIDTHS}, got {tuple(x.shape)}"
        )
    if not x.is_contiguous() or (addresses and x.data_ptr() % 16):
        raise ValueError("mhc_block kernel takes a contiguous, 16-byte aligned x")
    d = x.shape[1]
    for name, t in zip(names, args):
        if name in _VECTORS:
            if t.device != x.device or t.dtype != torch.float32 or t.shape != (d,) \
                    or not t.is_contiguous():
                raise ValueError(
                    f"mhc_block kernel takes {name} as a contiguous [{d}] fp32 tensor on "
                    f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
                )
        elif t.device != x.device or t.dtype != torch.bfloat16 or t.shape != (d, d) \
                or not t.is_contiguous() or (addresses and t.data_ptr() % 16):
            raise ValueError(
                f"mhc_block kernel takes {name} as a contiguous [{d}, {d}] bf16 tensor on "
                f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
            )


def smem_bytes(d: int) -> int:
    """Dynamic shared memory of one block at width ``d``, as the source's
    ``Layout<d>::kSmemBytes``: the bf16 x and intermediate tiles and the
    weight ring (rows padded by 8 elements), or the fp32 residual sum that
    covers them at the end, whichever is larger."""
    bm, ld = ROW_TILE[d], d + 8
    kc, stages = RING[d]
    staged = 2 * bm * ld * 2 + min(d // kc, stages) * kc * ld * 2
    return max(staged, bm * ld * 4)


def launch_plan(n: int, d: int) -> dict:
    """Row tile, threads, grid (one block per tile) and dynamic shared memory
    of the launch for ``n`` rows of width ``d``."""
    bm = ROW_TILE[d]
    return {"bm": bm, "threads": THREADS, "grid": -(-n // bm), "smem": smem_bytes(d)}


def _launch(entry: str, x: torch.Tensor, names, args,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """Checks x and the operands ``args`` (named ``names``), then launches
    ``entry`` of the library on the current stream. ``out`` (default: a new
    tensor like x) may have more rows than x; the kernel writes only the
    first N."""
    if x.device.type != "cuda":
        raise ValueError(f"mhc_block runs on cuda or cpu tensors, got {x.device}")
    _check(x, names, args)
    n, d = x.shape
    if out is None:
        out = torch.empty_like(x)
    elif out.device != x.device or out.dtype != x.dtype or out.dim() != 2 \
            or out.shape[0] < n or out.shape[1] != d or not out.is_contiguous():
        raise ValueError(f"mhc_block out must be a contiguous [>= {n}, {d}] tensor like x")
    if n == 0:
        return out
    from .. import build

    fn = getattr(build.load("mhc_block"), entry)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES + [ctypes.c_void_p] * (len(args) + 1)
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), n, d, *[a.data_ptr() for a in args], stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed with CUDA error {err}")
    return out


# Serve mode as the operator ``hvs::mhc_block``, so that PyTorch knows it:
# ``torch.export`` traces through its fake version and records the operator
# in the program, and a loaded program launches the kernel through its CUDA
# version. The CPU version is the plain one. Registered through
# ``torch.library.Library`` rather than ``custom_op``, whose Python wrapper
# cost ~20 us more host time per call on an H100 host
# (scripts/torch_mhc_op_overhead.py).
_LIB = torch.library.Library("hvs", "DEF")
_LIB.define("mhc_block(Tensor x, Tensor w1_folded, Tensor b1, Tensor w2, Tensor b2, "
            "Tensor h_post, Tensor h_res, Tensor ln1_scale, Tensor ln1_bias, "
            "Tensor ln2_scale, Tensor ln2_bias) -> Tensor")


def _mhc_block_cuda(x, w1_folded, b1, w2, b2, h_post, h_res,
                    ln1_scale, ln1_bias, ln2_scale, ln2_bias) -> torch.Tensor:
    out = _launch("hvs_mhc_block", x, SERVE_OPERANDS,
                  (w1_folded, b1, w2, b2, h_post, h_res, ln1_scale, ln1_bias, ln2_scale,
                   ln2_bias))
    global launches
    launches += 1
    return out


def _mhc_block_fake(x, w1_folded, b1, w2, b2, h_post, h_res,
                    ln1_scale, ln1_bias, ln2_scale, ln2_bias) -> torch.Tensor:
    _check(x, SERVE_OPERANDS, (w1_folded, b1, w2, b2, h_post, h_res, ln1_scale, ln1_bias,
                               ln2_scale, ln2_bias), addresses=False)
    return torch.empty_like(x)


_LIB.impl("mhc_block", _mhc_block_cuda, "CUDA")
_LIB.impl("mhc_block", mhc_block_plain, "CPU")
torch.library.register_fake("hvs::mhc_block", _mhc_block_fake, lib=_LIB)
mhc_block_op = torch.ops.hvs.mhc_block.default


@register_flop_formula(torch.ops.hvs.mhc_block)
def _mhc_block_flops(x_shape, *operand_shapes, out_shape=None, **kwargs) -> int:
    """Four [N, d] x [d, d] products (W1_folded, W2, H_post, H_res): 8·N·d²
    (what ``torch.utils.flop_counter.FlopCounterMode`` counts for the operator)."""
    n, d = x_shape
    return 8 * n * d * d


def mhc_block(x, w1_folded, b1, w2, b2, h_post, h_res,
              ln1_scale, ln1_bias, ln2_scale, ln2_bias) -> torch.Tensor:
    """Fused serve-path mHC block on ``x`` [N, d], through ``hvs::mhc_block``.

    A CPU ``x`` takes the plain version. A CUDA ``x`` must be bf16 and
    contiguous, the matrices [d, d] bf16 and the vectors [d] fp32 on the same
    device; the kernel is launched on the current stream, or this raises.
    ``launches`` counts each launch, from here or from an exported program.
    """
    return mhc_block_op(x, w1_folded, b1, w2, b2, h_post, h_res,
                        ln1_scale, ln1_bias, ln2_scale, ln2_bias)


def mhc_block_unfolded(x, h_pre, w1, b1, w2, b2, h_post, h_res,
                       ln1_scale, ln1_bias, ln2_scale, ln2_bias) -> torch.Tensor:
    """Unfolded mHC block (``@ H_pre`` then ``@ W1``) on ``x`` [N, d].

    A CPU ``x`` takes the plain version. A CUDA ``x`` must be bf16 and
    contiguous, the five matrices [d, d] bf16 and the vectors [d] fp32 on the
    same device; the kernel is launched on the current stream, or this
    raises. The output carries no gradient.
    """
    if x.device.type == "cpu":
        return mhc_block_unfolded_plain(x, h_pre, w1, b1, w2, b2, h_post, h_res,
                                        ln1_scale, ln1_bias, ln2_scale, ln2_bias)
    out = _launch("hvs_mhc_block_unfolded", x, UNFOLDED_OPERANDS,
                  (h_pre, w1, b1, w2, b2, h_post, h_res, ln1_scale, ln1_bias, ln2_scale,
                   ln2_bias))
    global launches_unfolded
    launches_unfolded += 1
    return out
