"""Sinkhorn projection onto doubly stochastic matrices: the Hopper kernel's
wrapper (forward and backward) and its plain version.

Counterpart of ``hvs_tpu/ops/sinkhorn.py`` (``sinkhorn_log``,
``doubly_stochastic_error``) and replacement of the TPU kernel
``hvs_tpu/ops/pallas/sinkhorn_pallas.py::sinkhorn_log_pallas``. The CUDA
source is ``hvs_tpu_torch/csrc/sinkhorn.cu``; it is built with nvcc at first
use.

The log-domain loop runs in fp32 with a final row update, so row sums are
exact to fp32 and column sums converge geometrically with ``n_iters``. On the
serve path it runs once, at load (``models/constraints.py``); on the train
path every mHC forward, the manifold regulariser and the optimizer's periodic
projection run it, and the first two are differentiated.

The gradient is that of the UNROLLED loop, as ``jax.grad`` of the JAX
function gives (not the implicit gradient at the fixed point). The kernel's
forward stores the potentials f and g of every iteration; its backward walks
the iterations in reverse and rebuilds each softmax weight exp(x + f + g)
from them (the source's header has the recurrences).

What bounds it on an H100: about 2·n_iters + 2 passes over the matrix with
one exponential per element each, against 8·n² bytes in and out, so the
exponential unit (16 a clock per SM) bounds it; a matrix runs in one block on
one SM. The design keeps x in shared memory up to n = 128 and re-reads it
from L2 above that.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

MAX_KERNEL_N = 1024  # the kernel takes matrices up to this side

# Kernel launches in this process (CUDA tensors only), one per call.
launches_forward = 0
launches_backward = 0

_FWD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_void_p]


def sinkhorn_log_plain(logits: torch.Tensor, n_iters: int = 20, tau: float = 1.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch (differentiable by autograd).

    f_i <- -logsumexp_j(L_ij + g_j), g_j <- -logsumexp_i(L_ij + f_i), for
    ``n_iters`` rounds, then one more row update, then exp(L + f + g), with
    L = logits / tau. Computes in fp32 (fp64 for fp64 input, so that gradcheck
    can run on it); returns the input dtype.
    """
    in_dtype = logits.dtype
    x = logits.to(torch.promote_types(in_dtype, torch.float32)) / tau
    n = x.shape[-1]
    f = x.new_zeros(x.shape[:-2] + (n,))
    g = x.new_zeros(x.shape[:-2] + (n,))
    for _ in range(n_iters):
        f = -torch.logsumexp(x + g[..., None, :], dim=-1)
        g = -torch.logsumexp(x + f[..., :, None], dim=-2)
    f = -torch.logsumexp(x + g[..., None, :], dim=-1)
    return torch.exp(x + f[..., :, None] + g[..., None, :]).to(in_dtype)


def _check(name: str, t: torch.Tensor, shape=None) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"sinkhorn kernel takes fp32 {name}, got {t.dtype}")
    if t.dim() < 2 or t.shape[-1] != t.shape[-2] or not 1 <= t.shape[-1] <= MAX_KERNEL_N:
        raise ValueError(f"sinkhorn kernel takes {name} [..., n, n] with n <= {MAX_KERNEL_N}, "
                         f"got {tuple(t.shape)}")
    if shape is not None and t.shape != shape:
        raise ValueError(f"sinkhorn kernel: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"sinkhorn kernel takes a contiguous {name}")


def _library():
    from .. import build

    lib = build.load("sinkhorn")
    for fn, argtypes in ((lib.hvs_sinkhorn_forward, _FWD_ARGTYPES),
                         (lib.hvs_sinkhorn_backward, _BWD_ARGTYPES)):
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def sinkhorn_forward(logits: torch.Tensor, n_iters: int = 20, tau: float = 1.0,
                     keep_history: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the forward kernel on a CUDA fp32 ``logits`` [..., n, n].

    Returns (P, history); the history [..., 2·(n_iters + 1), n] holds
    f_1..f_{K+1} then g_0..g_K (K = n_iters) and is None unless
    ``keep_history``. Raises on anything the kernel does not take.
    """
    if logits.device.type != "cuda":
        raise ValueError(f"sinkhorn kernel runs on cuda tensors, got {logits.device}")
    _check("logits", logits)
    n = logits.shape[-1]
    batch = logits.numel() // (n * n)
    out = torch.empty_like(logits)
    hist = (torch.empty(logits.shape[:-2] + (2 * (n_iters + 1), n), dtype=torch.float32,
                        device=logits.device) if keep_history else None)
    if batch == 0:
        return out, hist
    fn = _library().hvs_sinkhorn_forward
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = fn(logits.data_ptr(), out.data_ptr(), 0 if hist is None else hist.data_ptr(),
                 batch, n, n_iters, float(tau), stream)
    if err != 0:
        raise RuntimeError(f"sinkhorn forward kernel launch failed with CUDA error {err}")
    global launches_forward
    launches_forward += 1
    return out, hist


def sinkhorn_backward(logits: torch.Tensor, p: torch.Tensor, dp: torch.Tensor,
                      hist: torch.Tensor, n_iters: int = 20, tau: float = 1.0) -> torch.Tensor:
    """One launch of the backward kernel: d loss / d logits from dP, given the
    forward's inputs, output and history (all CUDA fp32, contiguous)."""
    if logits.device.type != "cuda":
        raise ValueError(f"sinkhorn kernel runs on cuda tensors, got {logits.device}")
    _check("logits", logits)
    n = logits.shape[-1]
    _check("p", p, logits.shape)
    _check("dp", dp, logits.shape)
    want = logits.shape[:-2] + (2 * (n_iters + 1), n)
    if hist.dtype != torch.float32 or hist.shape != want or not hist.is_contiguous():
        raise ValueError(f"sinkhorn backward takes a contiguous fp32 history {tuple(want)}, "
                         f"got {tuple(hist.shape)} {hist.dtype}")
    for name, t in (("p", p), ("dp", dp), ("history", hist)):
        if t.device != logits.device:
            raise ValueError(f"sinkhorn backward: {name} is on {t.device}, logits on "
                             f"{logits.device}")
    batch = logits.numel() // (n * n)
    dlogits = torch.empty_like(logits)
    if batch == 0:
        return dlogits
    fn = _library().hvs_sinkhorn_backward
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = fn(logits.data_ptr(), p.data_ptr(), dp.data_ptr(), hist.data_ptr(),
                 dlogits.data_ptr(), batch, n, n_iters, float(tau), stream)
    if err != 0:
        raise RuntimeError(f"sinkhorn backward kernel launch failed with CUDA error {err}")
    global launches_backward
    launches_backward += 1
    return dlogits


class _SinkhornKernel(torch.autograd.Function):
    """Forward and backward through the Hopper kernels; the forward keeps the
    history of potentials for the backward."""

    @staticmethod
    def forward(ctx, logits, n_iters, tau):
        p, hist = sinkhorn_forward(logits, n_iters, tau, keep_history=True)
        ctx.n_iters, ctx.tau = n_iters, tau
        ctx.save_for_backward(logits, p, hist)
        return p

    @staticmethod
    def backward(ctx, dp):
        logits, p, hist = ctx.saved_tensors
        return sinkhorn_backward(logits, p, dp.contiguous(), hist, ctx.n_iters, ctx.tau), \
            None, None


def sinkhorn_log(logits: torch.Tensor, n_iters: int = 20, tau: float = 1.0) -> torch.Tensor:
    """Project ``logits`` [..., n, n] to a doubly stochastic matrix.

    A CPU tensor takes the plain version (autograd differentiates its loop).
    A CUDA tensor must be contiguous fp32 with n <= 1024: the forward kernel
    is launched, keeping its history only when autograd will need it (and
    the backward kernel runs when a gradient flows), or this raises.
    """
    if logits.device.type == "cpu":
        return sinkhorn_log_plain(logits, n_iters, tau)
    if logits.device.type != "cuda":
        raise ValueError(f"sinkhorn_log runs on cuda or cpu tensors, got {logits.device}")
    if torch.is_grad_enabled() and logits.requires_grad:
        return _SinkhornKernel.apply(logits, n_iters, tau)
    return sinkhorn_forward(logits, n_iters, tau)[0]


def doubly_stochastic_error(matrix: torch.Tensor) -> torch.Tensor:
    """Max |row sum - 1|, |col sum - 1| and negativity, per matrix."""
    m = matrix.float()
    row_err = (m.sum(dim=-1) - 1.0).abs().amax(dim=-1)
    col_err = (m.sum(dim=-2) - 1.0).abs().amax(dim=-1)
    neg_err = torch.clamp(-m, min=0.0).amax(dim=(-1, -2))
    return torch.maximum(torch.maximum(row_err, col_err), neg_err)
