"""Sinkhorn projection onto doubly stochastic matrices: the Hopper kernel's
wrapper (forward and backward), the grouped call over matrices of mixed
widths, and the plain version.

Counterpart of ``hvs_tpu/ops/sinkhorn.py`` (every function there) and
replacement of the TPU kernel
``hvs_tpu/ops/pallas/sinkhorn_pallas.py::sinkhorn_log_pallas``. The CUDA
source is ``hvs_tpu_torch/csrc/sinkhorn.cu``; it is built with nvcc at first
use. ``project_to_doubly_stochastic`` (``"log"``),
``sinkhorn_with_diagnostics`` and ``ops/manifold.py::birkhoff_project`` take
any float dtype, as JAX's do: they project in fp32 through ``sinkhorn_log``
(the kernel on a CUDA tensor, so n <= ``MAX_KERNEL_N`` there) and return the
input dtype. ``sinkhorn_knopp``, the multiplicative form, has no TPU kernel
behind it and stays plain PyTorch.

The log-domain loop runs in fp32 with a final row update, so row sums are
exact to fp32 and column sums converge geometrically with ``n_iters``. On the
serve path it runs once, at load (``models/constraints.py``); on the train
path every model forward, the manifold regulariser and the optimizer's
periodic projection run it, each through ``sinkhorn_log_many``: one launch
per matrix width. The model forward and the regulariser are differentiated.

The forward and the backward are the operators ``hvs::sinkhorn_log`` and
``hvs::sinkhorn_log_backward``: on the card they launch the kernels, on the
CPU they are the plain loop and autograd's gradient of it, so an operation
count (``utils/profiler.py``) sees the same calls on either device.

The gradient is that of the UNROLLED loop, as ``jax.grad`` of the JAX
function gives (not the implicit gradient at the fixed point). The kernel's
forward stores the potentials f and g of every iteration (in base 2: f·log2 e
and g·log2 e); its backward walks the iterations in reverse and rebuilds each
softmax weight exp(x + f + g) from them (the source's header has the
recurrences).

What bounds it on an H100: about 2·n_iters + 2 passes over the matrix with
one exponential per element each, against 8·n² bytes in and out, so the
exponential unit (16 a clock per SM) bounds it. Up to n = ``CLUSTER_MAX_N``
each matrix of a launch is held in shared memory by a thread-block cluster
(its rows split over the blocks, column reductions exchanged through
distributed shared memory); wider matrices take a streamed kernel, one block
per matrix re-reading x from L2. The choice is by n alone.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

MAX_KERNEL_N = 1024  # the kernel takes matrices up to this side
CLUSTER_MAX_N = 512  # cluster kernels up to this side, the streamed kernels above
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # blocks per matrix the cluster kernels take
MIN_ROWS_PER_BLOCK = 8  # below this a block's passes are all barriers and merges
_INVALID_VALUE = 1  # cudaErrorInvalidValue: the matrix does not fit such clusters

# Kernel launches in this process (CUDA tensors only), one per call.
launches_forward = 0
launches_backward = 0

_FWD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_PLAN_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int),
                                       ctypes.POINTER(ctypes.c_longlong),
                                       ctypes.POINTER(ctypes.c_int)]


def sinkhorn_log_plain(logits: torch.Tensor, n_iters: int = 20, tau: float = 1.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch (differentiable by autograd).

    f_i <- -logsumexp_j(L_ij + g_j), g_j <- -logsumexp_i(L_ij + f_i), for
    ``n_iters`` rounds, then one more row update, then exp(L + f + g), with
    L = logits / tau. Computes in fp32 (fp64 for fp64 input, so that gradcheck
    can run on it); returns the input dtype.
    """
    return _plain_loop(logits, n_iters, tau, False)[0]


def _plain_loop(logits: torch.Tensor, n_iters: int, tau: float, keep_history: bool
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``sinkhorn_log_plain`` and, with ``keep_history``, the potentials in
    the kernel's layout: [..., 2·(n_iters + 1), n], f_1..f_{K+1} then
    g_0..g_K, each times log2 e, in the computing dtype."""
    in_dtype = logits.dtype
    x = logits.to(torch.promote_types(in_dtype, torch.float32)) / tau
    n = x.shape[-1]
    f = x.new_zeros(x.shape[:-2] + (n,))
    g = x.new_zeros(x.shape[:-2] + (n,))
    fs, gs = [], [g]
    for _ in range(n_iters):
        f = -torch.logsumexp(x + g[..., None, :], dim=-1)
        g = -torch.logsumexp(x + f[..., :, None], dim=-2)
        fs.append(f)
        gs.append(g)
    f = -torch.logsumexp(x + g[..., None, :], dim=-1)
    fs.append(f)
    p = torch.exp(x + f[..., :, None] + g[..., None, :]).to(in_dtype)
    hist = torch.stack(fs + gs, dim=-2) * math.log2(math.e) if keep_history else None
    return p, hist


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
                         (lib.hvs_sinkhorn_backward, _BWD_ARGTYPES),
                         (lib.hvs_sinkhorn_plan, _PLAN_ARGTYPES)):
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _plan(device: int, n: int, backward: bool, cluster: int) -> Optional[Tuple[int, int, int]]:
    """(blocks per matrix, shared memory bytes per block, clusters the card
    holds at once) of a launch on CUDA device ``device``; None when the
    matrix does not fit clusters of that size."""
    c, smem, active = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_int()
    with torch.cuda.device(device):
        err = _library().hvs_sinkhorn_plan(n, int(backward), cluster, ctypes.byref(c),
                                           ctypes.byref(smem), ctypes.byref(active))
    if err == _INVALID_VALUE:
        return None
    if err != 0:
        raise RuntimeError(f"sinkhorn launch plan for n={n} failed with CUDA error {err}")
    return c.value, smem.value, active.value


def _device_index(device: Union[torch.device, int, None]) -> int:
    if isinstance(device, int):
        return device
    if device is None or device.index is None:
        return torch.cuda.current_device()
    return device.index


def cluster_size(n: int, batch: int, backward: bool = False,
                 device: Union[torch.device, int, None] = None) -> int:
    """Blocks per matrix of a launch of ``batch`` [n, n] matrices: 1 above
    ``CLUSTER_MAX_N`` (the streamed kernels); else the largest size of
    ``CLUSTER_SIZES`` with at least ``MIN_ROWS_PER_BLOCK`` rows per block
    whose ``batch`` clusters the card holds at once, or, when none does, the
    smallest size that fits (the most matrices at once). The sizes are
    those the cluster sweep (``scripts/torch_sinkhorn_clusters.py``) found
    fastest on the H100 at the flagship's widths."""
    if n > CLUSTER_MAX_N:
        return 1
    dev = _device_index(device)
    fits = [c for c in CLUSTER_SIZES if (_plan(dev, n, backward, c) or (0, 0, 0))[2] >= 1]
    if not fits:
        raise RuntimeError(f"sinkhorn kernel: no cluster size fits n={n} on device {dev}")
    for c in reversed(fits):
        if n >= MIN_ROWS_PER_BLOCK * c and _plan(dev, n, backward, c)[2] >= batch:
            return c
    return fits[0]


def launch_plan(n: int, backward: bool = False, cluster: int = 0,
                batch: int = 1) -> Dict[str, int]:
    """How a launch of ``batch`` matrices at width ``n`` runs on the current
    CUDA device: blocks per matrix (``cluster``: the given size, or
    ``cluster_size``'s when 0; 1 for the streamed kernels), dynamic shared
    memory per block, and how many such clusters the card holds at once
    (``max_active_clusters``; for the streamed kernels, blocks per SM).
    Raises if the matrix does not fit clusters of the given size."""
    dev = torch.cuda.current_device()
    c = cluster or cluster_size(n, batch, backward, dev)
    plan = _plan(dev, n, backward, c)
    if plan is None:
        raise RuntimeError(f"sinkhorn kernel: n={n} does not fit clusters of {c} blocks")
    return {"cluster": plan[0], "smem_bytes": plan[1], "max_active_clusters": plan[2]}


def sinkhorn_forward(logits: torch.Tensor, n_iters: int = 20, tau: float = 1.0,
                     keep_history: bool = False, cluster: int = 0
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the forward kernel on a CUDA fp32 ``logits`` [..., n, n].

    Returns (P, history); the history [..., 2·(n_iters + 1), n] holds the
    base-2 potentials f_1..f_{K+1} then g_0..g_K (K = n_iters, each times
    log2 e) and is None unless ``keep_history``. ``cluster`` > 0 asks for
    that many blocks per matrix instead of ``cluster_size``'s (for tuning;
    n <= ``CLUSTER_MAX_N``). Raises on anything the kernel does not take.
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
    cluster = cluster or cluster_size(n, batch, False, logits.device)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = fn(logits.data_ptr(), out.data_ptr(), 0 if hist is None else hist.data_ptr(),
                 batch, n, n_iters, float(tau), cluster, stream)
    if err != 0:
        raise RuntimeError(f"sinkhorn forward kernel launch failed with CUDA error {err}")
    global launches_forward
    launches_forward += 1
    return out, hist


def sinkhorn_backward(logits: torch.Tensor, p: torch.Tensor, dp: torch.Tensor,
                      hist: torch.Tensor, n_iters: int = 20, tau: float = 1.0,
                      cluster: int = 0) -> torch.Tensor:
    """One launch of the backward kernel: d loss / d logits from dP, given the
    forward's inputs, output and history (all CUDA fp32, contiguous);
    ``cluster`` as in ``sinkhorn_forward``."""
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
    cluster = cluster or cluster_size(n, batch, True, logits.device)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = fn(logits.data_ptr(), p.data_ptr(), dp.data_ptr(), hist.data_ptr(),
                 dlogits.data_ptr(), batch, n, n_iters, float(tau), cluster, stream)
    if err != 0:
        raise RuntimeError(f"sinkhorn backward kernel launch failed with CUDA error {err}")
    global launches_backward
    launches_backward += 1
    return dlogits


# Forward and backward as the operators ``hvs::sinkhorn_log`` and
# ``hvs::sinkhorn_log_backward``: their CUDA versions launch the kernels,
# their CPU versions are the plain loop and autograd's gradient of it, so an
# operation count sees the same calls, with the same inputs and outputs, on
# either device. ``keep_history`` False gives an empty history.
_LIB = torch.library.Library("hvs", "FRAGMENT")
_LIB.define("sinkhorn_log(Tensor logits, int n_iters, float tau, bool keep_history) "
            "-> (Tensor, Tensor)")
_LIB.define("sinkhorn_log_backward(Tensor logits, Tensor p, Tensor dp, Tensor history, "
            "int n_iters, float tau) -> Tensor")


def _history_shape(logits: torch.Tensor, n_iters: int) -> Tuple[int, ...]:
    return tuple(logits.shape[:-2]) + (2 * (n_iters + 1), logits.shape[-1])


def _forward_cuda(logits, n_iters, tau, keep_history):
    p, hist = sinkhorn_forward(logits, n_iters, tau, keep_history=keep_history)
    return p, hist if hist is not None else logits.new_empty(0)


def _autograd_keys():
    """Autograd's dispatch keys back in force: below a dispatch mode (an
    operation count) they are excluded, and the CPU versions differentiate
    the plain loop."""
    key = torch._C.DispatchKey
    exclude = torch._C._dispatch_tls_local_exclude_set().remove(key.AutogradCPU) \
        .remove(key.AutogradOther).remove(key.ADInplaceOrView)
    return torch._C._ForceDispatchKeyGuard(torch._C._dispatch_tls_local_include_set(), exclude)


def _forward_cpu(logits, n_iters, tau, keep_history):
    if not keep_history:
        return _plain_loop(logits, n_iters, tau, False)[0], logits.new_empty(0)
    # A backward will follow: keep autograd's graph of the plain loop on the
    # history it returns, so the backward differentiates it without a second
    # forward (the same gradient, bitwise).
    with _autograd_keys(), torch.enable_grad():
        x = logits.detach().requires_grad_(True)
        p, hist = _plain_loop(x, n_iters, tau, True)
    hist = hist.detach()
    hist._plain_graph = (x, p)
    return p.detach(), hist


def _forward_fake(logits, n_iters, tau, keep_history):
    hist = logits.new_empty(_history_shape(logits, n_iters) if keep_history else (0,))
    return torch.empty_like(logits), hist


def _backward_cpu(logits, p, dp, history, n_iters, tau):
    """Autograd's gradient of the plain loop: of the graph the forward kept
    on ``history``, else of a forward run again."""
    x, out = getattr(history, "_plain_graph", (None, None))
    if x is not None:
        del history._plain_graph  # autograd frees the graph with this backward
    with _autograd_keys(), torch.enable_grad():
        if x is None or x.shape != logits.shape:
            x = logits.detach().requires_grad_(True)
            out = sinkhorn_log_plain(x, n_iters, tau)
        return torch.autograd.grad(out, x, dp)[0]


def _backward_fake(logits, p, dp, history, n_iters, tau):
    return torch.empty_like(logits)


_LIB.impl("sinkhorn_log", _forward_cuda, "CUDA")
_LIB.impl("sinkhorn_log", _forward_cpu, "CPU")
torch.library.register_fake("hvs::sinkhorn_log", _forward_fake, lib=_LIB)
_LIB.impl("sinkhorn_log_backward", sinkhorn_backward, "CUDA")
_LIB.impl("sinkhorn_log_backward", _backward_cpu, "CPU")
torch.library.register_fake("hvs::sinkhorn_log_backward", _backward_fake, lib=_LIB)
sinkhorn_log_op = torch.ops.hvs.sinkhorn_log.default
sinkhorn_log_backward_op = torch.ops.hvs.sinkhorn_log_backward.default


def transcendentals(func, args) -> int:
    """The exponentials of one call of B's operators (0 for any other
    operator): (2·n_iters + 2)·n² per matrix forward (42·n² at 20
    iterations), 2·n_iters·n² backward (40·n²), the counts the kernel
    table's bound uses."""
    if func is sinkhorn_log_op:
        logits, n_iters = args[0], args[1]
        return (2 * n_iters + 2) * logits.numel()
    if func is sinkhorn_log_backward_op:
        logits, n_iters = args[0], args[4]
        return 2 * n_iters * logits.numel()
    return 0


class _SinkhornKernel(torch.autograd.Function):
    """Forward and backward through B's operators; the forward keeps the
    history of potentials for the backward."""

    @staticmethod
    def forward(ctx, logits, n_iters, tau):
        p, hist = sinkhorn_log_op(logits, n_iters, tau, True)
        ctx.n_iters, ctx.tau = n_iters, tau
        ctx.save_for_backward(logits, p, hist)
        return p

    @staticmethod
    def backward(ctx, dp):
        logits, p, hist = ctx.saved_tensors
        return sinkhorn_log_backward_op(logits, p, dp.contiguous(), hist, ctx.n_iters,
                                        ctx.tau), None, None


def sinkhorn_log(logits: torch.Tensor, n_iters: int = 20, tau: float = 1.0) -> torch.Tensor:
    """Project ``logits`` [..., n, n] to a doubly stochastic matrix, through
    ``hvs::sinkhorn_log`` (and ``hvs::sinkhorn_log_backward`` when a
    gradient flows).

    A CPU tensor takes the plain version and its autograd gradient. A CUDA
    tensor must be contiguous fp32 with n <= 1024: the forward kernel is
    launched, keeping its history only when autograd will need it (and the
    backward kernel runs when a gradient flows), or this raises.
    """
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sinkhorn_log runs on cuda or cpu tensors, got {logits.device}")
    if torch.is_grad_enabled() and logits.requires_grad:
        return _SinkhornKernel.apply(logits, n_iters, tau)
    return sinkhorn_log_op(logits, n_iters, tau, False)[0]


def sinkhorn_log_many(mats: Sequence[torch.Tensor], n_iters: int = 20,
                      tau: float = 1.0) -> List[torch.Tensor]:
    """Project each [n, n] matrix of ``mats`` (widths may differ): the
    matrices of one width are stacked and go through ``sinkhorn_log``
    together, so on the card each width is one forward launch (and, when a
    gradient flows, one backward launch). Returns the projections in the
    order of ``mats``; gradients reach each input through the stack."""
    by_width: Dict[int, List[int]] = {}
    for i, m in enumerate(mats):
        by_width.setdefault(m.shape[-1], []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(mats)
    for idx in by_width.values():
        projected = sinkhorn_log(torch.stack([mats[i] for i in idx]), n_iters, tau)
        for k, i in enumerate(idx):
            out[i] = projected[k]
    return out


def doubly_stochastic_error(matrix: torch.Tensor) -> torch.Tensor:
    """Max |row sum - 1|, |col sum - 1| and negativity, per matrix."""
    m = matrix.float()
    row_err = (m.sum(dim=-1) - 1.0).abs().amax(dim=-1)
    col_err = (m.sum(dim=-2) - 1.0).abs().amax(dim=-1)
    neg_err = torch.clamp(-m, min=0.0).amax(dim=(-1, -2))
    return torch.maximum(torch.maximum(row_err, col_err), neg_err)


def sinkhorn_log_fp32(logits: torch.Tensor, n_iters: int = 20, tau: float = 1.0) -> torch.Tensor:
    """``sinkhorn_log`` for any float dtype, as JAX's: the projection in fp32
    (contiguous, so a CUDA tensor takes the kernel) and the result in the
    input dtype. Raises on the card above ``MAX_KERNEL_N``."""
    return sinkhorn_log(logits.float().contiguous(), n_iters, tau).to(logits.dtype)


def sinkhorn_knopp(matrix: torch.Tensor, n_iters: int = 20, tau: float = 1.0,
                   eps: float = 1e-8) -> torch.Tensor:
    """Multiplicative Sinkhorn-Knopp: ``softmax(M / tau) * n``, then
    ``n_iters`` rounds of a row and a column division (each sum + ``eps``),
    in fp32; returns the input dtype."""
    x = matrix.float() / tau
    p = torch.softmax(x, dim=-1) * x.shape[-1]
    for _ in range(n_iters):
        p = p / (p.sum(dim=-1, keepdim=True) + eps)
        p = p / (p.sum(dim=-2, keepdim=True) + eps)
    return p.to(matrix.dtype)


def project_to_doubly_stochastic(matrix: torch.Tensor, n_iters: int = 20, tau: float = 1.0,
                                 method: str = "log") -> torch.Tensor:
    """``"log"``: ``sinkhorn_log_fp32`` (kernel B on the card);
    ``"multiplicative"``: ``sinkhorn_knopp``."""
    if method == "log":
        return sinkhorn_log_fp32(matrix, n_iters, tau)
    if method == "multiplicative":
        return sinkhorn_knopp(matrix, n_iters, tau)
    raise ValueError(f"unknown sinkhorn method: {method!r}")


def sinkhorn_regularization_loss(raw_matrix: torch.Tensor, n_iters: int = 20,
                                 target_weight: float = 1.0,
                                 negativity_weight: float = 1.0) -> torch.Tensor:
    """Soft doubly stochastic penalty on an unconstrained matrix: the mean
    squared deviation of row and column sums from 1, plus the mean squared
    negative part (``n_iters`` is unused, as in JAX)."""
    del n_iters
    m = raw_matrix.float()
    row = ((m.sum(dim=-1) - 1.0) ** 2).mean()
    col = ((m.sum(dim=-2) - 1.0) ** 2).mean()
    neg = (torch.relu(-m) ** 2).mean()
    return target_weight * (row + col) + negativity_weight * neg


def sinkhorn_with_diagnostics(logits: torch.Tensor, n_iters: int = 20, tau: float = 1.0
                              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The projection (``sinkhorn_log_fp32``) and its convergence: the
    ``doubly_stochastic_error`` per matrix, the largest row and column sum
    errors and the smallest entry over all matrices."""
    p = sinkhorn_log_fp32(logits, n_iters, tau)
    return p, {
        "ds_error": doubly_stochastic_error(p),
        "row_sum_error": (p.sum(dim=-1) - 1.0).abs().amax(),
        "col_sum_error": (p.sum(dim=-2) - 1.0).abs().amax(),
        "min_entry": p.amin(),
    }
