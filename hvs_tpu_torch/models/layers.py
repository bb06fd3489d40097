"""Core layers: mHC (serve and training branches), Dense, Conv,
ConvTranspose, their int8 twins ``QuantDense`` and ``QuantConv``, the norms
(LayerNorm, GroupNorm, RMSNorm), SqueezeExcite, attention (dense, and with mHC
projections), dropout.

Counterpart of ``hvs_tpu/models/layers.py``. Public layouts follow the JAX
package: feature maps are NHWC, dense kernels are [d_in, d_out] applied as
``x @ W``. Parameters keep the flax names (and the flax auto-names of
submodules, such as ``GroupNorm_0`` or ``Dense_1``), so ``convert.py`` maps a
flax tree onto these modules path for path. Parameters are fp32; each layer
computes in its ``dtype``, with fp32 statistics and softmax, as the JAX
layers do.

``ManifoldHyperConnection`` has both branches of the JAX layer, selected by
``precomputed_constraints``. Serve (True): the constrained matrices are
computed once at load (``constraints.py``) and bf16 sites with
``expansion_rate == 1`` and ``mlp_ratio == 1`` run the fused serve block.
Training (False): every forward computes them (Sinkhorn through its Hopper
kernel), applies dropout in train mode and records telemetry when
``monitor`` is set; in eval mode without autograd the same sites run the
unfolded block. Each block is the Hopper kernel on a CUDA tensor and its
plain version on a CPU tensor (``ops/mhc_block.py``). Torch's ``training``
flag plays the part of JAX's ``deterministic=False``.

int8 serving (W8A8, ``ops/quant.py``): a module with int8 sites
(``QuantSites``) names the activations it can quantize. While it
calibrates (``models/quantize.py``) it records each one's max|x| and runs
the float path; a module built with its ``act_quant`` flag reads each
site's calibrated scale from a device buffer of that name and multiplies
int8 by int8. The serve-mode mHC layer under ``act_quant`` runs the int8
chain in place of the fused block.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mhc_block import SUPPORTED_WIDTHS, layernorm as _layernorm, mhc_block, \
    mhc_block_unfolded
from ..ops.quant import calib_maxabs, conv_int8_prepared, matmul_int8_prepared, \
    prepare_conv_weight, prepare_dense_weight, quantize_tensor
from ..ops.sinkhorn import doubly_stochastic_error, sinkhorn_log
from ..parallel.tensor import column_parallel, gather, row_parallel, split

Generator = Optional[torch.Generator]


# ---------------------------------------------------------------------------
# Initializers (the flax defaults the JAX package uses). They draw from an
# explicit generator; the numbers differ from JAX's for the same seed.


def lecun_normal_(t: torch.Tensor, fan_in: int, g: Generator) -> None:
    """flax ``lecun_normal``: truncated normal (±2σ) with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
        t.mul_(std)


def h_init_(t: torch.Tensor, g: Generator, gain: float = 0.1) -> None:
    """``variance_scaling(gain, "fan_avg", "uniform")`` for an mHC matrix."""
    fan_in, fan_out = t.shape[-2], t.shape[-1]
    limit = math.sqrt(3.0 * gain / ((fan_in + fan_out) / 2.0))
    with torch.no_grad():
        t.uniform_(-limit, limit, generator=g)


def init_weights(model: nn.Module, seed: int = 0) -> None:
    """Seeded init of every parameter, flax-like, in module order."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(g)


# ---------------------------------------------------------------------------
# Dense, Conv, norms


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` in ``dtype``; kernel [in, out].

    With its kernel sharded (``parallel.tensor.shard_parameters``) over
    columns it computes its block of the outputs and gathers them; over rows
    it multiplies its block of the input by its rows, sums the partials over
    the model group and adds the bias once. Input and output are replicated
    either way."""

    tp_shardable = ("kernel",)
    tp_dims: Dict[str, int] = {}  # the sharded parameters' split axes
    tp_mesh = None

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, g: Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], g)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        axis = self.tp_dims.get("kernel")
        if axis is None:
            return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)
        if axis == 1:
            return gather(column_parallel(x.to(dt), self.kernel.to(dt), self.bias.to(dt),
                                          self.tp_mesh), self.tp_mesh)
        return row_parallel(split(x.to(dt), self.tp_mesh), self.kernel.to(dt),
                            self.tp_mesh) + self.bias.to(dt)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of a SAME convolution along one axis, as XLA
    computes it: a stride-2 3x3 conv pads (0, 1) over an even size."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` with SAME padding on NHWC maps.

    The kernel is stored OIHW (the flax HWIO kernel transposed). The NHWC
    input is handed to the convolution as an NCHW view in channels_last
    memory, so no layout copy is made on either side.
    """

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int] = (1, 1),
                 strides: Sequence[int] = (1, 1), use_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 bias_init: Optional[Callable[[torch.Tensor], None]] = None):
        super().__init__()
        self.dtype = dtype
        self.strides = tuple(strides)
        self.kernel = nn.Parameter(torch.empty(features, in_features, *kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self._bias_init = bias_init or nn.init.zeros_

    def reset_parameters(self, g: Generator) -> None:
        o, i, kh, kw = self.kernel.shape
        lecun_normal_(self.kernel, i * kh * kw, g)
        if self.bias is not None:
            with torch.no_grad():
                self._bias_init(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        kh, kw = self.kernel.shape[2:]
        (pt, pb), (pl, pr) = (same_padding(h, kh, self.strides[0]),
                              same_padding(w, kw, self.strides[1]))
        xc = x.to(self.dtype).permute(0, 3, 1, 2)
        if pt == pb and pl == pr:
            padding = (pt, pl)
        else:
            xc = F.pad(xc, (pl, pr, pt, pb))
            padding = (0, 0)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv2d(xc, self.kernel.to(self.dtype), bias, self.strides, padding)
        return y.permute(0, 2, 3, 1)


class QuantSites:
    """Mixin of a module with int8 activation sites.

    ``quant_sites``: the sites the module records while calibrating, by
    their local names in the flax ``quant`` collection. ``quant_reads``: the
    sites whose scale its int8 path reads; each is a buffer of that name, an
    fp32 scalar on the module's device, None until ``load_quant_scales``
    sets it (the int8 path raises while one is missing; a scale never
    defaults to 1). While ``quant_stats`` is a dict (set by
    ``models/quantize.py`` on every such module of a float model), the
    module records ``{quant_prefix + site: max|x|}`` in it.
    """

    quant_sites: Tuple[str, ...] = ()
    quant_reads: Tuple[str, ...] = ()
    quant_stats: Optional[dict] = None
    quant_prefix: str = ""

    def _init_quant(self, sites: Sequence[str], reads: Sequence[str] = ()) -> None:
        self.quant_sites, self.quant_reads = tuple(sites), tuple(reads)
        for site in self.quant_reads:
            self.register_buffer(site, None, persistent=False)

    @property
    def calibrating(self) -> bool:
        return self.quant_stats is not None

    def record(self, site: str, x: torch.Tensor) -> None:
        if self.quant_stats is not None and site in self.quant_sites:
            self.quant_stats[self.quant_prefix + site] = calib_maxabs(x)

    def act_scale(self, site: str) -> torch.Tensor:
        scale = getattr(self, site)
        if scale is None:
            raise RuntimeError(f"int8 scale {self.quant_prefix}{site} is not loaded: "
                               "load calibrated scales (models.quantize.load_quant_scales)")
        return scale


def _set_buffer(module: nn.Module, name: str, value: torch.Tensor) -> None:
    """Set a buffer, copying in place once it exists with this shape (a CUDA
    graph reads it at a fixed address)."""
    current = getattr(module, name)
    if current is not None and current.shape == value.shape and current.dtype == value.dtype:
        current.copy_(value)
    else:
        setattr(module, name, value.contiguous())


class QuantConv(Conv):
    """int8 twin of ``Conv(use_bias=False)`` (JAX's ``QuantConv``): the same
    ``kernel`` parameter, so float checkpoints load unchanged.

    ``forward(x_q, act_scale)`` convolves the int8 NHWC map ``x_q``
    (quantized with ``act_scale``) with the int8 kernel into int32
    (``ops/quant.py``). The kernel's int8 form and per-channel scales depend
    only on the weights: ``refresh_quant`` computes them, at load
    (``load_constraints``), into buffers it later overwrites in place.
    """

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int] = (1, 1),
                 strides: Sequence[int] = (1, 1), dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, features, kernel_size, strides, use_bias=False,
                         dtype=dtype)
        self.register_buffer("kernel_q", None, persistent=False)
        self.register_buffer("w_scale", None, persistent=False)

    @torch.no_grad()
    def refresh_quant(self) -> None:
        q, scale = prepare_conv_weight(self.kernel)
        _set_buffer(self, "kernel_q", q)
        _set_buffer(self, "w_scale", scale)

    def forward(self, x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
        if self.kernel_q is None:
            raise RuntimeError("QuantConv's int8 weights are not prepared (refresh_quant)")
        return conv_int8_prepared(x, self.kernel_q, self.w_scale, act_scale,
                                  self.kernel.shape[2:], self.strides, self.dtype)


class QuantDense(Dense):
    """int8 twin of ``Dense`` (JAX's ``QuantDense``): the same ``kernel`` and
    ``bias``; ``forward(x_q, act_scale)`` is the int8 product plus the bias
    in ``dtype``. Weights as ``QuantConv``'s."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, features, dtype=dtype)
        self.register_buffer("kernel_q", None, persistent=False)
        self.register_buffer("w_scale", None, persistent=False)

    @torch.no_grad()
    def refresh_quant(self) -> None:
        q, scale = prepare_dense_weight(self.kernel)
        _set_buffer(self, "kernel_q", q)
        _set_buffer(self, "w_scale", scale)

    def forward(self, x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
        if self.kernel_q is None:
            raise RuntimeError("QuantDense's int8 weights are not prepared (refresh_quant)")
        out = matmul_int8_prepared(x, self.kernel_q, self.w_scale, act_scale, self.dtype)
        return out + self.bias.to(self.dtype)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(features, (4, 4), strides=(2, 2))`` with SAME
    padding on NHWC maps: the dense heads' upsampling (output 2H x 2W), the
    only transposed convolution of the model.

    The kernel is kept in flax's layout, HWIO (``convert.py`` moves it as
    is). Flax does not transpose the kernel (``transpose_kernel=False``): it
    dilates the input by the stride, pads it (2, 2) and correlates with the
    kernel as given. ``F.conv_transpose2d`` is the gradient of a correlation,
    so it takes the kernel flipped in space, as [in, out, kh, kw], with
    padding 1.
    """

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(4, 4, in_features, features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, g: Generator) -> None:
        kh, kw, i, _ = self.kernel.shape
        lecun_normal_(self.kernel, kh * kw * i, g)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(self.dtype).flip((0, 1)).permute(2, 3, 0, 1)
        y = F.conv_transpose2d(x.to(self.dtype).permute(0, 3, 1, 2), w, self.bias.to(self.dtype),
                               stride=2, padding=1)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (eps 1e-6): fp32 statistics with
    var = E[x²] - E[x]² clamped at 0, output cast to ``dtype``."""

    epsilon = 1e-6

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, g: Generator) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp(x32.square().mean(dim=-1, keepdim=True) - mu.square(), min=0.0)
        y = (x32 - mu) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias
        return y.to(self.dtype)


class GroupNorm(nn.Module):
    """GroupNorm on NHWC maps that can hand its affine form to the caller:
    once the group statistics are known, GroupNorm is ``x*s + t`` with
    per-(batch, channel) vectors, which the fused serve tail of
    ``ConvMHCBlock`` folds with the SE gate and the residual add.

    fp32 statistics E[x²] - E[x]², fp32 normalize, cast to ``dtype``.
    """

    def __init__(self, features: int, num_groups: int, dtype: torch.dtype = torch.bfloat16,
                 epsilon: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, g: Generator) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def affine_from_channel_stats(self, ch_mean: torch.Tensor, ch_m2: torch.Tensor):
        """(s, t) with ``normalized = x*s + t``, from per-channel spatial means
        of x and x² (fp32, [B, C])."""
        b, c = ch_mean.shape
        g = self.num_groups
        gm = ch_mean.reshape(b, g, c // g).mean(dim=-1)
        gm2 = ch_m2.reshape(b, g, c // g).mean(dim=-1)
        rs = torch.rsqrt(gm2 - gm.square() + self.epsilon)
        s = self.scale[None, :] * rs.repeat_interleave(c // g, dim=-1)
        t = self.bias[None, :] - gm.repeat_interleave(c // g, dim=-1) * s
        return s, t

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        spatial = tuple(range(1, x.dim() - 1))
        s, t = self.affine_from_channel_stats(x32.mean(dim=spatial),
                                              x32.square().mean(dim=spatial))
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        return (x32 * s.reshape(shape) + t.reshape(shape)).to(self.dtype)


class RMSNorm(nn.Module):
    """Root-mean-square norm over the last axis: fp32 statistics,
    ``x * rsqrt(mean(x²) + eps) * scale`` with an fp32 ``scale``, cast to
    ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16,
                 epsilon: float = 1e-6):
        super().__init__()
        self.dtype, self.epsilon = dtype, epsilon
        self.scale = nn.Parameter(torch.ones(features))

    def reset_parameters(self, g: Generator) -> None:
        nn.init.ones_(self.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.epsilon) * self.scale).to(self.dtype)


def group_norm(channels: int, dtype: torch.dtype) -> GroupNorm:
    """GroupNorm with the largest group count <= 8 that divides ``channels``."""
    groups = 8
    while channels % groups != 0:
        groups //= 2
    return GroupNorm(channels, groups, dtype=dtype)


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``F.one_hot(labels, num_classes)`` (int64) without its range check,
    which on the CPU alone reads the labels' min and max back to the host:
    here the same operators run on either device (zeros, then a scatter of
    ones), so an operation count agrees and nothing waits on the host."""
    out = torch.zeros(labels.shape + (num_classes,), dtype=torch.long, device=labels.device)
    return out.scatter_(-1, labels.unsqueeze(-1), 1)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Dropout


class Dropout(nn.Module):
    """flax ``nn.Dropout`` in train mode: keep each element with probability
    1 - rate and scale it by 1/(1 - rate), in the input dtype. It draws from
    ``generator`` (``set_dropout_generator``), or torch's default generator
    when none is set; the bits differ from JAX's for any seed. ``shard=(k,
    m)`` marks ``x`` as block ``k`` of ``m`` along its last axis: the mask is
    drawn at the whole width and ``x`` takes its block, so the processes of a
    model group draw what one process draws."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Generator = None

    def forward(self, x: torch.Tensor, shard: Optional[Tuple[int, int]] = None
                ) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        k, m = shard or (0, 1)
        n = x.shape[-1]
        mask = torch.rand(x.shape[:-1] + (n * m,), generator=self.generator,
                          device=x.device)[..., k * n:(k + 1) * n] < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def set_dropout_generator(model: nn.Module, generator: Generator) -> None:
    """Make every ``Dropout`` of ``model`` draw from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


# ---------------------------------------------------------------------------
# mHC

# The int8 chain's weights, each held as ``<name>_q`` (int8 [N, K]) and
# ``<name>_s`` (per-column scales): W1_folded, W2, H_post, H_res.
INT8_OPERANDS = ("w1", "w2", "h_post", "h_res")


class ManifoldHyperConnection(QuantSites, nn.Module):
    """mHC layer: ``out = LN2(x @ H_res + MLP(LN1(x) @ H_pre) @ H_post)`` with
    H_pre = sigmoid(H_pre_raw), H_post = 2·sigmoid(H_post_raw) and H_res =
    Sinkhorn(H_res_raw), a doubly stochastic matrix.

    Serve branch (``precomputed_constraints=True``): the constrained matrices
    (``h_pre``, ``h_post``, ``h_res``, ``w1_folded`` = H_pre @ W1) come from
    ``constraints.compute_constraints`` through ``set_constraints``; they are
    buffers in ``dtype`` and the layer is deterministic.

    Training branch (``False``, the JAX default): each forward computes the
    constraints in fp32 (Sinkhorn with ``sk_iters`` iterations and
    temperature ``tau``) and casts them to ``dtype``. A model that holds the
    layer may project every layer's H_res_raw in one grouped call first and
    hand each its projection in ``h_res_given`` for one forward (see
    ``HybridVisionSystem.forward``); a layer called on its own projects its
    own. In train mode dropout (``dropout_rate``) follows both GELUs and
    LN2, as in JAX, and autograd differentiates the chain; a deterministic
    forward without autograd at a fused site takes kernel C. In every branch
    and block the products ``x @ H_res`` and ``y @ H_post`` are rounded to
    ``dtype`` and their sum and LN2 are not (fp32), as XLA compiles JAX's
    layer and its Pallas kernels. With ``monitor`` the layer leaves its telemetry
    (``signal_ratio``, ``ds_error``, ``row_sum_error``, ``col_sum_error``;
    detached tensors) in ``self.metrics`` after each forward, as the JAX
    layer sows it into the ``stability`` collection.

    int8 (``act_quant`` with serve constraints): the chain's four products
    take int8 operands (``y1``: LN1's output, ``a1`` and ``a2``: the GELUs'
    outputs, ``x``: the input, each with its calibrated scale) against the
    int8 forms of W1_folded, W2, H_post and H_res, computed in fp32 when the
    constraints are installed; the fused block is not taken. With
    ``quant_sites`` the layer records those four sites while calibrating
    (the backbone's, the ViT's and the ViT fusion's layers, as in JAX);
    while calibrating every layer runs the unfused bf16 chain.

    Tensor parallelism (``parallel.tensor.shard_parameters`` with the
    default rules: H_pre and ``mlp_in`` split over columns, ``mlp_out`` and
    H_post over rows): the training branch runs ``LN1(x) @ H_pre``
    column-parallel, gathers it, ``@ mlp_in`` column-parallel with its block
    of the bias, GELU, ``@ mlp_out`` row-parallel, the bias, GELU, and its
    block of that ``@ H_post`` row-parallel; the row-parallel sums are fp32,
    rounded once. ``x @ H_res`` (H_res stays whole) and LN2 are replicated.
    Dropout on a block takes its block of the whole-width mask. The
    deterministic forward at a fused site gathers the four matrices and runs
    kernel C on them, as XLA runs a custom call it cannot partition on whole
    operands. Any other split of the four matrices gathers each on use.
    """

    tp_shardable = ("H_pre_raw", "H_post_raw", "mlp_in_kernel", "mlp_out_kernel")
    # The split axes of the sharded chain: column-parallel in, row-parallel out.
    TP_CHAIN = {"H_pre_raw": 1, "mlp_in_kernel": 1, "mlp_out_kernel": 0, "H_post_raw": 0}
    tp_dims: Dict[str, int] = {}
    tp_mesh = None

    def __init__(self, dim: int, expansion_rate: int = 2, mlp_ratio: int = 2,
                 dtype: torch.dtype = torch.bfloat16, *, sk_iters: int = 20, tau: float = 1.0,
                 dropout_rate: float = 0.1, monitor: bool = False,
                 precomputed_constraints: bool = False, act_quant: bool = False,
                 quant_sites: bool = False, hidden_dim: Optional[int] = None):
        super().__init__()
        d = dim
        hidden = hidden_dim or d * expansion_rate
        mlp_hidden = hidden * mlp_ratio
        self.dim, self.dtype = dim, dtype
        self.sk_iters, self.tau = sk_iters, tau
        self.monitor = monitor
        self.precomputed_constraints = precomputed_constraints
        self.H_pre_raw = nn.Parameter(torch.empty(d, hidden))
        self.H_post_raw = nn.Parameter(torch.empty(hidden, d))
        self.H_res_raw = nn.Parameter(torch.empty(d, d))
        self.mlp_in_kernel = nn.Parameter(torch.empty(hidden, mlp_hidden))
        self.mlp_in_bias = nn.Parameter(torch.zeros(mlp_hidden))
        self.mlp_out_kernel = nn.Parameter(torch.empty(mlp_hidden, hidden))
        self.mlp_out_bias = nn.Parameter(torch.zeros(hidden))
        self.norm_pre_scale = nn.Parameter(torch.ones(d))
        self.norm_pre_bias = nn.Parameter(torch.zeros(d))
        self.norm_post_scale = nn.Parameter(torch.ones(d))
        self.norm_post_bias = nn.Parameter(torch.zeros(d))
        self.dropout = Dropout(dropout_rate)
        # The int8 chain serves the serve branch only, as in JAX.
        self.int8 = act_quant and precomputed_constraints
        # The fused blocks serve the bf16 sites whose matrices are all [d, d].
        self.fused = (expansion_rate == 1 and hidden == d and mlp_ratio == 1
                      and dtype == torch.bfloat16
                      and dim in SUPPORTED_WIDTHS and not self.int8)
        chain_sites = ("y1_scale", "a1_scale", "a2_scale", "x_scale")
        self._init_quant(chain_sites if quant_sites else (), chain_sites if self.int8 else ())
        for name in (INT8_OPERANDS if self.int8 else ()):
            self.register_buffer(name + "_q", None, persistent=False)
            self.register_buffer(name + "_s", None, persistent=False)
        self.metrics: dict = {}
        self.h_res_given: Optional[torch.Tensor] = None
        for name in ("h_pre", "h_post", "h_res", "w1_folded"):
            self.register_buffer(name, None, persistent=False)

    def reset_parameters(self, g: Generator) -> None:
        for p in (self.H_pre_raw, self.H_post_raw, self.H_res_raw):
            h_init_(p, g)
        lecun_normal_(self.mlp_in_kernel, self.mlp_in_kernel.shape[0], g)
        lecun_normal_(self.mlp_out_kernel, self.mlp_out_kernel.shape[0], g)
        for p in (self.mlp_in_bias, self.mlp_out_bias, self.norm_pre_bias, self.norm_post_bias):
            nn.init.zeros_(p)
        nn.init.ones_(self.norm_pre_scale)
        nn.init.ones_(self.norm_post_scale)

    def set_constraints(self, node: dict) -> None:
        """Install this layer's entry of ``compute_constraints`` (cast to ``dtype``).

        Once installed, later calls copy into the same buffers instead of
        rebinding them: a CUDA graph captured over this layer reads the
        buffers at fixed addresses, and a hot swap must reach it."""
        device = self.H_res_raw.device
        for name in ("h_pre", "h_post", "h_res", "w1_folded"):
            _set_buffer(self, name, node[name].to(device=device, dtype=self.dtype))
        if self.int8:
            # From the fp32 matrices, as JAX's chain quantizes them.
            fp32 = {"w1": node["w1_folded"], "w2": self.mlp_out_kernel.detach(),
                    "h_post": node["h_post"], "h_res": node["h_res"]}
            for name in INT8_OPERANDS:
                q, scale = prepare_dense_weight(fp32[name].to(device=device,
                                                              dtype=torch.float32))
                _set_buffer(self, name + "_q", q)
                _set_buffer(self, name + "_s", scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.precomputed_constraints:
            return self._serve(x.to(self.dtype))
        return self._train_branch(x.to(self.dtype))

    def _serve(self, x_in: torch.Tensor) -> torch.Tensor:
        if self.h_res is None:
            raise RuntimeError(
                "mHC constraints are not installed: run load_constraints(model, "
                "compute_constraints(param_tree(model))) first (Detector does this at load)"
            )
        dt = self.dtype
        if self.calibrating:
            return self._serve_chain(x_in)
        if self.int8:
            return self._int8_chain(x_in)
        if self.fused:
            # contiguous(): a no-op on the tensors an eager forward makes; under
            # torch.export the traced strides can differ from them.
            out = mhc_block(
                x_in.reshape(-1, self.dim).contiguous(), self.w1_folded, self.mlp_in_bias,
                self.mlp_out_kernel.to(dt), self.mlp_out_bias, self.h_post, self.h_res,
                self.norm_pre_scale, self.norm_pre_bias,
                self.norm_post_scale, self.norm_post_bias,
            )
            return out.reshape(x_in.shape)
        return self._serve_chain(x_in)

    def _serve_chain(self, x_in: torch.Tensor) -> torch.Tensor:
        """The unfused bf16 serve chain; records its int8 sites when calibrating.
        The products are rounded to dtype, their sum and LN2 are fp32."""
        dt = self.dtype
        y = _layernorm(x_in, self.norm_pre_scale, self.norm_pre_bias).to(dt)
        self.record("y1_scale", y)
        y = gelu(y @ self.w1_folded + self.mlp_in_bias.to(dt))
        self.record("a1_scale", y)
        y = gelu(y @ self.mlp_out_kernel.to(dt) + self.mlp_out_bias.to(dt))
        self.record("a2_scale", y)
        self.record("x_scale", x_in)
        y = y @ self.h_post
        res = x_in @ self.h_res
        return _layernorm(res.float() + y.float(), self.norm_post_scale,
                          self.norm_post_bias).to(dt)

    def _int8_chain(self, x_in: torch.Tensor) -> torch.Tensor:
        """JAX's ``int8_chain``: every product int8 by int8 into int32."""
        dt = self.dtype

        def product(a: torch.Tensor, site: str, name: str) -> torch.Tensor:
            scale = self.act_scale(site)
            return matmul_int8_prepared(quantize_tensor(a, scale), getattr(self, name + "_q"),
                                        getattr(self, name + "_s"), scale, dt)

        y = _layernorm(x_in, self.norm_pre_scale, self.norm_pre_bias).to(dt)
        y = gelu(product(y, "y1_scale", "w1") + self.mlp_in_bias.to(dt))
        y = gelu(product(y, "a1_scale", "w2") + self.mlp_out_bias.to(dt))
        y = product(y, "a2_scale", "h_post")
        res = product(x_in, "x_scale", "h_res")
        # Each product is rounded to dtype, the sum is not: XLA keeps the
        # jitted JAX chain's sum in fp32 into LN2.
        return _layernorm(res.float() + y.float(), self.norm_post_scale,
                          self.norm_post_bias).to(dt)

    def _whole(self, name: str) -> torch.Tensor:
        """Parameter ``name`` whole: gathered over the model group when this
        process holds a block of it."""
        p = getattr(self, name)
        axis = self.tp_dims.get(name)
        return p if axis is None else gather(p, self.tp_mesh, axis)

    def _train_branch(self, x_in: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h_res32 = self.h_res_given
        if h_res32 is None:
            h_res32 = sinkhorn_log(self.H_res_raw, self.sk_iters, self.tau)
        h_res = h_res32.to(dt)
        deterministic = not self.training and not torch.is_grad_enabled()
        if self.tp_dims == self.TP_CHAIN and not (self.fused and deterministic):
            out = self._sharded_chain(x_in, h_res)
        else:
            h_pre = torch.sigmoid(self._whole("H_pre_raw")).to(dt)
            h_post = (2.0 * torch.sigmoid(self._whole("H_post_raw"))).to(dt)
            w1 = self._whole("mlp_in_kernel").to(dt)
            w2 = self._whole("mlp_out_kernel").to(dt)
            if self.fused and deterministic:
                # A deterministic forward with nothing to differentiate: the
                # unfolded block (it has no backward, here or in JAX).
                out = mhc_block_unfolded(
                    x_in.reshape(-1, self.dim), h_pre, w1, self.mlp_in_bias, w2,
                    self.mlp_out_bias, h_post, h_res, self.norm_pre_scale, self.norm_pre_bias,
                    self.norm_post_scale, self.norm_post_bias,
                ).reshape(x_in.shape)
            else:
                y = _layernorm(x_in, self.norm_pre_scale, self.norm_pre_bias).to(dt) @ h_pre
                y = self.dropout(gelu(y @ w1 + self.mlp_in_bias.to(dt)))
                y = self.dropout(gelu(y @ w2 + self.mlp_out_bias.to(dt)))
                # As XLA compiles JAX's step: each product rounded to bf16,
                # their sum and LN2 in fp32. At a near-uniform H_res or H_post
                # the sum's spread across channels lies under one bf16 step of
                # its mean, so rounding the sum as well leaves LN2 normalising
                # rounding noise.
                out = _layernorm((x_in @ h_res).float() + (y @ h_post).float(),
                                 self.norm_post_scale, self.norm_post_bias).to(dt)
                out = self.dropout(out)
        if self.monitor:
            with torch.no_grad():
                in_norm = torch.linalg.vector_norm(x_in.float(), dim=-1).mean()
                out_norm = torch.linalg.vector_norm(out.float(), dim=-1).mean()
                h = h_res32.detach()
                self.metrics = {
                    "signal_ratio": out_norm / (in_norm + 1e-8),
                    "ds_error": doubly_stochastic_error(h),
                    "row_sum_error": (h.sum(dim=-1) - 1.0).abs().amax(),
                    "col_sum_error": (h.sum(dim=-2) - 1.0).abs().amax(),
                }
        return out

    def _sharded_chain(self, x_in: torch.Tensor, h_res: torch.Tensor) -> torch.Tensor:
        """The training chain on this process's blocks (``TP_CHAIN``)."""
        dt, mesh = self.dtype, self.tp_mesh
        shard = (mesh.model_rank, mesh.model)
        y = _layernorm(x_in, self.norm_pre_scale, self.norm_pre_bias).to(dt)
        y = gather(column_parallel(y, torch.sigmoid(self.H_pre_raw).to(dt), None, mesh), mesh)
        y = column_parallel(y, self.mlp_in_kernel.to(dt), self.mlp_in_bias.to(dt), mesh)
        y = self.dropout(gelu(y), shard)
        y = row_parallel(y, self.mlp_out_kernel.to(dt), mesh)
        y = self.dropout(gelu(y + self.mlp_out_bias.to(dt)))
        y = row_parallel(split(y, mesh), (2.0 * torch.sigmoid(self.H_post_raw)).to(dt), mesh)
        out = _layernorm((x_in @ h_res).float() + y.float(), self.norm_post_scale,
                         self.norm_post_bias).to(dt)
        return self.dropout(out)


# ---------------------------------------------------------------------------
# Squeeze-excite and attention


class SqueezeExcite(nn.Module):
    """SE channel attention. With ``pooled`` given (the fused serve tail), the
    spatial mean is not recomputed; ``return_gates`` returns the gates. The
    hidden width is ``channels // reduction``."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.bfloat16, reduction: int = 4):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = Dense(channels, channels // reduction, dtype=dtype)
        self.Dense_1 = Dense(channels // reduction, channels, dtype=dtype)

    def forward(self, x: Optional[torch.Tensor] = None, pooled: Optional[torch.Tensor] = None,
                return_gates: bool = False) -> torch.Tensor:
        if pooled is None:
            pooled = x.float().mean(dim=(1, 2), keepdim=True)
        g = torch.sigmoid(self.Dense_1(F.silu(self.Dense_0(pooled.to(self.dtype)))))
        if return_gates:
            return g
        return x * g


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
           dtype: torch.dtype, dropout: Optional[nn.Module] = None) -> torch.Tensor:
    """Multi-head attention of projected queries [B, Tq, D] over keys and
    values [B, Tk, D], as the JAX layers compute it: the products in the
    inputs' dtype, the scaled logits and softmax in fp32, the weights cast to
    ``dtype`` (then ``dropout``); returns [B, Tq, D]."""
    b, tq, d = q.shape
    head_dim = d // num_heads

    def split(a):
        return a.reshape(b, a.shape[1], num_heads, head_dim).transpose(1, 2)

    logits = (split(q) @ split(k).transpose(-1, -2)).float() / math.sqrt(head_dim)
    weights = torch.softmax(logits, dim=-1).to(dtype)
    if dropout is not None:
        weights = dropout(weights)
    return (weights @ split(v)).transpose(1, 2).reshape(b, tq, d)


class DenseAttention(QuantSites, nn.Module):
    """Multi-head self-attention: dense QKV, matmuls in ``dtype``, softmax in
    fp32 (explicit products, so the roundings follow the JAX layer), dropout
    on the attention weights in train mode. ``act_quant`` serves the QKV and
    output projections in int8 (sites ``qkv_in_scale``, ``proj_in_scale``);
    the attention itself stays in ``dtype`` and fp32."""

    SITES = ("qkv_in_scale", "proj_in_scale")

    def __init__(self, dim: int, num_heads: int = 8, dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.1, act_quant: bool = False):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.act_quant = act_quant
        dense = QuantDense if act_quant else Dense
        self.qkv = dense(dim, 3 * dim, dtype=dtype)
        self.proj = dense(dim, dim, dtype=dtype)
        self.dropout = Dropout(dropout_rate)
        self._init_quant(self.SITES, self.SITES if act_quant else ())

    def _project(self, layer: Dense, x: torch.Tensor, site: str) -> torch.Tensor:
        if self.act_quant:
            scale = self.act_scale(site)
            return layer(quantize_tensor(x, scale), scale)
        self.record(site, x)
        return layer(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self._project(self.qkv, x, "qkv_in_scale").chunk(3, dim=-1)
        out = attend(q, k, v, self.num_heads, self.dtype, self.dropout)
        return self._project(self.proj, out, "proj_in_scale")


class MultiHeadManifoldAttention(nn.Module):
    """Multi-head self-attention whose Q, K, V and output projections are mHC
    layers (``mhc_q``, ``mhc_k``, ``mhc_v``, ``mhc_out``; ``expansion_rate``
    2 and ``mlp_ratio`` 1 by default), attending as ``DenseAttention``
    (``attend``; dropout on the weights in train mode). The mHC options ``mhc`` (``sk_iters``,
    ``precomputed_constraints``, ...) go to the four layers; ``monitor`` does
    not, as JAX's layer passes none. Their widths are [d, 2d] and [2d, 2d],
    so no fused block serves them; their H_res projections ([d, d]) take
    kernel B on the card."""

    def __init__(self, dim: int, num_heads: int = 8, expansion_rate: int = 2,
                 mlp_ratio: int = 1, dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.1, **mhc):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        mhc.pop("monitor", None)
        self.num_heads, self.dtype = num_heads, dtype
        for name in ("mhc_q", "mhc_k", "mhc_v", "mhc_out"):
            self.add_module(name, ManifoldHyperConnection(
                dim, expansion_rate, mlp_ratio, dtype=dtype, dropout_rate=dropout_rate, **mhc))
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = attend(self.mhc_q(x), self.mhc_k(x), self.mhc_v(x), self.num_heads, self.dtype,
                     self.dropout)
        return self.mhc_out(out)


class MHCTransformerBlock(nn.Module):
    """Pre-norm block: ``x + attention(LN(x))``, then an mHC layer as FFN;
    ``dropout_rate`` goes to both. The attention is ``DenseAttention`` (with
    ``act_quant``), or with ``use_manifold_attention``
    ``MultiHeadManifoldAttention`` (always float, as in JAX); ``act_quant``
    also goes to the FFN, whose widths are ``expansion_rate`` and
    ``mlp_ratio``."""

    def __init__(self, dim: int, num_heads: int = 8, dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.1, act_quant: bool = False,
                 use_manifold_attention: bool = False, expansion_rate: int = 1,
                 mlp_ratio: int = 2, **mhc):
        super().__init__()
        self.dtype = dtype
        self.LayerNorm_0 = LayerNorm(dim, dtype=dtype)
        if use_manifold_attention:
            self.attn = MultiHeadManifoldAttention(dim, num_heads, dtype=dtype,
                                                   dropout_rate=dropout_rate, **mhc)
        else:
            self.attn = DenseAttention(dim, num_heads, dtype=dtype, dropout_rate=dropout_rate,
                                       act_quant=act_quant)
        self.mhc_ffn = ManifoldHyperConnection(dim, expansion_rate, mlp_ratio, dtype=dtype,
                                               dropout_rate=dropout_rate, act_quant=act_quant,
                                               quant_sites=True, **mhc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        x = x + self.attn(self.LayerNorm_0(x))
        return self.mhc_ffn(x)
