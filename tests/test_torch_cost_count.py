"""The operation count of ``ModelProfiler.cost_analysis`` on the CPU: views
move no bytes, products count 2·MACs (a SAME convolution's padded taps
included, which XLA's count leaves out), kernels B and C count through
their operators, and the tiny flagship's forward counts what its shapes
say, no more than XLA counts for the same JAX forward.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvs_tpu.models import ProductionHybridVision as JaxProduction
from hvs_tpu.models.constraints import compute_constraints as jax_constraints
from hvs_tpu.models.layers import DenseAttention as JaxDenseAttention
from hvs_tpu.models.layers import ManifoldHyperConnection as JaxMHC
from hvs_tpu_torch import bytes_attribution
from hvs_tpu_torch.convert import load_flax_params
from hvs_tpu_torch.inference import Detector
from hvs_tpu_torch.models import ProductionHybridVision
from hvs_tpu_torch.ops import mhc_block as mhc_mod
from hvs_tpu_torch.ops import sinkhorn as sink_mod
from hvs_tpu_torch.utils.perf import TINY
from hvs_tpu_torch.utils.profiler import ModelProfiler

torch.set_num_threads(1)


def _cost(fn, *args):
    return ModelProfiler(fn, *args).cost_analysis()


def test_views_and_aliases_move_no_bytes():
    x = torch.randn(64, 32)
    got = _cost(lambda a: a.permute(1, 0)[:5].unsqueeze(0).expand(3, 5, 64).detach()
                .split(2, dim=1), x)
    assert got == {"flops": 0.0, "transcendentals": 0.0, "bytes accessed": 0.0}
    # A copy reads and writes: in + out.
    assert _cost(lambda a: a.t().contiguous(), x)["bytes accessed"] == 2 * 64 * 32 * 4
    # In place: the write counts.
    assert _cost(lambda a: a.clone().add_(1.0), x)["bytes accessed"] == 4 * 64 * 32 * 4


def _same_taps(n: int, k: int, s: int) -> int:
    """In-bounds taps summed over the outputs of one SAME-padded axis."""
    out = -(-n // s)
    lo = max((out - 1) * s + k - n, 0) // 2
    return sum(1 for i in range(out) for j in range(k) if 0 <= i * s - lo + j < n)


@pytest.mark.parametrize("shape,cout,k,s", [((2, 16, 16, 8), 16, 3, 1),
                                            ((2, 15, 9, 8), 12, 3, 2), ((1, 8, 8, 4), 8, 1, 1)])
def test_products_count_two_macs_and_conv_taps_against_xla(shape, cout, k, s):
    """A matmul's flops are 2·M·K·N; a SAME convolution's 2·MACs over every
    tap, padded ones included: XLA's count plus the out-of-bounds taps (for
    [2,16,16,8] -> 16 at 3x3: 1,179,648 against XLA's 1,083,392)."""
    a, b = torch.randn(64, 32), torch.randn(32, 48)
    assert _cost(torch.matmul, a, b)["flops"] == 2 * 64 * 32 * 48
    from hvs_tpu_torch.models.layers import Conv

    bsz, h, w, cin = shape
    conv = Conv(cin, cout, (k, k), (s, s), use_bias=False, dtype=torch.float32)
    x = torch.randn(*shape)
    got = _cost(conv, x)["flops"]
    ho, wo = -(-h // s), -(-w // s)
    assert got == 2 * bsz * ho * wo * k * k * cin * cout
    jconv = fnn.Conv(cout, (k, k), strides=(s, s), use_bias=False, dtype=jnp.float32)
    xj = jnp.zeros(shape, jnp.float32)
    params = jax.jit(jconv.init)(jax.random.PRNGKey(0), xj)
    ca = jax.jit(jconv.apply).lower(params, xj).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    in_bounds = 2 * bsz * cin * cout * _same_taps(h, k, s) * _same_taps(w, k, s)
    assert float(ca["flops"]) == in_bounds
    if shape == (2, 16, 16, 8):
        assert (got, in_bounds) == (1_179_648, 1_083_392)


def _mhc_args(n, d, seed):
    r = np.random.default_rng(seed)

    def t(shape, dtype=torch.bfloat16):
        return torch.from_numpy(r.standard_normal(shape).astype(np.float32) * 0.1).to(dtype)

    mats = [t((d, d)) for _ in range(5)]  # h_pre, w1, w2, h_post, h_res
    vecs = [t((d,), torch.float32) for _ in range(6)]
    return (t((n, d)), mats[0], mats[1], vecs[0], mats[2], vecs[1], mats[3], mats[4], *vecs[2:])


@pytest.mark.parametrize("n,d", [(40, 32), (7, 64)])
def test_kernel_c_operator_counts_ten_n_d_squared(n, d):
    args = _mhc_args(n, d, d)
    got = _cost(mhc_mod.mhc_block_unfolded, *args)
    assert got["flops"] == 10 * n * d * d
    assert got["bytes accessed"] == sum(a.numel() * a.element_size() for a in args) + 2 * n * d
    assert got["transcendentals"] == 0


@pytest.mark.parametrize("batch,n,iters", [(3, 16, 20), (2, 8, 5)])
def test_kernel_b_operators_count_bytes_and_exponentials(batch, n, iters):
    """Forward: (2·iters + 2)·n² exponentials per matrix (42·n² at 20), its
    input and output (and the history it keeps for a backward); backward:
    2·iters·n² (40·n²), its four inputs and one output. Under the count the
    CPU backward is still autograd's gradient of the plain loop, bitwise."""
    x = torch.randn(batch, n, n)
    fwd = _cost(lambda: sink_mod.sinkhorn_log_op(x, iters, 1.0, False))
    assert fwd == {"flops": 0.0, "transcendentals": float((2 * iters + 2) * batch * n * n),
                   "bytes accessed": float(8 * batch * n * n)}
    hist_bytes = 4 * batch * 2 * (iters + 1) * n
    kept = _cost(lambda: sink_mod.sinkhorn_log_op(x, iters, 1.0, True))
    assert kept["bytes accessed"] == 8 * batch * n * n + hist_bytes
    p, hist = sink_mod.sinkhorn_log_op(x, iters, 1.0, True)
    dp = torch.randn_like(x)
    bwd = _cost(lambda: sink_mod.sinkhorn_log_backward_op(x, p, dp, hist, iters, 1.0))
    assert bwd["transcendentals"] == 2 * iters * batch * n * n
    assert bwd["bytes accessed"] == 16 * batch * n * n + hist_bytes
    y = x.clone().requires_grad_(True)
    want = torch.autograd.grad(sink_mod.sinkhorn_log_plain(y, iters), y, dp)[0]
    seen = []
    got = ModelProfiler(lambda: seen.append(torch.autograd.grad(
        sink_mod.sinkhorn_log(y, iters), y, dp)[0])).cost_analysis()
    assert torch.equal(seen[0], want)
    assert got["transcendentals"] == (4 * iters + 2) * batch * n * n


# ---------------------------------------------------------------------------
# The tiny flagship's forward against an analytic count and XLA's.

BATCH, SIZE, SK = 2, 64, 5


@pytest.fixture(scope="module")
def flagship():
    """The tiny flagship in fp32, JAX and the port on the same weights; the
    shapes of every product site of the JAX forward (flax interceptor)."""
    model = JaxProduction(**TINY, sk_iters=SK, dtype=jnp.float32)
    x = jnp.asarray(np.random.default_rng(0).uniform(size=(BATCH, SIZE, SIZE, 3)), jnp.float32)
    params = jax.device_get(jax.jit(functools.partial(model.init, task="detection"))(
        jax.random.PRNGKey(0), x[:1])["params"])
    variables = {"params": params, "constraints": jax_constraints(params, SK)}
    sites = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        m = context.module
        if context.method_name == "__call__" and isinstance(
                m, (fnn.Conv, fnn.Dense, JaxMHC, JaxDenseAttention)):
            sites.append((m, np.shape(args[0]), np.shape(out)))
        return out

    with fnn.intercept_methods(record):
        model.apply(variables, x, task="detection")
    ca = jax.jit(lambda v, im: model.apply(v, im, task="detection")).lower(
        variables, x).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    port = ProductionHybridVision(**TINY, sk_iters=SK, dtype=torch.float32, device="cpu")
    load_flax_params(port, params)
    return Detector(port, device="cpu"), torch.from_numpy(np.array(x)), sites, \
        float(ca["flops"])


def _analytic(sites):
    """Product flops from the sites' shapes and the parameter tree's
    widths: every convolution (2·MACs over all taps, and its out-of-bounds
    taps), dense layer, mHC chain (its four products; kernel A's 8·N·d² at
    a fused site) and attention (QK^T and AV)."""
    total = oob = 0
    for m, shape_in, shape_out in sites:
        if isinstance(m, fnn.Conv):
            b, h, w, cin = shape_in
            kh, kw = m.kernel_size
            s = m.strides or (1, 1)
            s = (s, s) if isinstance(s, int) else tuple(s)
            cout = shape_out[-1]
            full = 2 * b * shape_out[1] * shape_out[2] * kh * kw * cin * cout
            inb = 2 * b * cin * cout * _same_taps(h, kh, s[0]) * _same_taps(w, kw, s[1])
            total += full
            oob += full - inb
        elif isinstance(m, fnn.Dense):
            total += 2 * int(np.prod(shape_in[:-1])) * shape_in[-1] * m.features
        elif isinstance(m, JaxMHC):
            d = m.dim
            h = m.hidden_dim or d * m.expansion_rate
            mh = h * m.mlp_ratio
            total += 2 * int(np.prod(shape_in[:-1])) * (d * mh + mh * h + h * d + d * d)
        else:  # DenseAttention: [B, T, D], QK^T and AV
            b, t, d = shape_in
            total += 2 * 2 * b * t * t * d
    return total, oob


def test_tiny_flagship_forward_counts_its_shapes_and_no_more_than_xla(flagship, capsys):
    det, x, sites, xla = flagship
    with torch.inference_mode():
        got = ModelProfiler(det.model, x).cost_analysis()
    analytic, oob = _analytic(sites)
    assert got["flops"] == analytic
    assert analytic - oob <= xla
    with capsys.disabled():
        print(f"\ntiny flagship {BATCH}x{SIZE}²: port {analytic:,} flops (out-of-bounds taps "
              f"{oob:,}); XLA {xla:,.0f}, of which elementwise and the rest "
              f"{xla - (analytic - oob):,.0f}")


def test_bytes_attribution_stages_sum_to_the_serve_call(flagship):
    """The stages launch the serve call's operators: their flops and bytes
    sum to its own."""
    det, x, _, _ = flagship
    from hvs_tpu_torch.bench import serve_fn

    stages, out = {}, x
    with torch.inference_mode():
        for name, fn in bytes_attribution.stages(det.model).items():
            stages[name] = ModelProfiler(fn, out).cost_analysis()
            out = fn(out)
        serve = ModelProfiler(serve_fn(det), x).cost_analysis()
    for key in ("flops", "bytes accessed"):
        assert sum(v[key] for v in stages.values()) == serve[key]
    assert list(stages) == ["backbone", "vit_encoder", "fpn", "detection_head", "features",
                            "decode_nms"]
    report, _ = bytes_attribution.run(bytes_attribution.parse_args(
        ["--device", "cpu", "--tiny", "--batch", "1", "--image-size", "64", "--iters", "1",
         "--peak-tflops-bf16", "1", "--peak-hbm-gbps", "1"]))
    assert report["stage_sums_equal_serve"]
