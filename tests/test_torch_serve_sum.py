"""The residual sum of the port's serve and validation mHC chains, held
against JAX's jitted layers and its Pallas kernels on ill-conditioned inputs.

XLA compiles JAX's bf16 mHC layer (and runs the Pallas kernels in interpret
mode) with each product ``x @ H_res`` and ``y @ H_post`` rounded to bf16,
their sum and LN2 in fp32, and the output rounded once. The inputs here make
that sum ill-conditioned, as it is on trained weights: x = 3 ± 0.3, H_res
near uniform (Sinkhorn of the init logits) and H_post_raw ≈ 0 (H_post near
1). The sum's spread across channels then lies under one bf16 step of its
mean, so a rounded sum leaves LN2 normalising rounding noise.

JAX rounds each step of its bf16 GELU and PyTorch rounds the GELU once, so
the two packages' outputs are not equal on these inputs whatever the sum
does. Each case therefore holds two things, with the tolerances below:
  * the port's output correlates with JAX's above ``MIN_CORR``;
  * the port lies as far from the fp32 layer (same weights, fp32 dtype) as
    JAX's output does: their correlations with it differ by under
    ``MAX_GAP``.
A chain that rounds the sum misses the second by 0.028-0.43 at these widths.

At d = 32 and 64 the Pallas serve kernel packs tokens into 128 lanes and
takes LN2's statistics through a bf16 product, so there it agrees neither
with JAX's layer nor with either rounding (correlation 0.56-0.76 with the
layer). The port follows the layer; against the kernel it is held to be
exactly as far from it as JAX's layer is (``MAX_GAP``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hvs_tpu.ops.quant as jq
from hvs_tpu.models import ManifoldHyperConnection as JaxMHC
from hvs_tpu.models import compute_constraints as jax_constraints
from hvs_tpu.ops.pallas import mhc_block_pallas, mhc_block_pallas_packed
from hvs_tpu_torch.convert import load_flax_params, load_flax_quant
from hvs_tpu_torch.models import compute_constraints, load_constraints, param_tree
from hvs_tpu_torch.models.layers import ManifoldHyperConnection
from hvs_tpu_torch.models.quantize import load_quant_scales
from hvs_tpu_torch.ops import mhc_block as mhc_mod

torch.set_num_threads(1)

WIDTHS = (32, 64, 128, 256)
MIN_CORR = 0.9   # the fp32 sum: 0.913-0.997 over these cases; the rounded sum 0.48-0.93
MAX_GAP = 0.02   # the fp32 sum: <= 0.006; the rounded sum 0.028-0.43
SHAPE = (2, 8, 8)
SK_ITERS = 20


def _corr(a, b) -> float:
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def _assert_as_far(got, want, exact, min_corr=MIN_CORR):
    got, want, exact = (np.asarray(a, np.float32).reshape(-1) for a in (got, want, exact))
    assert np.isfinite(got).all()
    c = _corr(got, want)
    gap = abs(_corr(got, exact) - _corr(want, exact))
    assert c > min_corr and gap < MAX_GAP, (c, gap)


def _ill_conditioned(d, precomputed=True):
    """JAX's bf16 layer, its params (H_post_raw ≈ 0; H_res_raw at init),
    its serve constraints and the input x = 3 ± 0.3, from seed ``d``."""
    r = np.random.default_rng(d)
    x = jnp.asarray(3.0 + 0.3 * r.standard_normal(SHAPE + (d,)), jnp.bfloat16)
    layer = JaxMHC(dim=d, expansion_rate=1, mlp_ratio=1, sk_iters=SK_ITERS, dtype=jnp.bfloat16,
                   dropout_rate=0.0, precomputed_constraints=precomputed)
    params = dict(jax.device_get(jax.jit(layer.init)(jax.random.PRNGKey(d), x[:1])["params"]))
    params["H_post_raw"] = (0.01 * r.standard_normal((d, d))).astype(np.float32)
    constraints = jax.device_get(jax_constraints({"l": params}, SK_ITERS)["l"])
    return layer, params, constraints, x


def _exact(layer, params, constraints, x):
    """The same layer in fp32 on the same (bf16-valued) input."""
    variables = {"params": params}
    if layer.precomputed_constraints:
        variables["constraints"] = constraints
    return jax.jit(layer.clone(dtype=jnp.float32).apply)(variables, x.astype(jnp.float32))


def _port_layer(d, params, precomputed=True, **kw):
    port = ManifoldHyperConnection(d, 1, 1, dtype=torch.bfloat16, sk_iters=SK_ITERS,
                                   dropout_rate=0.0, precomputed_constraints=precomputed, **kw)
    load_flax_params(port, params)
    if precomputed:
        load_constraints(port, compute_constraints(param_tree(port), SK_ITERS))
    return port.eval()


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16)


def _operands(params, constraints):
    p, c = params, constraints
    return [c["w1_folded"], p["mlp_in_bias"], p["mlp_out_kernel"], p["mlp_out_bias"],
            c["h_post"], c["h_res"], p["norm_pre_scale"], p["norm_pre_bias"],
            p["norm_post_scale"], p["norm_post_bias"]]


@pytest.mark.parametrize("path", ["fused", "chain"])
@pytest.mark.parametrize("d", WIDTHS)
def test_serve_layer_sums_in_fp32_as_jax(d, path):
    """The serve layer (``precomputed_constraints``) against JAX's jitted serve
    layer on its XLA path (``use_pallas=False``): through the fused block's
    plain version (a bf16 site's forward on the CPU) and through the unfused
    chain (what calibration and the widths without a kernel run)."""
    layer, params, constraints, x = _ill_conditioned(d)
    want = jax.jit(layer.apply)({"params": params, "constraints": constraints}, x)
    port = _port_layer(d, params)
    assert port.fused
    with torch.no_grad():
        got = port(_t(x)) if path == "fused" else port._serve_chain(_t(x))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _assert_as_far(got.float(), want, _exact(layer, params, constraints, x))


@pytest.mark.parametrize("d", WIDTHS)
def test_unfolded_chain_sums_in_fp32_as_jax(d):
    """A deterministic forward of the training layer (the validation path:
    the unfolded block's plain version here) against JAX's jitted layer in
    eval mode."""
    layer, params, constraints, x = _ill_conditioned(d, precomputed=False)
    want = jax.jit(layer.apply)({"params": params}, x)
    port = _port_layer(d, params, precomputed=False)
    calls = []
    orig = mhc_mod.mhc_block_unfolded_plain
    mhc_mod.mhc_block_unfolded_plain = lambda *a: calls.append(1) or orig(*a)
    try:
        with torch.no_grad():
            got = port(_t(x))
    finally:
        mhc_mod.mhc_block_unfolded_plain = orig
    assert calls == [1]
    _assert_as_far(got.float(), want, _exact(layer, params, constraints, x))


@pytest.mark.parametrize("d", WIDTHS)
def test_serve_block_plain_version_sums_as_jax_pallas_kernel(d):
    """``mhc_block_plain`` against ``mhc_block_pallas_packed`` in interpret
    mode. At d >= 128 the kernel agrees with JAX's layer (correlation > 0.99)
    and the port is held as the layer cases are; at d = 32 and 64 the port is
    held to lie as far from the kernel as JAX's layer does."""
    layer, params, constraints, x = _ill_conditioned(d)
    ops = _operands(params, constraints)
    tokens = x.reshape(-1, d)
    kernel = np.asarray(mhc_block_pallas_packed(tokens, *[jnp.asarray(a) for a in ops]),
                        np.float32)
    got = mhc_mod.mhc_block_plain(_t(tokens), *[torch.from_numpy(np.array(a)) for a in ops])
    assert got.dtype == torch.bfloat16 and got.shape == (tokens.shape[0], d)
    if d >= 128:
        _assert_as_far(got.float(), kernel, _exact(layer, params, constraints, x))
    else:
        jax_layer = jax.jit(layer.apply)({"params": params, "constraints": constraints}, x)
        _assert_as_far(got.float(), jax_layer, kernel, min_corr=MIN_CORR)


@pytest.mark.parametrize("d", [128, 256])
def test_unfolded_block_plain_version_sums_as_jax_pallas_kernel(d):
    """``mhc_block_unfolded_plain`` against ``mhc_block_pallas`` in interpret
    mode (the unfolded Pallas kernel takes d a multiple of 128 only)."""
    layer, params, constraints, x = _ill_conditioned(d, precomputed=False)
    p, c = params, constraints
    ops = [c["h_pre"], p["mlp_in_kernel"]] + _operands(params, constraints)[1:]
    tokens = x.reshape(-1, d)
    kernel = np.asarray(mhc_block_pallas(tokens, *[jnp.asarray(a) for a in ops]), np.float32)
    got = mhc_mod.mhc_block_unfolded_plain(_t(tokens),
                                           *[torch.from_numpy(np.array(a)) for a in ops])
    _assert_as_far(got.float(), kernel, _exact(layer, params, constraints, x))


@pytest.mark.parametrize("d", WIDTHS)
def test_int8_chain_sums_in_fp32_as_jax(d):
    """The int8 chain in bf16 against JAX's jitted int8 layer, with the scales
    JAX calibrates on the same input: each ``matmul_int8`` returns bf16 and
    XLA sums the two in fp32 into LN2 (un-jitted JAX would round the sum;
    the model is always jitted). The fp32 reference is JAX's int8 layer in
    fp32."""
    layer, params, constraints, x = _ill_conditioned(d)
    _, mut = jax.jit(lambda v, a: layer.clone(quant_calib=True).apply(
        v, a, mutable=["quant_stats"]))({"params": params, "constraints": constraints}, x)
    scales = jax.device_get(jq.build_quant_collection(mut["quant_stats"]))
    variables = {"params": params, "constraints": constraints, "quant": scales}
    int8 = layer.clone(act_quant=True)
    want = jax.jit(int8.apply)(variables, x)
    exact = jax.jit(int8.clone(dtype=jnp.float32).apply)(variables, x.astype(jnp.float32))
    port = _port_layer(d, params, act_quant=True, quant_sites=True)
    assert port.int8 and not port.fused
    load_quant_scales(port, load_flax_quant(port, scales))
    with torch.no_grad():
        got = port(_t(x))
    assert got.dtype == torch.bfloat16
    _assert_as_far(got.float(), want, exact)
