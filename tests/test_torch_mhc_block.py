"""The fused mHC block of the port (hvs_tpu_torch.ops.mhc_block) and its layer.

The plain version is held against the JAX Pallas kernel
``mhc_block_pallas_packed``, which runs in interpret mode on the CPU as the
JAX package's own tests run it. The layer is held against the JAX layer's
XLA path in fp32. The CUDA kernel itself runs only on a card; its tests are
in test_torch_gpu.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvs_tpu.models import ManifoldHyperConnection as JaxMHC
from hvs_tpu.models import compute_constraints as jax_constraints
from hvs_tpu.ops.pallas import mhc_block_pallas_packed
from hvs_tpu.ops.sinkhorn import sinkhorn_log as jax_sinkhorn
from hvs_tpu_torch.models.constraints import compute_constraints, param_tree
from hvs_tpu_torch.models.layers import ManifoldHyperConnection
from hvs_tpu_torch.ops import mhc_block as mhc_mod

torch.set_num_threads(1)

# Same criteria as tests/test_pallas.py: the two sides round at the same
# points but sum in different orders, and LN2 can amplify a flipped rounding.
MIN_CORR, MAX_MEAN_ABS = 0.999, 0.05


def _block_inputs(n, d, seed):
    """Seeded fp32 inputs. W1/W2 are lecun-scaled and H_post is scaled by
    1/sqrt(d), so the pre-LN2 row is not a near-constant that LN2 cancels into
    rounding noise; H_res is near-identity, as in tests/test_pallas.py."""
    r = np.random.default_rng(seed)
    f = np.float32
    x = r.standard_normal((n, d)).astype(f)
    w1 = (r.standard_normal((d, d)) / math.sqrt(d)).astype(f)
    w2 = (r.standard_normal((d, d)) / math.sqrt(d)).astype(f)
    h_post = (2.0 / (1.0 + np.exp(-0.1 * r.standard_normal((d, d)))) / math.sqrt(d)).astype(f)
    h_res = np.array(jax_sinkhorn(jnp.asarray(6.0 * np.eye(d) + r.standard_normal((d, d)),
                                              jnp.float32), 20))
    b1, b2 = (0.01 * r.standard_normal(d)).astype(f), (0.01 * r.standard_normal(d)).astype(f)
    ln = [(1 + 0.1 * r.standard_normal(d)).astype(f), (0.1 * r.standard_normal(d)).astype(f),
          (1 + 0.1 * r.standard_normal(d)).astype(f), (0.1 * r.standard_normal(d)).astype(f)]
    return x, [w1, b1, w2, b2, h_post, h_res] + ln


@pytest.mark.parametrize("d,n", [(32, 1234), (64, 1234), (128, 300), (256, 300)])
def test_plain_version_matches_jax_pallas_kernel(d, n):
    x, args = _block_inputs(n, d, seed=d)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(mhc_block_pallas_packed(xj, *[jnp.asarray(a) for a in args]), np.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = mhc_mod.mhc_block_plain(xt, *[torch.from_numpy(a) for a in args])
    assert got.dtype == torch.bfloat16 and got.shape == (n, d)
    a, b = got.float().numpy().ravel(), want.ravel()
    assert np.corrcoef(a, b)[0, 1] > MIN_CORR
    assert np.mean(np.abs(a - b)) < MAX_MEAN_ABS


def test_wrapper_takes_plain_version_for_cpu_tensors():
    x, args = _block_inputs(200, 64, seed=3)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    targs = [torch.from_numpy(a) for a in args]
    before = mhc_mod.launches
    out = mhc_mod.mhc_block(xt, *targs)
    assert mhc_mod.launches == before  # nothing launched for a CPU tensor
    torch.testing.assert_close(out, mhc_mod.mhc_block_plain(xt, *targs), rtol=0, atol=0)


def _jax_layer(d, expansion, ratio, x_shape, seed, conditioned=False):
    layer = JaxMHC(dim=d, expansion_rate=expansion, mlp_ratio=ratio, sk_iters=10,
                   dropout_rate=0.0, precomputed_constraints=True, dtype=jnp.float32)
    x = jnp.zeros(x_shape, jnp.float32)
    params = jax.device_get(layer.init(jax.random.PRNGKey(seed), x)["params"])
    r = np.random.default_rng(seed)
    # Move every parameter off its init value so biases and norms are exercised.
    params = {k: (v + 0.1 * r.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()}
    if conditioned:
        params["H_res_raw"] = (6.0 * np.eye(d) + r.standard_normal((d, d))).astype(np.float32)
    return layer, params


@pytest.mark.parametrize("d,expansion,ratio,x_shape", [
    (64, 1, 1, (2, 5, 7, 64)),   # a backbone/FPN/head site (fused in bf16)
    (32, 1, 2, (3, 9, 32)),      # a ViT mhc_ffn site
    (16, 2, 2, (4, 16)),         # expanded hidden width
])
def test_mhc_layer_fp32_matches_jax_xla_path(d, expansion, ratio, x_shape):
    layer, params = _jax_layer(d, expansion, ratio, x_shape, seed=d)
    x = np.random.default_rng(1).standard_normal(x_shape).astype(np.float32)
    variables = {"params": params,
                 "constraints": jax_constraints({"l": params}, 10)["l"]}
    want = np.asarray(layer.apply(variables, jnp.asarray(x)))

    port = ManifoldHyperConnection(d, expansion, ratio, dtype=torch.float32)
    with torch.no_grad():
        for k, v in params.items():
            getattr(port, k).copy_(torch.from_numpy(v))
    port.set_constraints(compute_constraints({"l": param_tree(port)}, 10)["l"])
    assert not port.fused  # fp32 runs the layer's own chain
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_mhc_layer_bf16_fused_site_matches_jax():
    """A bf16 site with expansion 1 and mlp_ratio 1 takes the fused block
    (its plain version here) and agrees with the JAX layer in bf16."""
    d, shape = 64, (2, 6, 5, 64)
    layer, params = _jax_layer(d, 1, 1, shape, seed=5, conditioned=True)
    layer = layer.clone(dtype=jnp.bfloat16)
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    variables = {"params": params, "constraints": jax_constraints({"l": params}, 10)["l"]}
    with jax.default_matmul_precision("bfloat16"):
        want = np.asarray(layer.apply(variables, jnp.asarray(x)), np.float32)

    port = ManifoldHyperConnection(d, 1, 1, dtype=torch.bfloat16)
    with torch.no_grad():
        for k, v in params.items():
            getattr(port, k).copy_(torch.from_numpy(v))
    port.set_constraints(compute_constraints({"l": param_tree(port)}, 10)["l"])
    assert port.fused
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == shape
    a, b = got.float().numpy().ravel(), want.ravel()
    assert np.corrcoef(a, b)[0, 1] > MIN_CORR
    assert np.mean(np.abs(a - b)) < MAX_MEAN_ABS


def test_layer_without_constraints_raises():
    port = ManifoldHyperConnection(32, 1, 1, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="constraints"):
        port(torch.zeros(2, 32))


@pytest.mark.parametrize("d,expansion,ratio,dtype,fused", [
    (32, 1, 1, torch.bfloat16, True),
    (512, 1, 1, torch.bfloat16, True),
    (256, 1, 2, torch.bfloat16, False),   # mhc_ffn / mhc_features
    (48, 1, 1, torch.bfloat16, False),    # no kernel width
    (64, 1, 1, torch.float32, False),
])
def test_fused_sites(d, expansion, ratio, dtype, fused):
    assert ManifoldHyperConnection(d, expansion, ratio, dtype=dtype).fused == fused
