"""The port's Sinkhorn (hvs_tpu_torch.ops.sinkhorn) against the JAX package.

The plain version is held against the JAX Pallas kernel
``sinkhorn_log_pallas``, run in interpret mode on the CPU as the JAX
package's own tests run it, and its autograd gradient against ``jax.grad``
of ``hvs_tpu.ops.sinkhorn.sinkhorn_log``: the gradient of the unrolled
loop, which the Hopper kernel's backward computes too. The CUDA kernels run
only on a card; their tests are in test_torch_gpu.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvs_tpu.ops.pallas import sinkhorn_log_pallas
from hvs_tpu.ops.sinkhorn import sinkhorn_log as jax_sinkhorn
from hvs_tpu_torch.ops import sinkhorn as tsink

torch.set_num_threads(1)


def _h_init_logits(n, seed):
    """Logits at the scale of the mHC init (variance scaling 0.1, fan_avg)."""
    limit = math.sqrt(3.0 * 0.1 / n)
    return np.random.default_rng(seed).uniform(-limit, limit, (n, n)).astype(np.float32)


@pytest.mark.parametrize("n", [32, 77, 128])
def test_plain_version_matches_jax_pallas_kernel(n):
    logits = _h_init_logits(n, n) + np.random.default_rng(1).standard_normal((n, n)).astype(
        np.float32)
    want = np.asarray(sinkhorn_log_pallas(jnp.asarray(logits), n_iters=20))
    got = tsink.sinkhorn_log_plain(torch.from_numpy(logits), 20).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # Row sums exact to fp32 after the final row update.
    np.testing.assert_allclose(got.sum(axis=-1), 1.0, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,scale", [(32, 0.0), (77, 1.0), (256, 0.0), (512, 0.0), (64, 2.0)])
def test_plain_gradient_matches_jax_grad_of_unrolled_loop(n, scale):
    """d sum(P·W) / d logits, 20 iterations, tau 1 (and tau 0.7 at n = 77):
    within 1e-5 of the gradient's largest magnitude."""
    r = np.random.default_rng(n)
    logits = _h_init_logits(n, n) + scale * r.standard_normal((n, n)).astype(np.float32)
    weight = r.standard_normal((n, n)).astype(np.float32)
    tau = 0.7 if n == 77 else 1.0

    @jax.jit
    def jax_grad(x):
        return jax.grad(lambda v: jnp.sum(jax_sinkhorn(v, 20, tau) * weight))(x)

    want = np.asarray(jax_grad(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    (tsink.sinkhorn_log_plain(x, 20, tau) * torch.from_numpy(weight)).sum().backward()
    got = x.grad.numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_wrapper_takes_plain_version_for_cpu_tensors():
    logits = torch.from_numpy(_h_init_logits(48, 3)).requires_grad_()
    before = (tsink.launches_forward, tsink.launches_backward)
    p = tsink.sinkhorn_log(logits, 20)
    p.sum().backward()
    assert (tsink.launches_forward, tsink.launches_backward) == before
    torch.testing.assert_close(p, tsink.sinkhorn_log_plain(logits, 20), rtol=0, atol=0)
    assert logits.grad is not None and torch.isfinite(logits.grad).all()


def test_plain_version_keeps_dtype_and_computes_fp64_in_fp64():
    x = torch.from_numpy(_h_init_logits(8, 4))
    assert tsink.sinkhorn_log_plain(x.to(torch.bfloat16), 5).dtype == torch.bfloat16
    p64 = tsink.sinkhorn_log_plain(x.double(), 200)
    assert p64.dtype == torch.float64
    # fp64 throughout: converged far below fp32 rounding (the error is taken
    # here in fp64; doubly_stochastic_error measures in fp32).
    assert float((p64.sum(dim=-2) - 1.0).abs().max()) < 1e-12
    assert float((p64.sum(dim=-1) - 1.0).abs().max()) < 1e-12
