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


def test_grouped_call_on_mixed_widths_matches_plain_and_jax():
    """sinkhorn_log_many over widths 8, 8, 16, 77, 16 (tau 0.7): each P
    within 1e-6 of the per-matrix plain version and of JAX's sinkhorn_log,
    and d sum(P·W) / d logits of each matrix within 1e-5 of the largest entry
    of jax.grad's."""
    widths, tau = [8, 8, 16, 77, 16], 0.7
    r = np.random.default_rng(11)
    logits = [_h_init_logits(n, 20 + i) + r.standard_normal((n, n)).astype(np.float32)
              for i, n in enumerate(widths)]
    weights = [r.standard_normal((n, n)).astype(np.float32) for n in widths]

    @jax.jit
    def jax_run(xs):
        ps = [jax_sinkhorn(x, 20, tau) for x in xs]
        grads = jax.grad(lambda v: sum(jnp.sum(jax_sinkhorn(x, 20, tau) * w)
                                       for x, w in zip(v, weights)))(xs)
        return ps, grads

    want_p, want_g = jax.device_get(jax_run([jnp.asarray(x) for x in logits]))
    xs = [torch.from_numpy(x).requires_grad_() for x in logits]
    got = tsink.sinkhorn_log_many(xs, 20, tau)
    sum((p * torch.from_numpy(w)).sum() for p, w in zip(got, weights)).backward()
    for i, (x, p) in enumerate(zip(xs, got)):
        assert p.shape == x.shape
        plain = tsink.sinkhorn_log_plain(x.detach(), 20, tau).numpy()
        np.testing.assert_allclose(p.detach().numpy(), plain, rtol=0, atol=1e-6, err_msg=str(i))
        np.testing.assert_allclose(p.detach().numpy(), want_p[i], rtol=0, atol=1e-6,
                                   err_msg=str(i))
        g = np.asarray(want_g[i])
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max(),
                                   err_msg=str(i))


def test_grouped_call_on_cpu_launches_nothing():
    xs = [torch.from_numpy(_h_init_logits(n, n)).requires_grad_() for n in (8, 24, 8)]
    before = (tsink.launches_forward, tsink.launches_backward)
    out = tsink.sinkhorn_log_many(xs, 20)
    sum(p.sum() for p in out).backward()
    assert (tsink.launches_forward, tsink.launches_backward) == before
    assert tsink.sinkhorn_log_many([], 20) == []
    for x, p in zip(xs, out):
        torch.testing.assert_close(p, tsink.sinkhorn_log_plain(x, 20), rtol=0, atol=1e-7)
        assert x.grad is not None and torch.isfinite(x.grad).all()


def test_cluster_size_takes_the_largest_cluster_the_card_holds_for_the_batch(monkeypatch):
    """The rule over the H100's plans (clusters the card holds at once: 132,
    66, 30, 15, 7 for 1, 2, 4, 8, 16 blocks; a slab that does not fit a block
    gives no plan): at least 8 rows per block, the whole batch at once, else
    the smallest size that fits. The flagship's step: 4, 8, 16, 8, 16."""
    active = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}

    def plan(device, n, backward, cluster):
        rows = -(-n // cluster)
        slab = rows * n * 4 * (2 if backward else 1)
        return None if cluster > n or slab > 200_000 else (cluster, slab, active[cluster])

    monkeypatch.setattr(tsink, "_plan", plan)
    for backward in (False, True):
        picks = [tsink.cluster_size(n, b, backward, device=0)
                 for n, b in ((32, 2), (64, 3), (128, 4), (256, 15), (512, 1))]
        assert picks == [4, 8, 16, 8, 16], (backward, picks)
    assert tsink.cluster_size(8, 1, device=0) == 1      # fewer than 8 rows at any size > 1
    assert tsink.cluster_size(256, 100, device=0) == 2  # no size holds 100: the smallest that fits
    assert tsink.cluster_size(256, 100, True, device=0) == 4
    assert tsink.cluster_size(640, 3, device=0) == 1    # the streamed kernels
