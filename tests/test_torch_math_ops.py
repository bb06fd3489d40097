"""The port's math ops (hvs_tpu_torch.ops.sinkhorn's projections and
diagnostics, hvs_tpu_torch.ops.manifold) against the JAX package's, on the
CPU, in fp32 and in fp64 (JAX under ``jax.enable_x64`` as a context, so that the
switch does not leak into other tests of the worker).

Tolerances: the projections compute in fp32 whatever the input dtype, on
both sides, so they agree to 1e-6 in either; the decompositions (QR, solve,
SVD, eigh) of XLA and of LAPACK agree to fp32 rounding times the inputs'
condition (2e-5 on these well-conditioned inputs) and to 1e-10 in fp64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvs_tpu.ops import manifold as jman
from hvs_tpu.ops import sinkhorn as jsink
from hvs_tpu.training.optimizer import doubly_stochastic_projection as jax_ds_projection
from hvs_tpu_torch.ops import manifold as tman
from hvs_tpu_torch.ops import sinkhorn as tsink
from hvs_tpu_torch.training.optimizer import doubly_stochastic_projection

torch.set_num_threads(1)

TOL = {np.float32: 2e-5, np.float64: 1e-10}


def _np(x):
    return np.asarray(x, dtype=np.float64)


def _run(jfn, tfn, dtype, *arrays):
    """Both functions on the same arrays in ``dtype``; returns (jax, torch)
    results as float64 numpy, in the same containers, after checking that
    each result has JAX's dtype."""
    arrays = [np.asarray(a, dtype) for a in arrays]
    with jax.enable_x64(dtype == np.float64):
        want = jfn(*[jnp.asarray(a) for a in arrays])
    got = tfn(*[torch.from_numpy(a.copy()) for a in arrays])
    is_tensor = lambda t: isinstance(t, torch.Tensor)  # noqa: E731
    jax.tree_util.tree_map(
        lambda w, g: np.testing.assert_equal(str(g.dtype).replace("torch.", ""),
                                             str(np.asarray(w).dtype)),
        want, got, is_leaf=is_tensor)
    return (jax.tree_util.tree_map(_np, want),
            jax.tree_util.tree_map(lambda t: _np(t.detach().numpy()), got, is_leaf=is_tensor))


def _close(want, got, atol):
    jax.tree_util.tree_map(
        lambda w, g: np.testing.assert_allclose(g, w, rtol=0, atol=atol), want, got)


def _logits(shape, seed, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(shape)


def _frame(n, k, seed):
    """An orthonormal n x k frame (QR of a seeded normal matrix, in fp64)."""
    return np.linalg.qr(np.random.default_rng(seed).standard_normal((n, k)))[0]


def _spd(n, seed, floor=0.5):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return a @ a.T / n + floor * np.eye(n)


DTYPES = [np.float32, np.float64]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,tau", [((8, 8), 1.0), ((2, 16, 16), 0.5), ((33, 33), 1.0)])
def test_sinkhorn_projections_match_jax(dtype, shape, tau):
    x = _logits(shape, shape[-1])
    for method in ("log", "multiplicative"):
        want, got = _run(lambda m: jsink.project_to_doubly_stochastic(m, 20, tau, method),
                         lambda m: tsink.project_to_doubly_stochastic(m, 20, tau, method),
                         dtype, x)
        _close(want, got, 1e-6)
    want, got = _run(lambda m: jsink.sinkhorn_knopp(m, 7, tau),
                     lambda m: tsink.sinkhorn_knopp(m, 7, tau), dtype, x)
    _close(want, got, 1e-6)
    want, got = _run(lambda m: jman.birkhoff_project(m, 20, tau),
                     lambda m: tman.birkhoff_project(m, 20, tau), dtype, x)
    _close(want, got, 1e-6)
    # Row sums exact to fp32 after the final row update.
    np.testing.assert_allclose(got.sum(axis=-1), 1.0, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sinkhorn_diagnostics_and_regularization_match_jax(dtype):
    x = _logits((12, 12), 3, 2.0)
    want, got = _run(lambda m: jsink.sinkhorn_with_diagnostics(m, 20, 0.8),
                     lambda m: tsink.sinkhorn_with_diagnostics(m, 20, 0.8), dtype, x)
    _close(want, got, 1e-6)
    raw = _logits((2, 10, 10), 4, 0.3)
    want, got = _run(lambda m: jsink.sinkhorn_regularization_loss(m, 20, 0.7, 1.3),
                     lambda m: tsink.sinkhorn_regularization_loss(m, 20, 0.7, 1.3), dtype, raw)
    _close(want, got, 1e-6 * max(1.0, float(np.abs(want))))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", ["sinkhorn", "softmax", "exponential"])
def test_doubly_stochastic_projection_matches_jax(dtype, method):
    """The training package's standalone projection: fp32 on both sides
    (JAX's returns fp32 for any input), so within 1e-6."""
    x = _logits((2, 12, 12), 20, 2.0)
    want, got = _run(lambda m: jax_ds_projection(m, method, 20),
                     lambda m: doubly_stochastic_projection(m, method, 20), dtype, x)
    _close(want, got, 1e-6)
    with pytest.raises(ValueError, match="unknown projection method"):
        doubly_stochastic_projection(torch.eye(3), "dual")


def test_sinkhorn_projection_keeps_bf16_and_rejects_unknown_method():
    x = torch.from_numpy(_logits((16, 16), 5).astype(np.float32)).to(torch.bfloat16)
    p = tsink.project_to_doubly_stochastic(x)
    assert p.dtype == torch.bfloat16
    want = jsink.project_to_doubly_stochastic(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_allclose(p.float().numpy(), np.asarray(want, np.float32), rtol=0,
                               atol=2e-3)
    with pytest.raises(ValueError, match="unknown sinkhorn method"):
        tsink.project_to_doubly_stochastic(x, method="dual")


@pytest.mark.parametrize("dtype", DTYPES)
def test_stiefel_functions_match_jax(dtype):
    atol = TOL[dtype]
    m = _logits((2, 9, 4), 6)
    want, got = _run(jman.stiefel_project, tman.stiefel_project, dtype, m)
    _close(want, got, atol)
    np.testing.assert_allclose(np.swapaxes(got, -1, -2) @ got, np.broadcast_to(np.eye(4),
                               (2, 4, 4)), rtol=0, atol=10 * atol)
    x, v = _frame(9, 4, 7), _logits((9, 4), 8, 0.3)
    want, got = _run(jman.stiefel_tangent_project, tman.stiefel_tangent_project, dtype, x, v)
    _close(want, got, atol)
    want, got = _run(lambda a, b: jman.stiefel_retract_cayley(a, b, 0.5),
                     lambda a, b: tman.stiefel_retract_cayley(a, b, 0.5), dtype, x, v)
    _close(want, got, atol)
    # Random 4-frames in 9 dimensions: principal angles well away from 0,
    # where arccos's slope is moderate.
    y = _frame(9, 4, 9)
    want, got = _run(jman.stiefel_distance, tman.stiefel_distance, dtype, x, y)
    _close(want, got, atol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_spd_functions_match_jax(dtype):
    atol = TOL[dtype]
    a = _logits((2, 6, 6), 10)
    want, got = _run(lambda m: jman.spd_project(m, 0.05), lambda m: tman.spd_project(m, 0.05),
                     dtype, a)
    _close(want, got, atol)
    p, q = _spd(6, 11), _spd(6, 12)
    v = _logits((6, 6), 13, 0.2)
    v = v + v.T
    want, got = _run(lambda a_, b_: jman.spd_retract_expm(a_, b_, 0.7),
                     lambda a_, b_: tman.spd_retract_expm(a_, b_, 0.7), dtype, p, v)
    _close(want, got, 5 * atol)
    want, got = _run(jman.spd_distance, tman.spd_distance, dtype, p, q)
    _close(want, got, 5 * atol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("manifold", ["birkhoff", "stiefel", "spd"])
def test_riemannian_gradient_regularization_and_checks_match_jax(dtype, manifold):
    atol = TOL[dtype]
    point = {"birkhoff": np.asarray(jsink.sinkhorn_log(jnp.asarray(_logits((7, 7), 14)))),
             "stiefel": _frame(7, 7, 15), "spd": _spd(7, 16)}[manifold]
    grad = _logits((7, 7), 17)
    want, got = _run(lambda a, b: jman.riemannian_gradient(a, b, manifold),
                     lambda a, b: tman.riemannian_gradient(a, b, manifold), dtype, point, grad)
    _close(want, got, atol)
    # The penalty and the check compute in fp32 on both sides whatever the
    # input dtype: fp32 tolerances for both.
    for m in (point, point + 0.05 * grad, _logits((7, 7), 18)):
        want, got = _run(lambda a: jman.manifold_regularization(a, manifold, 0.3),
                         lambda a: tman.manifold_regularization(a, manifold, 0.3), dtype, m)
        _close(want, got, 2e-6 * max(1.0, float(np.abs(want))))
        want, got = _run(lambda a: jman.check_manifold_constraints(a, manifold, 1e-3),
                         lambda a: tman.check_manifold_constraints(a, manifold, 1e-3), dtype, m)
        _close(want, got, 1e-5)
        assert bool(want["satisfied"]) == bool(got["satisfied"])


def test_unknown_manifold_raises_as_jax():
    m = torch.eye(3)
    for fn in (lambda: tman.riemannian_gradient(m, m, "torus"),
               lambda: tman.manifold_regularization(m, "torus"),
               lambda: tman.check_manifold_constraints(m, "torus")):
        with pytest.raises(ValueError, match="unknown manifold"):
            fn()
