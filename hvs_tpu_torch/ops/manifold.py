"""Matrix-manifold projections, retractions, distances and Riemannian
gradients: the Birkhoff polytope, the Stiefel manifold and the SPD cone.

Counterpart of ``hvs_tpu/ops/manifold.py``, function for function. The
Birkhoff projection is the Sinkhorn projection (``ops/sinkhorn.py``; kernel
B on a CUDA tensor, n <= 1024 there). The decompositions (QR, ``solve``,
SVD, ``eigh``) are ``torch.linalg`` calls, as JAX computes them outside any
Pallas kernel; an ``eigh`` in fp32 on the card and XLA's on the CPU agree
only to fp32 rounding, more loosely where eigenvalues lie close together.
"""

from __future__ import annotations

from typing import Dict

import torch

from .sinkhorn import doubly_stochastic_error, sinkhorn_log_fp32


def _t(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(-1, -2)


def _eye_like(m: torch.Tensor, n: int) -> torch.Tensor:
    return torch.eye(n, dtype=m.dtype, device=m.device)


# ---------------------------------------------------------------------------
# Birkhoff polytope (doubly stochastic matrices)


def birkhoff_project(matrix: torch.Tensor, n_iters: int = 20, tau: float = 1.0) -> torch.Tensor:
    """Projection onto the Birkhoff polytope: log-domain Sinkhorn in fp32,
    returned in the input dtype."""
    return sinkhorn_log_fp32(matrix, n_iters, tau)


def birkhoff_tangent_project(point: torch.Tensor, vector: torch.Tensor) -> torch.Tensor:
    """Project ``vector`` onto the tangent space of the Birkhoff polytope at
    ``point``: {V : V 1 = 0, V^T 1 = 0}. The closed form subtracts the row and
    column means and adds back the grand mean (``point`` is not needed)."""
    del point
    row_mean = vector.mean(dim=-1, keepdim=True)
    col_mean = vector.mean(dim=-2, keepdim=True)
    grand_mean = vector.mean(dim=(-1, -2), keepdim=True)
    return vector - row_mean - col_mean + grand_mean


# ---------------------------------------------------------------------------
# Stiefel manifold (orthonormal frames)


def stiefel_project(matrix: torch.Tensor) -> torch.Tensor:
    """Q of the reduced QR decomposition, its columns' signs fixed so that
    diag(R) > 0 (a zero diagonal entry keeps its column)."""
    q, r = torch.linalg.qr(matrix)
    d = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    return q * d[..., None, :]


def stiefel_tangent_project(point: torch.Tensor, vector: torch.Tensor) -> torch.Tensor:
    """Tangent projection at X: V - X sym(X^T V) (canonical metric)."""
    xtv = _t(point) @ vector
    return vector - point @ (0.5 * (xtv + _t(xtv)))


def stiefel_retract_cayley(point: torch.Tensor, tangent: torch.Tensor,
                           step: float = 1.0) -> torch.Tensor:
    """Cayley retraction: with the skew W = A X^T - X A^T,
    X_new = (I - t/2 W)^{-1} (I + t/2 W) X, by a linear solve."""
    w = tangent @ _t(point) - point @ _t(tangent)
    eye = _eye_like(point, point.shape[-2])
    return torch.linalg.solve(eye - (step / 2.0) * w, (eye + (step / 2.0) * w) @ point)


def stiefel_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The norm of the principal angles, arccos of the singular values of
    X^T Y clipped to [-1, 1]. The slope of arccos is unbounded at 1, so
    frames that nearly share a direction give a distance that rounding moves
    far more than its inputs."""
    s = torch.linalg.svdvals(_t(x) @ y).clamp(-1.0, 1.0)
    return torch.linalg.vector_norm(torch.arccos(s), dim=-1)


# ---------------------------------------------------------------------------
# SPD cone (symmetric positive definite matrices)


def _from_eigen(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """U diag(w) U^T."""
    return (u * w[..., None, :]) @ _t(u)


def spd_project(matrix: torch.Tensor, min_eig: float = 1e-6) -> torch.Tensor:
    """Symmetrize, then floor the eigenvalues at ``min_eig``."""
    w, v = torch.linalg.eigh(0.5 * (matrix + _t(matrix)))
    return _from_eigen(v, torch.clamp(w, min=min_eig))


def spd_retract_expm(point: torch.Tensor, tangent: torch.Tensor,
                     step: float = 1.0) -> torch.Tensor:
    """Exponential-map retraction P^{1/2} expm(t P^{-1/2} V P^{-1/2}) P^{1/2}.
    P's eigenvalues are floored at max(1e-6 times its largest, 1e-12) and the
    inner exponent is clipped to ±50, so an ill-conditioned point cannot
    overflow."""
    w, u = torch.linalg.eigh(point)
    w_floor = torch.clamp(1e-6 * w.amax(dim=-1, keepdim=True), min=1e-12)
    w = torch.maximum(w, w_floor)
    sqrt_p = _from_eigen(u, torch.sqrt(w))
    inv_sqrt_p = _from_eigen(u, 1.0 / torch.sqrt(w))
    inner = inv_sqrt_p @ (step * tangent) @ inv_sqrt_p
    wi, ui = torch.linalg.eigh(0.5 * (inner + _t(inner)))
    return sqrt_p @ _from_eigen(ui, torch.exp(wi.clamp(-50.0, 50.0))) @ sqrt_p


def spd_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Affine-invariant distance ||logm(X^{-1/2} Y X^{-1/2})||_F, with the
    eigenvalues floored at 1e-12."""
    w, u = torch.linalg.eigh(x)
    inv_sqrt_x = _from_eigen(u, 1.0 / torch.sqrt(torch.clamp(w, min=1e-12)))
    m = inv_sqrt_x @ y @ inv_sqrt_x
    wm = torch.clamp(torch.linalg.eigvalsh(0.5 * (m + _t(m))), min=1e-12)
    return torch.linalg.vector_norm(torch.log(wm), dim=-1)


# ---------------------------------------------------------------------------
# Riemannian gradients, regularization, constraint checks


def riemannian_gradient(point: torch.Tensor, euclidean_grad: torch.Tensor,
                        manifold: str = "birkhoff") -> torch.Tensor:
    """The Euclidean gradient projected to the tangent space (``birkhoff``,
    ``stiefel``), or P sym(G) P on the SPD cone (affine-invariant metric)."""
    if manifold == "birkhoff":
        return birkhoff_tangent_project(point, euclidean_grad)
    if manifold == "stiefel":
        return stiefel_tangent_project(point, euclidean_grad)
    if manifold == "spd":
        return point @ (0.5 * (euclidean_grad + _t(euclidean_grad))) @ point
    raise ValueError(f"unknown manifold: {manifold!r}")


def manifold_regularization(matrix: torch.Tensor, manifold: str = "birkhoff",
                            weight: float = 1.0) -> torch.Tensor:
    """A penalty that is 0 on the constraint set, in fp32: squared row and
    column sum errors and negative part (``birkhoff``), ||M^T M - I||²
    mean (``stiefel``), asymmetry and negative eigenvalues (``spd``)."""
    m = matrix.float()
    if manifold == "birkhoff":
        row = ((m.sum(dim=-1) - 1.0) ** 2).mean()
        col = ((m.sum(dim=-2) - 1.0) ** 2).mean()
        neg = (torch.relu(-m) ** 2).mean()
        return weight * (row + col + neg)
    if manifold == "stiefel":
        gram = _t(m) @ m
        return weight * ((gram - _eye_like(gram, gram.shape[-1])) ** 2).mean()
    if manifold == "spd":
        asym = m - _t(m)
        w = torch.linalg.eigvalsh(0.5 * (m + _t(m)))
        return weight * ((asym ** 2).mean() + (torch.relu(-w) ** 2).mean())
    raise ValueError(f"unknown manifold: {manifold!r}")


def check_manifold_constraints(matrix: torch.Tensor, manifold: str = "birkhoff",
                               tol: float = 1e-3) -> Dict[str, torch.Tensor]:
    """How far ``matrix`` is from the constraint set, as 0-dim tensors:
    ``max_violation``, ``satisfied`` (max_violation <= ``tol``) and the
    manifold's own readings (row and column sum errors and negativity; the
    smallest eigenvalue)."""
    m = matrix.float()
    if manifold == "birkhoff":
        max_err = doubly_stochastic_error(m).amax()
        return {
            "max_violation": max_err,
            "satisfied": max_err <= tol,
            "row_sum_error": (m.sum(dim=-1) - 1.0).abs().amax(),
            "col_sum_error": (m.sum(dim=-2) - 1.0).abs().amax(),
            "negativity": torch.relu(-m).amax(),
        }
    if manifold == "stiefel":
        # fp32 products (JAX's Precision.HIGHEST): torch's TF32 flag is off
        # unless a caller turned it on; the entry points pin it off.
        gram = _t(m) @ m
        viol = (gram - _eye_like(gram, gram.shape[-1])).abs().amax()
        return {"max_violation": viol, "satisfied": viol <= tol}
    if manifold == "spd":
        asym = (m - _t(m)).abs().amax()
        min_eig = torch.linalg.eigvalsh(0.5 * (m + _t(m))).amin()
        viol = torch.maximum(asym, torch.relu(-min_eig))
        return {"max_violation": viol, "satisfied": viol <= tol, "min_eigenvalue": min_eig}
    raise ValueError(f"unknown manifold: {manifold!r}")
