"""Sinkhorn projection onto doubly stochastic matrices, in PyTorch.

Counterpart of ``hvs_tpu/ops/sinkhorn.py``: the log-domain loop in fp32 with
the final row update, so row sums are exact to fp32 and column sums converge
geometrically with ``n_iters``. On the serve path it runs once, at load
(``models/constraints.py``).
"""

from __future__ import annotations

import torch


def sinkhorn_log(logits: torch.Tensor, n_iters: int = 20, tau: float = 1.0) -> torch.Tensor:
    """Project ``logits`` [..., n, n] to a doubly stochastic matrix.

    f_i <- -logsumexp_j(L_ij + g_j), g_j <- -logsumexp_i(L_ij + f_i), for
    ``n_iters`` rounds, then one more row update, then exp(L + f + g).
    Computes in fp32; returns the input dtype.
    """
    in_dtype = logits.dtype
    x = logits.float() / tau
    n = x.shape[-1]
    f = x.new_zeros(x.shape[:-2] + (n,))
    g = x.new_zeros(x.shape[:-2] + (n,))
    for _ in range(n_iters):
        f = -torch.logsumexp(x + g[..., None, :], dim=-1)
        g = -torch.logsumexp(x + f[..., :, None], dim=-2)
    f = -torch.logsumexp(x + g[..., None, :], dim=-1)
    return torch.exp(x + f[..., :, None] + g[..., None, :]).to(in_dtype)


def doubly_stochastic_error(matrix: torch.Tensor) -> torch.Tensor:
    """Max |row sum - 1|, |col sum - 1| and negativity, per matrix."""
    m = matrix.float()
    row_err = (m.sum(dim=-1) - 1.0).abs().amax(dim=-1)
    col_err = (m.sum(dim=-2) - 1.0).abs().amax(dim=-1)
    neg_err = torch.clamp(-m, min=0.0).amax(dim=(-1, -2))
    return torch.maximum(torch.maximum(row_err, col_err), neg_err)
