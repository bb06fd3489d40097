"""Manifold-aware optimization: the JAX package's optax chain for torch
parameters.

Counterpart of ``hvs_tpu/training/optimizer.py::make_optimizer`` (and
``is_mhc_path``, ``tangent_precondition``, ``periodic_sinkhorn_projection``).
It updates exactly as that ``optax.multi_transform`` does:

  * partition by path: every parameter under a scope named ``mhc*`` or named
    ``H_pre_raw``/``H_post_raw``/``H_res_raw`` is ``mhc`` (MLP kernels,
    biases and norms of the mHC layers included), the rest ``regular``; with
    ``backbone_lr_factor != 1`` the ``backbone`` subtree splits off into
    ``backbone`` and ``mhc_backbone``;
  * each partition clips its own gradients by their global norm;
  * ``regular``/``backbone``: AdamW (eps 1e-8, decoupled decay on every leaf)
    at ``lr(count)·factor``;
  * ``mhc``/``mhc_backbone``: Birkhoff tangent preconditioning of square
    ``H_res_raw`` gradients, SGD with momentum 0.9 at
    ``lr(count)·mhc_lr_factor·factor``, then the periodic Sinkhorn projection:
    on steps with ``(count + 1) % project_every == 0`` the ``H_res_raw``
    update becomes ``log(Sinkhorn(p + u) + 1e-9) - p``.

``count`` is the number of updates made before this one (each optax inner
chain keeps its own, and they are always equal). The caller multiplies the
whole update by ``lr_scale`` (``step``), so with ``lr_scale < 1`` a projected
parameter is not exactly ``log(P + 1e-9)``, as in the JAX trainer.

JAX computes the projection on every step and selects it with ``jnp.where``;
the port runs eagerly and launches Sinkhorn only on projection steps, over
the square ``H_res_raw`` of both mHC partitions in one grouped call. The
updates are identical.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Union

import numpy as np
import torch

from ..ops.manifold import birkhoff_tangent_project
from ..ops.sinkhorn import sinkhorn_log_many

MHC_PARAM_NAMES = ("H_pre_raw", "H_post_raw", "H_res_raw")
ADAM_EPS = 1e-8      # optax.adamw's default
SGD_MOMENTUM = 0.9   # the mHC chain's optax.sgd momentum

Tensor = torch.Tensor
Schedule = Union[float, Callable[[int], float]]


def is_mhc_path(name: str) -> bool:
    """The reference's name test (``'mhc' in name or 'H_' in name``) on a
    dotted parameter path."""
    return any(k in MHC_PARAM_NAMES or k.startswith("mhc") for k in name.split("."))


def is_backbone_path(name: str) -> bool:
    return name.split(".", 1)[0] == "backbone"


def partition_label(name: str, backbone_lr_factor: float = 1.0) -> str:
    """The optax partition a parameter belongs to."""
    backbone = backbone_lr_factor != 1.0 and is_backbone_path(name)
    if is_mhc_path(name):
        return "mhc_backbone" if backbone else "mhc"
    return "backbone" if backbone else "regular"


def _is_square_h_res(name: str, t: Tensor) -> bool:
    return name.rsplit(".", 1)[-1] == "H_res_raw" and t.dim() == 2 and t.shape[0] == t.shape[1]


def clip_by_global_norm(grads: List[Tensor], max_norm: float) -> List[Tensor]:
    """optax ``clip_by_global_norm``: ``g / norm · max_norm`` unless the global
    norm is below ``max_norm``."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    return [torch.where(norm < max_norm, g, g / norm * max_norm) for g in grads]


class ManifoldAwareOptimizer:
    """The optax chain of ``make_optimizer`` for a dict of named torch
    parameters, which ``step`` updates in place.

    ``learning_rate`` is a float or a schedule ``step -> lr``. State: the step
    count, Adam's moments (``mu``, ``nu``) of the AdamW partitions and the
    momentum trace of the SGD partitions, all fp32 and keyed by name.
    """

    def __init__(self, params: Dict[str, Tensor], learning_rate: Schedule,
                 weight_decay: float = 0.01, mhc_lr_factor: float = 0.5,
                 clip_regular: float = 1.0, clip_mhc: float = 0.5, b1: float = 0.9,
                 b2: float = 0.999, project_every: int = 100, sk_iters: int = 20,
                 use_projection: bool = True, backbone_lr_factor: float = 1.0):
        self.params = params
        self.learning_rate = learning_rate
        self.weight_decay, self.b1, self.b2 = weight_decay, b1, b2
        self.project_every, self.sk_iters = project_every, sk_iters
        self.use_projection = use_projection
        self.groups: Dict[str, List[str]] = {}
        for name in params:
            self.groups.setdefault(partition_label(name, backbone_lr_factor), []).append(name)
        # Per partition: (AdamW?, global-norm clip, LR factor).
        self.chains = {
            "regular": (True, clip_regular, 1.0),
            "backbone": (True, clip_regular, backbone_lr_factor),
            "mhc": (False, clip_mhc, mhc_lr_factor),
            "mhc_backbone": (False, clip_mhc, mhc_lr_factor * backbone_lr_factor),
        }
        self.count = 0
        self.mu: Dict[str, Tensor] = {}
        self.nu: Dict[str, Tensor] = {}
        self.trace: Dict[str, Tensor] = {}
        for label, names in self.groups.items():
            for name in names:
                zero = torch.zeros_like(params[name], dtype=torch.float32)
                if self.chains[label][0]:
                    self.mu[name], self.nu[name] = zero, zero.clone()
                else:
                    self.trace[name] = zero

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def update(self, grads: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """The updates for ``grads`` (optax ``tx.update``); advances the state.

        The scalars (step size, Adam's bias corrections) are rounded to fp32
        as optax computes them: ``1 - 0.999**t`` differs by 1e-5 relative
        between fp32 and fp64."""
        count = self.count
        f32 = np.float32
        lr = f32(self.lr(count))
        updates: Dict[str, Tensor] = {}
        proposed: Dict[str, Tensor] = {}  # p + u of the H_res_raw to project
        for label, names in self.groups.items():
            adamw, clip, factor = self.chains[label]
            clipped = clip_by_global_norm([grads[n].float() for n in names], clip)
            step_size = float(-(lr * f32(factor)))
            if adamw:
                t = f32(count + 1)
                bc1, bc2 = float(f32(1) - f32(self.b1) ** t), float(f32(1) - f32(self.b2) ** t)
                for name, g in zip(names, clipped):
                    mu = self.mu[name].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                    nu = self.nu[name].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                    u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
                    u = u + self.weight_decay * self.params[name].float()
                    updates[name] = u * step_size
                continue
            project = self.use_projection and (count + 1) % self.project_every == 0
            for name, g in zip(names, clipped):
                p = self.params[name]
                if _is_square_h_res(name, g):
                    g = birkhoff_tangent_project(g, g)
                tr = self.trace[name].mul_(SGD_MOMENTUM).add_(g)
                u = tr * step_size
                if project and _is_square_h_res(name, u):
                    proposed[name] = p.float() + u
                updates[name] = u
        projected = sinkhorn_log_many(list(proposed.values()), n_iters=self.sk_iters)
        for name, proj in zip(proposed, projected):
            updates[name] = torch.log(proj + 1e-9) - self.params[name]
        self.count = count + 1
        return updates

    @torch.no_grad()
    def step(self, grads: Dict[str, Tensor], lr_scale: float = 1.0) -> None:
        """Apply ``update(grads) · lr_scale`` to the parameters in place."""
        for name, u in self.update(grads).items():
            p = self.params[name]
            p.add_((u * lr_scale).to(p.dtype))

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu, "trace": self.trace}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for key in ("mu", "nu", "trace"):
            own = getattr(self, key)
            for name, value in state[key].items():
                own[name].copy_(value)
