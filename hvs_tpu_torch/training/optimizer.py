"""Manifold-aware optimization: the JAX package's optax chain for torch
parameters.

Counterpart of ``hvs_tpu/training/optimizer.py::make_optimizer`` (and
``is_mhc_path``, ``mhc_partition`` as ``partition_label``,
``tangent_precondition``, ``periodic_sinkhorn_projection``, and the
standalone ``doubly_stochastic_projection``).
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
chain keeps its own, and they are always equal). It is a 0-dim int32 tensor
on the parameters' device, advanced inside ``update``; the learning rate,
Adam's bias corrections and the projection test are computed from it on the
device in fp32, as optax computes them under ``jit``. So a CUDA graph that
captures ``update`` reads the current count on every replay instead of the
one it saw at capture, and nothing in ``update`` waits on the host. The
caller multiplies the whole update by ``lr_scale`` (``step``; a float or a
0-dim tensor), so with ``lr_scale < 1`` a projected parameter is not exactly
``log(P + 1e-9)``, as in the JAX trainer.

Each partition's tensors are updated together by ``torch._foreach_*`` ops
(a few launches per partition, not a few per tensor); its clip reads one
norm per tensor (``torch._foreach_norm``) and reduces them once. Like JAX,
the port computes the projection of the square ``H_res_raw`` (both mHC
partitions in one grouped Sinkhorn call, one launch per width) on every
step and selects it with ``torch.where`` on projection steps: 5 forward
launches of kernel B per step at the flagship's widths. The updates are
identical to projecting only on those steps.

Tensor parallelism: ``sharded`` names the tensors that this process holds
as blocks (``parallel.tensor.shard_parameters``). A partition's global norm
then adds the blocks' squared norms over the mesh's model group to the
replicated tensors' (counted once), so every process clips by the norm of
the whole parameters. The updates are elementwise and apply to the blocks as
they are; the tangent preconditioning and the projection take the square
``H_res_raw`` only, which no rule shards (the constructor refuses one).
"""

from __future__ import annotations

from typing import Callable, Collection, Dict, List, Optional, Union

import torch

from ..ops.manifold import birkhoff_tangent_project
from ..ops.sinkhorn import sinkhorn_log, sinkhorn_log_many

MHC_PARAM_NAMES = ("H_pre_raw", "H_post_raw", "H_res_raw")
ADAM_EPS = 1e-8      # optax.adamw's default
SGD_MOMENTUM = 0.9   # the mHC chain's optax.sgd momentum

Tensor = torch.Tensor
Schedule = Union[float, Callable[[Union[int, torch.Tensor]], Union[float, torch.Tensor]]]


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


def global_norm(tensors: List[Tensor], blocks: Optional[List[bool]] = None,
                mesh=None) -> Tensor:
    """The fp32 norm of all of ``tensors`` together: one norm per tensor
    (``torch._foreach_norm``), then the norm of those. Where ``blocks``
    marks a tensor as this process's block of a tensor split over the
    ``mesh``'s model group, the squares of the marked norms are summed over
    that group first (every process of it must call this at once)."""
    norms = torch.stack(torch._foreach_norm([t.float() for t in tensors]))
    if not blocks or not any(blocks):
        return torch.linalg.vector_norm(norms)
    import torch.distributed as dist

    marked = torch.tensor(blocks, device=norms.device)
    sq = norms.square()
    split = torch.where(marked, sq, 0.0).sum()
    dist.all_reduce(split, group=mesh.model_group)
    return torch.sqrt(torch.where(marked, 0.0, sq).sum() + split)


def clip_by_global_norm(grads: List[Tensor], max_norm: float,
                        blocks: Optional[List[bool]] = None, mesh=None) -> List[Tensor]:
    """optax ``clip_by_global_norm``: ``g / norm · max_norm`` unless the global
    norm is below ``max_norm``; ``blocks`` and ``mesh`` as ``global_norm``."""
    norm = global_norm(grads, blocks, mesh)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return torch._foreach_mul(grads, factor)


class ManifoldAwareOptimizer:
    """The optax chain of ``make_optimizer`` for a dict of named torch
    parameters, which ``step`` updates in place.

    ``learning_rate`` is a float or a schedule ``step -> lr`` that takes a
    0-dim tensor (``schedule.cosine_annealing_with_warmup``). State: the step
    count (0-dim int32 on the parameters' device), Adam's moments (``mu``,
    ``nu``) of the AdamW partitions and the momentum trace of the SGD
    partitions, all fp32 and keyed by name. Every state tensor keeps its
    address for the optimizer's life (``load_state_dict`` copies in place),
    so a CUDA graph captured over ``step`` stays valid.
    """

    def __init__(self, params: Dict[str, Tensor], learning_rate: Schedule,
                 weight_decay: float = 0.01, mhc_lr_factor: float = 0.5,
                 clip_regular: float = 1.0, clip_mhc: float = 0.5, b1: float = 0.9,
                 b2: float = 0.999, project_every: int = 100, sk_iters: int = 20,
                 use_projection: bool = True, backbone_lr_factor: float = 1.0,
                 sharded: Collection[str] = (), mesh=None):
        self.params = params
        self.sharded, self.mesh = frozenset(sharded), mesh
        projected = [n for n in self.sharded if _is_square_h_res(n, params[n])]
        if projected:
            raise ValueError(f"{projected}: the tangent preconditioning and the Sinkhorn "
                             f"projection take whole square H_res_raw matrices only")
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
        device = next(iter(params.values())).device
        self.count = torch.zeros((), dtype=torch.int32, device=device)
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

    def global_norm(self, grads: Dict[str, Tensor]) -> Tensor:
        """The global norm of the gradients of the whole parameters."""
        return global_norm(list(grads.values()), self._blocks(grads), self.mesh)

    def _blocks(self, names) -> List[bool]:
        return [n in self.sharded for n in names]

    def lr(self, count: Union[int, Tensor]) -> Union[float, Tensor]:
        """The schedule at ``count`` (a float when it is constant)."""
        lr = self.learning_rate
        return lr(count) if callable(lr) else float(lr)

    @torch.no_grad()
    def update(self, grads: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """The updates for ``grads`` (optax ``tx.update``); advances the state.
        Nothing here reads a value back from the device."""
        count = self.count
        t = (count + 1).float()
        lr = self.lr(count)
        updates: Dict[str, Tensor] = {}
        proposed: Dict[str, Tensor] = {}  # p + u of the H_res_raw to project
        for label, names in self.groups.items():
            adamw, clip, factor = self.chains[label]
            clipped = clip_by_global_norm([grads[n].float() for n in names], clip,
                                          self._blocks(names), self.mesh)
            step_size = -(lr * factor)
            params = [self.params[n] for n in names]
            if adamw:
                mu = [self.mu[n] for n in names]
                nu = [self.nu[n] for n in names]
                torch._foreach_mul_(mu, self.b1)
                torch._foreach_add_(mu, clipped, alpha=1.0 - self.b1)
                torch._foreach_mul_(nu, self.b2)
                torch._foreach_addcmul_(nu, clipped, clipped, value=1.0 - self.b2)
                bc1, bc2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
                denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
                torch._foreach_add_(denom, ADAM_EPS)
                u = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
                torch._foreach_add_(u, [p.float() for p in params], alpha=self.weight_decay)
                torch._foreach_mul_(u, step_size)
                updates.update(zip(names, u))
                continue
            g = [birkhoff_tangent_project(x, x) if _is_square_h_res(n, x) else x
                 for n, x in zip(names, clipped)]
            trace = [self.trace[n] for n in names]
            torch._foreach_mul_(trace, SGD_MOMENTUM)
            torch._foreach_add_(trace, g)
            u = torch._foreach_mul(trace, step_size)
            updates.update(zip(names, u))
            if self.use_projection:
                for n, p, un in zip(names, params, u):
                    if _is_square_h_res(n, un):
                        proposed[n] = p.float() + un
        if proposed:
            project = (count + 1) % self.project_every == 0
            projected = sinkhorn_log_many(list(proposed.values()), n_iters=self.sk_iters)
            for name, proj in zip(proposed, projected):
                hard = torch.log(proj + 1e-9) - self.params[name]
                updates[name] = torch.where(project, hard, updates[name])
        count.add_(1)
        return updates

    @torch.no_grad()
    def step(self, grads: Dict[str, Tensor], lr_scale: Union[float, Tensor] = 1.0) -> None:
        """Apply ``update(grads) · lr_scale`` to the parameters in place."""
        updates = self.update(grads)
        names = list(updates)
        u = torch._foreach_mul([updates[n] for n in names], lr_scale)
        params = [self.params[n] for n in names]
        torch._foreach_add_(params, [x.to(p.dtype) for x, p in zip(u, params)])

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu, "trace": self.trace}

    def load_state_dict(self, state: dict) -> None:
        """Copy a ``state_dict`` into this optimizer's own tensors."""
        self.count.fill_(int(state["count"]))
        for key in ("mu", "nu", "trace"):
            own = getattr(self, key)
            for name, value in state[key].items():
                own[name].copy_(value)


def doubly_stochastic_projection(matrix: Tensor, method: str = "sinkhorn",
                                 n_iters: int = 20) -> Tensor:
    """JAX's standalone projection, in fp32: ``"sinkhorn"`` (``sinkhorn_log``;
    kernel B on a contiguous CUDA matrix), ``"softmax"`` (a row softmax, then 3
    rounds of column and row divisions) or ``"exponential"`` (the Sinkhorn
    projection of log(exp(M - max M) + 1e-9))."""
    m = matrix.float().contiguous()
    if method == "sinkhorn":
        return sinkhorn_log(m, n_iters)
    if method == "softmax":
        p = torch.softmax(m, dim=-1)
        for _ in range(3):
            p = p / (p.sum(dim=-2, keepdim=True) + 1e-9)
            p = p / (p.sum(dim=-1, keepdim=True) + 1e-9)
        return p
    if method == "exponential":
        return sinkhorn_log(torch.log(torch.exp(m - m.amax()) + 1e-9), n_iters)
    raise ValueError(f"unknown projection method: {method!r}")
