"""Tensor parallelism: the rule table executed over the ``model`` axis.

Counterpart of what GSPMD does with ``hvs_tpu/parallel/mesh.py::
param_sharding``: JAX places each rule-matched parameter as a
``NamedSharding`` and XLA partitions the step over that placement; here
``shard_parameters`` replaces each such parameter with this process's block,
and the layers that own them compute with the blocks (``models/layers.py``:
``Dense`` column- or row-parallel, ``ManifoldHyperConnection``'s sharded
chain). A block is contiguous, ``[k·n/m, (k+1)·n/m)`` along the rule's
``"model"`` axis for model index ``k`` of ``m``, as a ``NamedSharding`` lays
it out, so checkpoints and ``sharded_fraction`` mean what they mean in JAX.

Three differentiable collectives over the model group carry the products
(Megatron's pairing of column- and row-parallel products):

* ``gather``: all-gather forward, this process's block of the gradient
  backward (the computation after it is the same on every process);
* ``reduce``: all-reduce forward, the gradient unchanged backward (partial
  sums of a row-parallel product);
* ``copy_in``: unchanged forward, all-reduce backward (a replicated tensor
  entering a computation that each process does on its own block).

A row-parallel product sums its partials in fp32 and rounds once, as one
process's product rounds its fp32 sum once. ``gather_tensors`` and
``shard_tensors`` move whole tensors between the two layouts (checkpoints,
the weights of a kernel that takes whole matrices).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from .mesh import Mesh, PartitionSpec, param_sharding

Tensor = torch.Tensor


def _all_gather(t: Tensor, mesh: Mesh, dim: int) -> Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.model)]
    dist.all_gather(parts, t, group=mesh.model_group)
    return torch.cat(parts, dim)


def block(t: Tensor, mesh: Mesh, dim: int) -> Tensor:
    """This process's block of ``t`` along ``dim`` (a view)."""
    n = t.shape[dim] // mesh.model
    return t.narrow(dim, mesh.model_rank * n, n)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _all_gather(t, mesh, dim)

    @staticmethod
    def backward(ctx, grad):
        return block(grad, ctx.mesh, ctx.dim).contiguous(), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=mesh.model_group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.mesh.model_group)
        return out, None


def gather(t: Tensor, mesh: Mesh, dim: int = -1) -> Tensor:
    """The processes' blocks of ``t`` joined along ``dim``."""
    return _Gather.apply(t, mesh, dim % t.dim())


def reduce(t: Tensor, mesh: Mesh) -> Tensor:
    """``t`` summed over the model group."""
    return _Reduce.apply(t, mesh)


def copy_in(t: Tensor, mesh: Mesh) -> Tensor:
    """``t`` itself; its gradient summed over the model group."""
    return _CopyIn.apply(t, mesh)


def column_parallel(x: Tensor, w: Tensor, bias: Optional[Tensor], mesh: Mesh) -> Tensor:
    """This process's output columns of ``x @ W + bias``: ``x`` replicated,
    ``w`` this process's column block of ``W``, ``bias`` the whole
    (replicated) bias, of which the block's columns are added. Each column
    is computed as one process computes it."""
    y = copy_in(x, mesh) @ w
    if bias is not None:
        y = y + block(copy_in(bias, mesh), mesh, -1)
    return y


def split(x: Tensor, mesh: Mesh) -> Tensor:
    """This process's block of replicated ``x`` along its last axis; the
    gradient of the whole ``x`` is every block's, summed."""
    return block(copy_in(x, mesh), mesh, -1)


def row_parallel(x: Tensor, w: Tensor, mesh: Mesh) -> Tensor:
    """``X @ W`` from this process's blocks: ``x`` of the columns of ``X``,
    ``w`` of the rows of ``W``. The block's partial product in fp32, summed
    over the model group in fp32, rounded to ``w``'s dtype once."""
    return reduce(x.float() @ w.float(), mesh).to(w.dtype)


def sharded_dim(spec: PartitionSpec) -> Optional[int]:
    """The axis a spec splits over ``"model"`` (None: replicated)."""
    return next((i for i, axis in enumerate(spec) if axis == "model"), None)


def shard_parameters(model: nn.Module, mesh: Mesh,
                     rules: Optional[Dict[str, PartitionSpec]] = None) -> Dict[str, int]:
    """Replace every parameter of ``model`` that ``rules`` (default
    ``DEFAULT_PARAM_RULES``) shards with this process's block of it, and
    tell its module (``tp_mesh``, ``tp_dims``). Every process must hold the
    same whole parameters first. Returns the split axis of each sharded
    parameter by name. Raises ``ValueError`` for a matched parameter whose
    module computes with whole tensors only (no name in ``tp_shardable``)."""
    if not mesh.sharded:
        raise ValueError(f"mesh {mesh.shape} has no model group to shard over")
    if sharded_dims(model):
        raise ValueError("the model's parameters are sharded already")
    params = dict(model.named_parameters())
    modules = dict(model.named_modules())
    dims = {}
    for name, spec in param_sharding(mesh, params, rules).items():
        dim = sharded_dim(spec)
        if dim is None:
            continue
        owner, _, leaf = name.rpartition(".")
        module = modules[owner]
        if leaf not in getattr(module, "tp_shardable", ()):
            raise ValueError(f"{name}: the rule {spec} shards it, but "
                             f"{type(module).__name__} computes with whole tensors only")
        full = params[name]
        setattr(module, leaf, nn.Parameter(block(full.detach(), mesh, dim).clone(),
                                           requires_grad=full.requires_grad))
        module.tp_mesh = mesh
        module.tp_dims = {**module.tp_dims, leaf: dim}
        dims[name] = dim
    return dims


def sharded_dims(model: nn.Module) -> Dict[str, int]:
    """The split axis of each parameter of ``model`` held as a block."""
    out = {}
    for owner, module in model.named_modules():
        for leaf, dim in getattr(module, "tp_dims", {}).items():
            out[f"{owner}.{leaf}" if owner else leaf] = dim
    return out


@torch.no_grad()
def gather_tensors(tensors: Dict[str, Tensor], dims: Dict[str, int], mesh: Mesh
                   ) -> Dict[str, Tensor]:
    """Whole tensors from blocks: those named in ``dims`` gathered over the
    model group (a collective every process of it must make, in the same
    order), the others as they are."""
    return {k: _all_gather(v, mesh, dims[k]) if k in dims else v for k, v in tensors.items()}


def shard_tensors(tensors: Dict[str, Tensor], dims: Dict[str, int], mesh: Mesh
                  ) -> Dict[str, Tensor]:
    """This process's blocks of whole tensors (the inverse of
    ``gather_tensors``; views)."""
    return {k: block(v, mesh, dims[k]) if k in dims else v for k, v in tensors.items()}


def gather_parameters(model: nn.Module) -> Dict[str, Tensor]:
    """Every parameter of ``model`` whole (detached), gathering the blocks."""
    dims = sharded_dims(model)
    params = {k: v.detach() for k, v in model.named_parameters()}
    if not dims:
        return params
    mesh = next(m.tp_mesh for m in model.modules() if getattr(m, "tp_dims", None))
    return gather_tensors(params, dims, mesh)


def held_fraction(model: nn.Module, mesh: Mesh) -> Dict[str, float]:
    """``sharded_fraction`` read from the blocks this process holds (a
    sharded parameter's whole size is its block's times ``mesh.model``),
    with the bytes this process holds: the replicated ones plus its blocks."""
    dims = sharded_dims(model)
    total = sharded = held = 0
    for name, p in model.named_parameters():
        nbytes = p.numel() * p.element_size()
        held += nbytes
        whole = nbytes * mesh.model if name in dims else nbytes
        total += whole
        sharded += whole if name in dims else 0
    return {"sharded_params": len(dims), "total_params": len(dict(model.named_parameters())),
            "sharded_bytes_fraction": sharded / max(total, 1), "held_bytes": held,
            "replicated_bytes": total - sharded, "sharded_bytes": sharded}
