"""The ``('data', 'model')`` mesh over ``torch.distributed`` processes.

Counterpart of ``hvs_tpu/parallel/mesh.py`` (``initialize_distributed``,
``make_mesh``, ``shard_batch``, ``DEFAULT_PARAM_RULES``,
``param_sharding``, ``sharded_fraction``). JAX describes the placement as a
mesh and lets XLA insert the collectives; here a ``Mesh`` records the two
sizes, this process's place on each axis and the process group of each:
the processes of one ``data`` group each hold a slice of the global batch
and sum their gradients and the loss's normalisers
(``training/trainer.py::step_on_device``); the processes of one ``model``
group each hold a block of every parameter that the rule table shards and
together compute the one-process step (``tensor.py``, the sharded routes of
``models/layers.py``). The processes are ranked as JAX lays the devices out
(``reshape(n_data, n_model)``): process ``r`` is at data index
``r // n_model`` and model index ``r % n_model``.

``initialize_distributed`` joins the processes: NCCL between cards, gloo
on the CPU, or the backend the caller names. Processes that share one card
name that card and gloo explicitly (NCCL refuses two processes on one
device). ``setup`` is what the entry points call: it joins, then returns
the mesh and this process's device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: DeviceLike = None,
                           backend: Optional[str] = None) -> torch.device:
    """Join ``num_processes`` processes into the default process group, as
    ``jax.distributed.initialize`` does: ``coordinator_address``
    (``host:port``) is the rendezvous (``tcp://host:port``), ``process_id``
    this process's rank. Absent arguments come from ``torchrun``'s
    environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
    With one process it joins nothing, as JAX's does. ``backend`` is
    ``"nccl"`` or ``"gloo"``; by default NCCL when ``device`` is the card and
    gloo on the CPU.

    Returns this process's device: on the card, the card ``device`` names
    (``"cuda:0"``: every process on that card, which needs ``backend="gloo"``)
    or else card ``LOCAL_RANK`` (else ``rank % device_count``) when the
    processes are joined, which it also makes the current card; otherwise
    ``device`` resolved."""
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    named_card = device is not None and torch.device(device).index is not None
    dev = resolve_device(device)
    if num_processes is None or num_processes <= 1 or dist.is_initialized():
        return dev
    if coordinator_address is None or process_id is None:
        raise ValueError(f"{num_processes} processes need a coordinator address and this "
                         f"process's id (or torchrun's environment)")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if not named_card:
            index = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
            if index >= torch.cuda.device_count():
                raise ValueError(
                    f"process {process_id} would take card {index} of "
                    f"{torch.cuda.device_count()}: processes that share a card name it "
                    f"(device='cuda:0') and the gloo backend")
            dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    address = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=address, world_size=num_processes,
                            rank=process_id)
    return dev


def setup(device: DeviceLike = None, config: Any = None, n_model: Optional[int] = None,
          backend: Optional[str] = None) -> Tuple["Mesh", torch.device]:
    """What a training entry point does first: join the processes, then
    build the mesh. ``config`` is a ``DistributedConfig`` (or None): when
    ``enabled`` its ``coordinator_address``, ``num_processes`` and
    ``process_id`` join the processes, else torchrun's environment does (if
    any); its ``data_parallel`` (-1: all processes) and ``model_parallel``
    size the mesh, ``n_model`` overriding the latter. ``device`` and
    ``backend`` go to ``initialize_distributed``. Returns ``(mesh,
    device)``: the device is this process's, which every tensor of the run
    must go to."""
    join = config is not None and config.enabled
    device = initialize_distributed(config.coordinator_address if join else None,
                                    config.num_processes if join else None,
                                    config.process_id if join else None, device=device,
                                    backend=backend)
    n_data = getattr(config, "data_parallel", -1)
    if n_model is None:
        n_model = getattr(config, "model_parallel", 1)
    return make_mesh(n_data=None if n_data == -1 else n_data, n_model=n_model), device


@dataclass(frozen=True)
class Mesh:
    """A ``('data', 'model')`` mesh of processes: ``data`` processes split
    the batch, ``model`` processes split the rule-matched parameters.
    ``rank`` and ``model_rank`` are this process's indices along the two
    axes; ``group`` (also ``data_group``) is the process group the data axis
    sums over and ``model_group`` the one the model axis gathers and sums
    over, each None where that axis runs no collectives (one process along
    it, or no process group). Pure data parallelism sums over the whole
    group (``dist.group.WORLD``)."""

    data: int
    model: int = 1
    rank: int = 0
    group: Any = None
    model_rank: int = 0
    model_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def data_group(self) -> Any:
        return self.group

    @property
    def distributed(self) -> bool:
        """Whether the data axis runs collectives (a process group is set)."""
        return self.group is not None

    @property
    def sharded(self) -> bool:
        """Whether the model axis runs collectives: the parameters that the
        rule table matches are split over ``model_group``."""
        return self.model_group is not None

    @property
    def process_index(self) -> int:
        """This process's rank in the whole mesh."""
        return self.rank * self.model + self.model_rank

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the processes of the data axis, differentiably
        (the backward sums the gradients the same way); ``t`` itself on a
        mesh of one process."""
        return _AllSum.apply(t, self.group) if self.distributed else t


class _AllSum(torch.autograd.Function):
    """A sum over a process group whose gradient is the sum of the
    processes' gradients: each process's output enters every process's
    loss."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllSum.apply(grad, ctx.group), None


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """A ``('data', 'model')`` mesh over ``devices`` (default: the processes
    of the initialised process group, or this process alone). Pure data
    parallelism by default (``n_model=1``). Raises ``AssertionError`` when
    the sizes do not cover the devices, as JAX's does.

    Under a process group with ``n_model > 1`` every process creates every
    data group (the processes ``k, k + n_model, ...``) and then every model
    group (``i·n_model ... i·n_model + n_model - 1``), in that order, and
    keeps the two it belongs to (``dist.new_group`` must be called by every
    process for every group)."""
    joined = dist.is_available() and dist.is_initialized()
    if devices is None:
        devices = list(range(dist.get_world_size() if joined else 1))
    devices = list(devices)
    if n_data is None:
        n_data = len(devices) // n_model
    assert n_data * n_model == len(devices), \
        f"mesh {n_data}x{n_model} != {len(devices)} devices"
    if not joined:
        return Mesh(n_data, n_model)
    r = dist.get_rank()
    data_index, model_index = divmod(r, n_model)
    if n_model == 1:
        return Mesh(n_data, 1, data_index, dist.group.WORLD)
    data_group = model_group = None
    for k in range(n_model):
        g = dist.new_group([k + i * n_model for i in range(n_data)])
        if k == model_index and n_data > 1:
            data_group = g
    for i in range(n_data):
        g = dist.new_group([i * n_model + k for k in range(n_model)])
        if i == data_index:
            model_group = g
    return Mesh(n_data, n_model, data_index, data_group, model_index, model_group)


def shard_batch(mesh: Mesh, batch: Dict[str, Any], device: DeviceLike = None
                ) -> Dict[str, torch.Tensor]:
    """This process's contiguous slice of a global host batch along
    ``data`` (rows ``[rank·b, (rank+1)·b)`` with ``b = B / data``), as
    tensors on ``device``; the whole batch on a one-process mesh."""
    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        n = t.shape[0]
        if n % mesh.data:
            raise ValueError(f"{k}: a global batch of {n} does not split over "
                             f"{mesh.data} processes")
        per = n // mesh.data
        out[k] = t[mesh.rank * per:(mesh.rank + 1) * per].to(dev)
    return out


class PartitionSpec(tuple):
    """A parameter's placement, one entry per axis: ``"model"`` or None
    (replicated along that axis); ``PartitionSpec()`` replicates fully."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec

# JAX's rules (``hvs_tpu/parallel/mesh.py::DEFAULT_PARAM_RULES``) on the
# port's dotted parameter paths, matched as suffixes: column-parallel QKV
# and mHC ``mlp_in``/``H_pre``, row-parallel output projections and
# ``mlp_out``/``H_post``; ``H_res`` stays replicated (the Sinkhorn
# projection normalises over both axes of the whole matrix).
DEFAULT_PARAM_RULES: Dict[str, PartitionSpec] = {
    "qkv.kernel": P(None, "model"),
    "proj.kernel": P("model", None),
    "mlp_in_kernel": P(None, "model"),
    "mlp_out_kernel": P("model", None),
    "H_pre_raw": P(None, "model"),
    "H_post_raw": P("model", None),
}


def param_sharding(mesh: Mesh, params: Dict[str, Any],
                   rules: Optional[Dict[str, PartitionSpec]] = None
                   ) -> Dict[str, PartitionSpec]:
    """Each parameter's ``PartitionSpec`` by name: replicated unless a rule
    matches the end of its path, its rank equals the rule's and each
    ``"model"`` axis divides by the model size. With ``model == 1`` every
    parameter is replicated."""
    rules = DEFAULT_PARAM_RULES if rules is None else rules
    out = {}
    for name, p in params.items():
        out[name] = next((rule for suffix, rule in rules.items()
                          if mesh.model > 1 and name.endswith(suffix)
                          and len(rule) == len(p.shape)
                          and all(p.shape[i] % mesh.model == 0
                                  for i, axis in enumerate(rule) if axis == "model")), P())
    return out


def sharded_fraction(shardings: Dict[str, PartitionSpec], params: Dict[str, Any]
                     ) -> Dict[str, float]:
    """How much of the parameters the specs shard: counts of sharded and of
    all parameters, and the sharded share of their bytes."""
    total_bytes = sharded_bytes = n_sharded = 0
    for name, p in params.items():
        nbytes = int(np.prod(tuple(p.shape))) * p.element_size()
        total_bytes += nbytes
        if any(axis is not None for axis in shardings[name]):
            sharded_bytes += nbytes
            n_sharded += 1
    return {"sharded_params": n_sharded, "total_params": len(params),
            "sharded_bytes_fraction": sharded_bytes / max(total_bytes, 1)}
