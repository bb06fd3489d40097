"""What the roofline tools share: the card's peaks by its name, its record,
programs captured as CUDA graphs and timed by replay, and their counts.

The tools (``python -m hvs_tpu_torch.roofline``, ``bytes_attribution``,
``train_roofline``, ``gn_fusion_ceiling``, ``head_fusion_ceiling``,
``cls_loss_ab``) keep the JAX scripts' flags, defaults and output keys, plus
``--device``, ``--tiny`` and the peaks. A key that names XLA or the MXU is
renamed for the card, by this table:

    JAX script's key                  port's key
    mxu_utilization                   mfu (product flops / wall / peak)
    xla_flops_per_batch               flops_per_batch
    xla_bytes_accessed_per_batch      bytes_accessed_per_batch
    xla_bytes                         bytes_accessed
    bound "compute (MXU)", "MXU"      bound "compute (tensor cores)"
    bound "HBM bandwidth", "HBM"      bound "HBM bandwidth"

Every other key is kept. Flops, transcendentals and bytes are
``ModelProfiler.cost_analysis``'s (product flops, views excluded, every
operator unfused: its docstring states the convention and how it differs
from XLA's), counted once per program, eagerly. Each program is timed as
replays of one CUDA graph between CUDA events: an eager call of these
programs (1,300 to 20,000 kernels at ~20 µs of host each) would time the
host, and a share of the peak read from it would be the host's.

The peaks are read by the card's name (``PEAKS``); for any other card, and
on the CPU, ``--peak-tflops-bf16`` and ``--peak-hbm-gbps`` must be given.
Every report records the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Callable, Dict, Optional

import torch
from torch import nn

# Dense bf16 tensor-core TFLOP/s and HBM GB/s by card name (NVIDIA's data
# sheet for the SXM part at its 700 W limit; the figures PERF.md's bounds use).
PEAKS = {"NVIDIA H100 80GB HBM3": (989.0, 3350.0)}
OUTPUT_DIR = "runs/torch_perf"
WARMUP_CALLS = 3  # eager calls on a side stream before a capture
# The tiny model of ``--tiny`` (``export_model.tiny_configs``'s widths).
TINY = dict(stage_channels=(16, 24, 32, 40), stage_blocks=(1, 1, 1, 1), vit_dim=16,
            vit_depth=1, vit_heads=2, fpn_channels=16, head_channels=16)
TINY_SK_ITERS = 5

COMPUTE_BOUND = "compute (tensor cores)"
HBM_BOUND = "HBM bandwidth"


def add_args(p: argparse.ArgumentParser) -> None:
    """``--device``, ``--tiny`` and the peaks."""
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--tiny", action="store_true",
                   help="the tiny model (export_model.tiny_configs' widths, 5 Sinkhorn "
                        "iterations), for a run on the CPU")
    p.add_argument("--peak-tflops-bf16", type=float, default=None,
                   help="the card's dense bf16 TFLOP/s (default: by its name)")
    p.add_argument("--peak-hbm-gbps", type=float, default=None,
                   help="the card's memory GB/s (default: by its name)")


def card(device: torch.device) -> Dict[str, Optional[str]]:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (on the
    CPU: ``cpu`` and None)."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        line = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        line = ""
    name, _, limit = line.partition(", ")
    return {"name": name or torch.cuda.get_device_name(device), "power_limit": limit or None}


def peaks(args: argparse.Namespace, device: torch.device) -> Dict:
    """The peaks for the card ``device`` (``PEAKS`` by its name unless both
    are given) and its record; raises for a card not in ``PEAKS`` (and on
    the CPU) unless ``--peak-tflops-bf16`` and ``--peak-hbm-gbps`` are given."""
    rec = card(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    given = (args.peak_tflops_bf16, args.peak_hbm_gbps)
    if None in given:
        if name not in PEAKS:
            raise ValueError(f"no peaks known for {name!r}: pass --peak-tflops-bf16 and "
                             f"--peak-hbm-gbps (known: {sorted(PEAKS)})")
        tflops, gbps = PEAKS[name]
        note = f"{name} data sheet (dense bf16, SXM at 700 W); utilization = achieved/peak"
    else:
        tflops, gbps = given
        note = "given on the command line; utilization = achieved/peak"
    return {"bf16_tflops": float(tflops), "hbm_GBps": float(gbps), "card": rec["name"],
            "power_limit": rec["power_limit"], "note": note}


def model_kwargs(tiny: bool, sk_iters: int = 20) -> Dict:
    """The flagship's constructor options (the tiny widths with ``tiny``)."""
    return dict(TINY, sk_iters=TINY_SK_ITERS) if tiny else dict(sk_iters=sk_iters)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """``fn()`` as one CUDA graph, captured after ``WARMUP_CALLS`` eager calls
    on a side stream (``generator``, when ``fn`` draws from it, is registered
    with the graph so that each replay draws anew); on the CPU, eager.
    ``out`` is the captured call's output, which each replay overwrites;
    ``launches`` the kernel launches the capture counted."""

    def __init__(self, fn: Callable, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        from ..training.chunk import _captured, _warm_up

        self.fn, self.device = fn, device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        self.replays = 0
        if device.type != "cuda":
            self.out = fn()
            return
        _warm_up(fn, device, WARMUP_CALLS)

        def call():
            self.out = fn()

        self.graph, self.launches = _captured(call, device, None, generator)
        sync(device)

    def __call__(self):
        if self.graph is None:
            self.out = self.fn()
            return self.out
        self.graph.replay()
        self.replays += 1
        return self.out

    def seconds(self, iters: int) -> float:
        """Seconds per call over ``iters`` calls after one warm call: CUDA
        events around the replays on the card, the host clock on the CPU."""
        self()
        sync(self.device)
        if self.graph is None:
            t0 = time.perf_counter()
            for _ in range(iters):
                self()
            return (time.perf_counter() - t0) / iters
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            self()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters


class Launches:
    """The kernels a tool launched: the counters' rise since construction
    (eager calls and captures) plus each timed graph's capture count times
    its replays."""

    def __init__(self):
        from ..training.chunk import kernel_counts

        self._start = kernel_counts()
        self._replayed: Dict[str, int] = {k: 0 for k in self._start}

    def add(self, program: Program) -> None:
        for k, n in program.launches.items():
            self._replayed[k] += n * program.replays

    def total(self) -> Dict[str, int]:
        from ..training.chunk import kernel_counts

        now = kernel_counts()
        return {k: now[k] - self._start[k] + self._replayed[k] for k in now}


def cost(fn: Callable) -> Dict[str, float]:
    """``cost_analysis`` of one eager call of ``fn()``."""
    from .profiler import ModelProfiler

    return ModelProfiler(fn).cost_analysis()


def utilization(flops: float, nbytes: float, seconds: float, pk: Dict) -> Dict[str, float]:
    """Achieved TFLOP/s and GB/s, their shares of the peaks (``mfu``,
    ``hbm_utilization``) and the intensity, unrounded."""
    tflops = flops / seconds / 1e12
    gbps = nbytes / seconds / 1e9
    return {"tflops": tflops, "mfu": tflops / pk["bf16_tflops"], "gbps": gbps,
            "hbm_utilization": gbps / pk["hbm_GBps"],
            "intensity": flops / max(nbytes, 1.0)}


def ridge(pk: Dict) -> float:
    """Flops per byte the card needs to be compute-bound."""
    return pk["bf16_tflops"] * 1e12 / (pk["hbm_GBps"] * 1e9)


def identity_norms(module: nn.Module) -> int:
    """Replace every ``GroupNorm`` under ``module`` by ``nn.Identity`` in
    place (the ceilings' ablation); returns how many."""
    from ..models.layers import GroupNorm

    swapped = 0
    for parent in list(module.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, GroupNorm):
                setattr(parent, name, nn.Identity())
                swapped += 1
    return swapped


def write(report: Dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
