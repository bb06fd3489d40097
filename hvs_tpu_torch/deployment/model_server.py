"""Model export and serving management.

Counterpart of ``hvs_tpu/deployment/model_server.py``:

  * :class:`ModelExporter` — the serve function (uint8 NHWC -> /255 ->
    detection forward -> ``postprocess_detections`` with its defaults ->
    boxes, scores, classes) as a ``torch.export`` program saved to ``.pt2``
    (in place of the StableHLO artifact), the weights as ``torch.save`` of
    the parameters (in place of flax msgpack), and the original-vs-exported
    consistency check (rtol 1e-3, atol 1e-4). Kernel A is the registered
    operator ``hvs::mhc_block``, so the program records it and, loaded on the
    card, launches the kernel at every fused site.
  * :class:`ServingModelConfig` — the serving shape and batching descriptor,
    its manifest and ``config.pbtxt`` (text identical to the reference's).
  * :class:`RegistryGate` — admission thresholds from
    ``configs/model_registry.yaml``.
  * :class:`ModelServerManager` — the versioned repository with gated
    admission, the gated hot swap into a live engine, and the in-process
    REST or gRPC backend.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.yolo_head import postprocess_detections

@dataclass
class ServingModelConfig:
    name: str = "hybrid_vision"
    image_size: int = 640
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    precision: str = "bf16"
    max_queue_delay_ms: float = 10.0

    def to_manifest(self) -> Dict[str, Any]:
        """Serving manifest: input schema, outputs, dynamic batching."""
        return {
            "name": self.name,
            "input": {"shape": [-1, self.image_size, self.image_size, 3],
                      "dtype": "uint8"},
            "outputs": ["boxes", "scores", "classes", "num_valid"],
            "dynamic_batching": {
                "preferred_batch_sizes": list(self.batch_buckets),
                "max_queue_delay_ms": self.max_queue_delay_ms,
            },
            "precision": self.precision,
        }


class _ServeProgram(nn.Module):
    """The exported serve function over a model whose mHC constraints are
    installed: uint8 [B, S, S, 3] -> (boxes [B, K, 4] normalized xyxy,
    scores [B, K], classes [B, K] int32)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor):
        x = images.float() / 255.0
        det = postprocess_detections(self.model(x, task="detection")["detection"])
        return det.boxes, det.scores, det.classes


class ModelExporter:
    """Exports a serving model (``ProductionHybridVision`` with its
    constraints installed, as ``InferenceEngine.model`` holds it) on the
    device its parameters are on."""

    def __init__(self, model: nn.Module, image_size: int = 640):
        self.model = model
        self.image_size = image_size
        self.device = next(model.parameters()).device

    def _serve_fn(self) -> nn.Module:
        return _ServeProgram(self.model).eval()

    def example_input(self, batch: int) -> torch.Tensor:
        """A seeded (seed 0) uint8 [batch, S, S, 3] batch on the model's device."""
        rng = np.random.default_rng(0)
        x = rng.integers(0, 255, (batch, self.image_size, self.image_size, 3), np.uint8)
        return torch.from_numpy(x).to(self.device)

    # ------------------------------------------------------------------
    def export_program(self, path: str, batch: int = 1) -> str:
        """``torch.export`` of the serve function at a fixed uint8
        [batch, S, S, 3] input, saved with ``torch.export.save``."""
        serve = self._serve_fn()
        example = self.example_input(batch)
        with torch.no_grad():
            serve(example)  # fills the model's host-side caches (anchor grids) eagerly
            program = torch.export.export(serve, (example,), strict=False)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.export.save(program, path)
        return path

    @staticmethod
    def load_program(path: str) -> nn.Module:
        """The saved program as a callable module. Importing ``ops.mhc_block``
        registers ``hvs::mhc_block`` first, which the program calls."""
        from ..ops import mhc_block  # noqa: F401

        return torch.export.load(path).module()

    # ------------------------------------------------------------------
    def export_weights(self, path: str) -> str:
        """The parameters, ``{"params": {name: tensor}}`` on the CPU, which
        ``InferenceEngine.load_checkpoint`` reads back."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        params = {name: p.detach().cpu() for name, p in self.model.named_parameters()}
        torch.save({"params": params}, path)
        return path

    # ------------------------------------------------------------------
    def consistency_check(self, exported_path: str, rtol: float = 1e-3,
                          batch: int = 1) -> Dict[str, Any]:
        """The serve function against the saved program on one seeded uint8
        batch (seed 0): within ``rtol`` and atol 1e-4 on every output."""
        x = self.example_input(batch)
        with torch.no_grad():
            original = self._serve_fn()(x)
            restored = self.load_program(exported_path)(x)
        pairs = [(a.float().cpu().numpy(), b.float().cpu().numpy())
                 for a, b in zip(original, restored)]
        max_diff = max(float(np.max(np.abs(a - b))) for a, b in pairs)
        ok = all(a.shape == b.shape and np.allclose(a, b, rtol=rtol, atol=1e-4)
                 for a, b in pairs)
        return {"consistent": bool(ok), "max_abs_diff": max_diff}


def _config_pbtxt(cfg: ServingModelConfig) -> str:
    """Triton-style textproto serving config (the reference's text)."""
    preferred = ", ".join(str(b) for b in cfg.batch_buckets)
    return f"""name: "{cfg.name}"
platform: "jax_stablehlo"
max_batch_size: {max(cfg.batch_buckets)}
input [
  {{
    name: "images"
    data_type: TYPE_UINT8
    dims: [ {cfg.image_size}, {cfg.image_size}, 3 ]
  }}
]
output [
  {{ name: "boxes" data_type: TYPE_FP32 dims: [ -1, 4 ] }},
  {{ name: "scores" data_type: TYPE_FP32 dims: [ -1 ] }},
  {{ name: "classes" data_type: TYPE_INT32 dims: [ -1 ] }},
  {{ name: "num_valid" data_type: TYPE_INT32 dims: [ 1 ] }}
]
dynamic_batching {{
  preferred_batch_size: [ {preferred} ]
  max_queue_delay_microseconds: {int(cfg.max_queue_delay_ms * 1000)}
}}
instance_group [
  {{ count: 1 kind: KIND_MODEL }}
]
"""


class RegistryGate:
    """Serving admission gates (``configs/model_registry.yaml``: min mAP 0.75,
    max latency 50 ms, precision and recall floors, and the mHC
    constraint-health gates)."""

    DEFAULTS = {
        "min_map_50": 0.75,
        "max_latency_ms": 50.0,
        "min_precision": 0.8,
        "min_recall": 0.7,
        "max_ds_error": 1e-3,
        "max_eigenvalue": 1.0,
    }

    def __init__(self, registry_yaml: Optional[str] = None,
                 gates: Optional[Dict[str, float]] = None):
        self.gates = dict(self.DEFAULTS)
        self.keep_last = 5
        if registry_yaml and os.path.exists(registry_yaml):
            import yaml

            with open(registry_yaml) as f:
                doc = yaml.safe_load(f) or {}
            self.gates.update(doc.get("admission_gates", {}))
            self.keep_last = int(doc.get("promotion", {}).get("keep_last", 5))
        if gates:
            self.gates.update(gates)

    def admit(self, metrics: Dict[str, float]) -> Tuple[bool, List[str]]:
        """Check candidate metrics against every gate; returns (ok, reasons)."""
        failures = []
        checks = [
            ("map_50", "min_map_50", lambda v, g: v >= g),
            ("latency_ms", "max_latency_ms", lambda v, g: v <= g),
            ("precision", "min_precision", lambda v, g: v >= g),
            ("recall", "min_recall", lambda v, g: v >= g),
            ("ds_error", "max_ds_error", lambda v, g: v <= g),
            ("max_eigenvalue", "max_eigenvalue", lambda v, g: v <= g),
        ]
        for metric, gate, ok in checks:
            if gate in self.gates and metric in metrics:
                if not ok(float(metrics[metric]), float(self.gates[gate])):
                    failures.append(
                        f"{metric}={metrics[metric]:.4g} fails {gate}={self.gates[gate]}"
                    )
        return (not failures, failures)


def _versions(name_dir: str) -> List[int]:
    return sorted((int(d) for d in os.listdir(name_dir) if d.isdigit()), reverse=True)


class ModelServerManager:
    """Versioned model repository with gated admission, and the in-process
    serving backends, over one ``InferenceEngine``."""

    def __init__(self, engine, config: Optional[ServingModelConfig] = None,
                 gate: Optional[RegistryGate] = None):
        self.engine = engine
        self.config = config or ServingModelConfig()
        self.gate = gate or RegistryGate()
        self.grpc_server = None

    # ------------------------------------------------------------------
    def build_repository(self, root: str, version: int = 1,
                         metrics: Optional[Dict[str, float]] = None,
                         program: bool = False) -> Dict[str, Any]:
        """Write one version of the engine's model::

            root/<name>/config.pbtxt          serving config (dynamic batching)
            root/<name>/manifest.json         io schema
            root/<name>/<version>/weights.pt  the deployable weights
            root/<name>/<version>/model.pt2   the exported program (optional)
            root/<name>/<version>/metrics.json + ADMITTED  admission record

        A version whose metrics fail a gate is written but not admitted, and
        ``load_from_repository`` refuses it. Versions past the gate's
        ``keep_last`` are removed.
        """
        name_dir = os.path.join(root, self.config.name)
        model_dir = os.path.join(name_dir, str(version))
        os.makedirs(model_dir, exist_ok=True)
        with open(os.path.join(name_dir, "config.pbtxt"), "w") as f:
            f.write(_config_pbtxt(self.config))
        with open(os.path.join(name_dir, "manifest.json"), "w") as f:
            json.dump(self.config.to_manifest(), f, indent=2)

        exporter = ModelExporter(self.engine.model, self.config.image_size)
        exporter.export_weights(os.path.join(model_dir, "weights.pt"))
        if program:
            exporter.export_program(os.path.join(model_dir, "model.pt2"))

        admitted, failures = (True, [])
        if metrics is not None:
            admitted, failures = self.gate.admit(metrics)
            with open(os.path.join(model_dir, "metrics.json"), "w") as f:
                json.dump(metrics, f, indent=2, default=float)
        marker = os.path.join(model_dir, "ADMITTED")
        if admitted:
            with open(marker, "w") as f:
                json.dump({"time": time.time(), "gates": self.gate.gates}, f)
        elif os.path.exists(marker):
            os.remove(marker)
        for stale in _versions(name_dir)[self.gate.keep_last:]:
            shutil.rmtree(os.path.join(name_dir, str(stale)), ignore_errors=True)
        return {"root": root, "version": version, "admitted": admitted,
                "failures": failures, "path": model_dir}

    @staticmethod
    def latest_admitted(root: str, name: str) -> Optional[int]:
        name_dir = os.path.join(root, name)
        if not os.path.isdir(name_dir):
            return None
        for v in _versions(name_dir):
            if os.path.exists(os.path.join(name_dir, str(v), "ADMITTED")):
                return v
        return None

    def load_from_repository(self, root: str, version: Optional[int] = None) -> int:
        """Hot-swap an admitted version into the live engine
        (``engine.reload``: in place, the captured graphs keep serving);
        refuses a version that was not admitted."""
        if version is None:
            version = self.latest_admitted(root, self.config.name)
            if version is None:
                raise RuntimeError("no admitted version in repository")
        model_dir = os.path.join(root, self.config.name, str(version))
        if not os.path.exists(os.path.join(model_dir, "ADMITTED")):
            raise RuntimeError(f"version {version} was not admitted for serving")
        restored = torch.load(os.path.join(model_dir, "weights.pt"), map_location="cpu")
        self.engine.reload({"params": restored["params"]})
        return version

    # ------------------------------------------------------------------
    def start(self, backend: str = "rest", host: str = "0.0.0.0",
              port: Optional[int] = None) -> Any:
        """Launch a serving backend in-process: the REST app (run it with
        ``run_server`` or an aiohttp runner) or a started gRPC server."""
        if backend == "rest":
            from .api_server import VisionAPIServer

            return VisionAPIServer(self.engine)
        if backend == "grpc":
            from .grpc_server import RobotGRPCServer

            self.grpc_server = RobotGRPCServer(self.engine, host=host, port=port or 50051)
            self.grpc_server.start()
            return self.grpc_server
        raise ValueError(f"unknown backend: {backend!r}")

    def stop(self) -> None:
        if self.grpc_server is not None:
            self.grpc_server.stop()
            self.grpc_server = None
