"""Model export: the weights, and the serve function as a ``torch.export``
program with its consistency check.

Counterpart of ``scripts/export_model.py`` with its flags. Formats:
``weights`` (``torch.save`` of the parameters, in place of flax msgpack),
``pt2`` (the serve program, ``torch.export.save``; in place of StableHLO)
and ``all``. The program is checked against the serve function on a seeded
batch (rtol 1e-3, atol 1e-4) unless ``--skip-check``. ``--model-config``
takes a ``ModelConfig`` YAML or JSON (its ``device`` is ignored for
``--device``), such as one with ``rag.enabled``, whose knowledge module's
mHC layer is one more ``hvs::mhc_block`` call in the program. Runs on the
card unless ``--device cpu`` is given::

    python -m hvs_tpu_torch.export_model --format all --output exports
    python -m hvs_tpu_torch.export_model --tiny --device cpu --output /tmp/export

Writes ``export_report.json`` into the output directory and prints it.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Export the detection model (PyTorch/CUDA port)")
    p.add_argument("--format", choices=["weights", "pt2", "all"], default="all")
    p.add_argument("--output", default="exports")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--image-size", type=int, default=640)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--skip-check", action="store_true")
    p.add_argument("--tiny", action="store_true", help="tiny model (smoke runs)")
    p.add_argument("--model-config", default=None, help="model YAML or JSON (ModelConfig)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def model_config(path: Optional[str], device: str):
    """The ``ModelConfig`` of ``path`` (default: the flagship's) on ``device``."""
    from .config import ModelConfig
    from .config.base import _read, from_dict

    data = _read(path) if path else {}
    data["device"] = device
    return from_dict(ModelConfig, data)


def tiny_configs(mcfg, icfg, image_size: int) -> None:
    """The reference's ``--tiny`` model, in place."""
    mcfg.backbone.stage_channels = (16, 24, 32, 40)
    mcfg.backbone.stage_blocks = (1, 1, 1, 1)
    mcfg.vit.dim, mcfg.vit.depth, mcfg.vit.num_heads = 16, 1, 2
    mcfg.fusion.fpn_channels = 16
    mcfg.detection.head_channels = 16
    mcfg.mhc.sinkhorn_iterations = 5
    icfg.preprocessing.image_size = min(image_size, 64)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = parse_args(argv)
    from .config import InferenceConfig
    from .deployment.model_server import ModelExporter
    from .inference import InferenceEngine

    device = args.device or "auto"
    mcfg = model_config(args.model_config, device)
    icfg = InferenceConfig(device=device)
    icfg.preprocessing.image_size = args.image_size
    if args.checkpoint:
        icfg.checkpoint_path = args.checkpoint
    if args.tiny:
        tiny_configs(mcfg, icfg, args.image_size)

    engine = InferenceEngine(mcfg, icfg)
    exporter = ModelExporter(engine.model, image_size=icfg.preprocessing.image_size)
    os.makedirs(args.output, exist_ok=True)
    report: Dict[str, object] = {}

    if args.format in ("weights", "all"):
        path = exporter.export_weights(os.path.join(args.output, "weights.pt"))
        report["weights"] = {"path": path, "bytes": os.path.getsize(path)}

    if args.format in ("pt2", "all"):
        path = exporter.export_program(os.path.join(args.output, "model.pt2"), batch=args.batch)
        entry = {"path": path, "bytes": os.path.getsize(path)}
        if not args.skip_check:
            entry["consistency"] = exporter.consistency_check(path, batch=args.batch)
        report["pt2"] = entry

    with open(os.path.join(args.output, "export_report.json"), "w") as f:
        json.dump(report, f, indent=2, default=str)
    print(json.dumps(report, indent=2, default=str))
    return report


if __name__ == "__main__":
    main()
