#!/usr/bin/env python
"""Runnable end-to-end tour of the PyTorch/CUDA port (``hvs_tpu_torch``), the
counterpart of ``examples/quickstart.py``: configs, the serving engine, the
visualizer and three training steps, with no dataset and no camera.

    python examples/torch_quickstart.py                      # the flagship on the CUDA card
    python examples/torch_quickstart.py --device cpu --tiny  # tiny widths on the CPU

Without a CUDA card it raises unless ``--device cpu`` is given. Files go to
``$HVS_NB_OUT`` (default ``outputs/torch_quickstart``). The last line of
standard output is one JSON object with the tour's numbers; the kernels'
launch counters go to standard error as one ``{"kernel_launches": ...}`` line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu; without a card, pass cpu")
    args = parser.parse_args()

    from hvs_tpu_torch import resolve_device
    from hvs_tpu_torch.config import InferenceConfig, ModelConfig, TrainingConfig
    from hvs_tpu_torch.inference import DetectionVisualizer, InferenceEngine
    from hvs_tpu_torch.models import HybridVisionSystem
    from hvs_tpu_torch.training import ManifoldConstrainedTrainer
    from hvs_tpu_torch.training.chunk import kernel_counts

    device = resolve_device(args.device)
    out_dir = os.environ.get("HVS_NB_OUT", "outputs/torch_quickstart")
    os.makedirs(out_dir, exist_ok=True)
    print(f"device: {device}\n")

    # ------------------------------------------------------------------
    print("== 1. configs ==")
    mcfg = ModelConfig(device=device.type)
    icfg = InferenceConfig(device=device.type)
    icfg.preprocessing.image_size = 640  # the serve path's size (the config's default is 416)
    if args.tiny:
        mcfg.backbone.stage_channels = (16, 24, 32, 40)
        mcfg.backbone.stage_blocks = (1, 1, 1, 1)
        mcfg.vit.dim = 16
        mcfg.vit.depth = 1
        mcfg.vit.num_heads = 2
        mcfg.fusion.fpn_channels = 16
        mcfg.detection.head_channels = 16
        mcfg.mhc.sinkhorn_iterations = 5
        icfg.preprocessing.image_size = 64
        icfg.performance.batch_buckets = (1, 2)
        icfg.postprocessing.score_threshold = 0.01
    params_estimate = mcfg.estimate_parameters()
    output_shapes = mcfg.output_shapes()
    print(f"estimated params: {params_estimate / 1e6:.1f}M")
    print(f"output shapes: {output_shapes}\n")

    # ------------------------------------------------------------------
    print("== 2. inference engine (model init + warmup) ==")
    engine = InferenceEngine(mcfg, icfg)
    engine.warmup()
    rng = np.random.default_rng(0)
    image = rng.integers(0, 255, (480, 640, 3), np.uint8)
    det = engine.infer(image)
    stability = engine.get_stability_report()
    print(f"detections: {len(det)}  latency: {det.latency_ms:.1f} ms")
    print(f"stability report: {stability}\n")

    # ------------------------------------------------------------------
    print("== 3. visualize ==")
    vis = DetectionVisualizer(class_names=engine.class_names)
    annotated = vis.draw_detections(image, det.boxes, det.scores, det.classes)
    out_path = os.path.join(out_dir, "annotated.jpg")
    import cv2

    if not cv2.imwrite(out_path, annotated):
        raise RuntimeError(f"could not write {out_path}")
    print(f"annotated image: {out_path}\n")

    # ------------------------------------------------------------------
    print("== 4. three training steps (synthetic data) ==")
    tiny_model = HybridVisionSystem(
        num_classes=4, base_channels=8, stage_channels=(16, 24, 32, 40),
        stage_blocks=(1, 1, 1, 1), vit_dim=16, vit_depth=1, vit_heads=2,
        fpn_channels=16, head_channels=16, feature_dim=32, sk_iters=5, device=device,
    )
    tcfg = TrainingConfig(device=device.type)
    trainer = ManifoldConstrainedTrainer(tiny_model, tcfg.trainer_config(4), device=device)

    def batch(seed):
        r = np.random.default_rng(seed)
        return {
            "images": r.standard_normal((1, 64, 64, 3)).astype(np.float32),
            "boxes": np.clip(r.uniform(0.2, 0.8, (1, 8, 4)), 0.05, 0.95).astype(np.float32),
            "labels": r.integers(0, 4, (1, 8)).astype(np.int32),
            "box_mask": np.ones((1, 8), np.float32),
        }

    trainer.init_state(batch(0))
    losses, grad_norms = [], []
    for i in range(3):
        metrics = trainer.train_step(batch(i))
        losses.append(float(metrics["loss"]))
        grad_norms.append(float(metrics["grad_norm"]))
        print(f"  step {i}: loss={losses[-1]:.3f} grad_norm={grad_norms[-1]:.2f}")
    print("\n== done ==")

    print(json.dumps({"kernel_launches": kernel_counts()}), file=sys.stderr, flush=True)
    print(json.dumps({
        "tour": "quickstart", "device": str(device),
        "params_estimate": params_estimate, "output_shapes": output_shapes,
        "image_size": engine.image_size, "detections": len(det),
        "latency_ms": float(det.latency_ms), "ds_error_max": stability["max_ds_error"],
        "annotated": out_path, "losses": losses, "grad_norms": grad_norms,
    }), flush=True)


if __name__ == "__main__":
    main()
