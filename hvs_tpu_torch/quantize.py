"""Int8 post-training quantization: calibrate, score float against int8, time
the replays.

Counterpart of ``scripts/quantize.py``, with its flags and report, plus
``--device``: the float serve model is calibrated at the largest resolution
on the first ``--calib-images`` images of a COCO-format val split (letterboxed
and normalized as the serve path does, batches of ``--calib-batch``), the
scales are written to ``--scales-out`` (``torch.save`` of ``{site: fp32
scalar}``, the engine's ``quantization.scales_path``), then at each
resolution the float engine and each int8 variant (``int8``; with
``--eval-fpn``, ``--eval-mhc``, ``--eval-vit`` also ``int8_fpn``,
``int8_mhc``, ``int8_vit``, and ``int8_all`` or ``int8_fpn_mhc``) are scored
with ``DetectionEvaluator`` and timed: ``batch_ms`` is one replay of the
engine's captured ``--bench-batch`` bucket on the card (CUDA events; on the
CPU one eager call). The report (``--output``) has the script's keys plus
``card``. Runs on the CUDA card unless ``--device cpu`` is given:

    python -m hvs_tpu_torch.quantize --checkpoint runs/run/checkpoints/final \\
        --data-root data/shapes640 --eval-fpn --eval-mhc --eval-vit
    python -m hvs_tpu_torch.quantize --random-init --tiny --device cpu \\
        --data-root <root> --resolutions 64
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

SCHEME = ("symmetric W8A8 PTQ: per-tensor activation scales (max-abs calibrated), "
          "per-output-channel weight scales, int8 x int8 products into int32 "
          "(torch._int_mm on the card); the backbone's convolutions and the head towers "
          "int8, with the variants' FPN, backbone mHC chains and ViT "
          "(hvs_tpu_torch/ops/quant.py)")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Int8 PTQ of the serve model (PyTorch/CUDA port)")
    p.add_argument("--checkpoint", default=None,
                   help="a checkpoint of the port's trainer (<path> or <path>.pt)")
    p.add_argument("--tiny", action="store_true",
                   help="flow-validation mode: tiny model (CPU-sized)")
    p.add_argument("--random-init", action="store_true",
                   help="skip checkpoint loading (flow validation only)")
    p.add_argument("--data-root", default="data/shapes640")
    p.add_argument("--num-classes", type=int, default=8)
    p.add_argument("--resolutions", default="416,640")
    p.add_argument("--calib-images", type=int, default=64)
    p.add_argument("--calib-batch", type=int, default=8)
    p.add_argument("--margin", type=float, default=1.0)
    p.add_argument("--calib-percentile", type=float, default=100.0,
                   help="percentile of per-batch max-abs (100 = exact max)")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--bench-batch", type=int, default=16)
    p.add_argument("--no-ema", action="store_true")
    p.add_argument("--eval-fpn", action="store_true",
                   help="also evaluate the int8+FPN variant (quantize_fpn)")
    p.add_argument("--eval-mhc", action="store_true",
                   help="also evaluate the int8+mHC-chain variant (quantize_mhc)")
    p.add_argument("--eval-vit", action="store_true",
                   help="also evaluate the int8+ViT variant (quantize_vit)")
    p.add_argument("--scales-out", default="runs/quant_scales.pt")
    p.add_argument("--output", default="quant_results.json")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if not args.checkpoint and not args.random_init:
        p.error("--checkpoint is required (or pass --random-init for flow validation)")
    return args


def variants(args: argparse.Namespace) -> List[tuple]:
    """(label, quantize_fpn, quantize_mhc, quantize_vit) of each int8 variant
    the flags ask for, in the script's order."""
    out = [("int8", False, False, False)]
    if args.eval_fpn:
        out.append(("int8_fpn", True, False, False))
    if args.eval_mhc:
        out.append(("int8_mhc", False, True, False))
    if args.eval_vit:
        out.append(("int8_vit", False, False, True))
    if args.eval_fpn and args.eval_mhc and args.eval_vit:
        out.append(("int8_all", True, True, True))
    elif args.eval_fpn and args.eval_mhc:
        out.append(("int8_fpn_mhc", True, True, False))
    return out


def make_engine(args: argparse.Namespace, resolution: int, quantized: bool, fpn: bool = False,
                mhc: bool = False, vit: bool = False):
    from .config import InferenceConfig, ModelConfig
    from .inference import InferenceEngine

    device = args.device or "auto"
    mcfg = ModelConfig(device=device)
    mcfg.detection.num_classes = args.num_classes
    if args.tiny:
        # Flow-validation mode: calibrate -> sidecar -> int8 engine -> eval -> timing.
        mcfg.backbone.stage_channels = (16, 24, 32, 40)
        mcfg.backbone.stage_blocks = (1, 1, 1, 1)
        mcfg.vit.dim = 16
        mcfg.vit.depth = 1
        mcfg.vit.num_heads = 2
        mcfg.fusion.fpn_channels = 16
        mcfg.detection.head_channels = 16
        mcfg.mhc.sinkhorn_iterations = 5
    if quantized:
        q = mcfg.quantization
        q.enabled, q.scales_path = True, args.scales_out
        q.quantize_fpn, q.quantize_mhc, q.quantize_vit = fpn, mhc, vit
    icfg = InferenceConfig(device=device)
    icfg.preprocessing.image_size = resolution
    icfg.postprocessing.score_threshold = 0.05
    icfg.checkpoint_path = None if args.random_init else args.checkpoint
    icfg.use_ema = not args.no_ema
    return InferenceEngine(mcfg, icfg)


def load_val_images(args: argparse.Namespace, limit: Optional[int] = None):
    """The val split's class names, RGB images and ground truth (xyxy pixels)."""
    from .data import COCODataset, load_image
    from .evaluate import ground_truth

    dataset = COCODataset(
        root=os.path.join(args.data_root, "val"),
        annotation_file=os.path.join(args.data_root, "annotations", "instances_val.json"),
        image_size=max(int(r) for r in args.resolutions.split(",")), max_samples=limit,
        normalize=False)
    images = [load_image(dataset._resolve_path(info["file_name"])) for info in dataset.images]
    gts = [ground_truth(dataset, i) for i in range(len(dataset))]
    return dataset.class_names, images, gts


def calibrate(args: argparse.Namespace, engine, images, resolution: int):
    """Scales from the float engine's model on letterboxed, normalized
    batches (the serve path's normalization); returns (scales, seconds,
    batches)."""
    from .constants import IMAGENET_MEAN, IMAGENET_STD
    from .data import letterbox_cv2
    from .models.quantize import calibrate_quant_scales

    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    batches = []
    bs = args.calib_batch
    sel = images[: args.calib_images]
    for i in range(0, len(sel), bs):
        chunk = sel[i: i + bs]
        if len(chunk) < bs:
            break
        lb = np.stack([letterbox_cv2(im, resolution)[0] for im in chunk])
        x = lb.astype(np.float32) / 255.0
        if engine.config.preprocessing.normalize:
            x = (x - mean) / std
        batches.append(torch.from_numpy(x).to(engine.device))
    t0 = time.perf_counter()
    scales = calibrate_quant_scales(engine.model, batches, margin=args.margin,
                                    percentile=args.calib_percentile)
    return scales, time.perf_counter() - t0, len(batches)


def evaluate(engine, class_names, images, gts) -> Dict[str, float]:
    from .utils import DetectionEvaluator

    evaluator = DetectionEvaluator(num_classes=len(class_names))
    t0 = time.perf_counter()
    for img, (gt_boxes, gt_cls) in zip(images, gts):
        det = engine.infer(img[..., ::-1])  # the engine takes BGR frames
        evaluator.add_image(det.boxes, det.scores, det.classes, gt_boxes, gt_cls)
    acc = evaluator.evaluate()
    out = {k: round(v, 4) for k, v in acc.items() if not isinstance(v, dict)}
    out["eval_seconds"] = round(time.perf_counter() - t0, 1)
    return out


def measure_fps(engine, resolution: int, batch: int, iters: int = 30) -> Dict[str, float]:
    """ms per call of the engine's ``batch`` bucket on seeded random frames:
    on the card, replays of its captured graph between CUDA events on the
    engine's stream; on the CPU, eager calls on the host clock."""
    entry = engine._serve_fn(batch)
    frames = np.random.default_rng(0).integers(0, 255, (batch, resolution, resolution, 3),
                                               np.uint8)
    entry.static_in.copy_(torch.from_numpy(frames))
    if entry.graph is None:
        entry.serve_eager(entry.static_in)
        t0 = time.perf_counter()
        for _ in range(iters):
            entry.serve_eager(entry.static_in)
        dt_ms = (time.perf_counter() - t0) / iters * 1e3
    else:
        with torch.cuda.stream(engine._stream):
            entry.graph.replay()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            for _ in range(iters):
                entry.graph.replay()
            end.record()
        end.synchronize()
        dt_ms = start.elapsed_time(end) / iters
    return {"batch_ms": round(dt_ms, 3), "fps": round(batch / dt_ms * 1e3, 1)}


def card_name(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def _release() -> None:
    """Free the card memory (graph pools) of engines no longer referenced."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    resolutions = [int(r) for r in args.resolutions.split(",")]
    calib_res = max(resolutions)
    float_engine = make_engine(args, calib_res, quantized=False)
    report: Dict[str, Any] = {"checkpoint": args.checkpoint, "scheme": SCHEME,
                              "card": card_name(float_engine.device), "resolutions": {}}

    # Calibrate once at the largest resolution (per-tensor ranges).
    class_names, images, gts = load_val_images(args, args.max_images)
    scales, calib_s, n_batches = calibrate(args, float_engine, images, calib_res)
    os.makedirs(os.path.dirname(args.scales_out) or ".", exist_ok=True)
    torch.save(scales, args.scales_out)
    report["calibration"] = {"images": n_batches * args.calib_batch, "seconds": round(calib_s, 3),
                             "resolution": calib_res, "scales_file": args.scales_out,
                             "margin": args.margin, "sites": len(scales)}
    print(f"calibrated {n_batches * args.calib_batch} imgs in {calib_s:.1f}s "
          f"-> {args.scales_out}", flush=True)

    for res in resolutions:
        fe = float_engine if res == calib_res else make_engine(args, res, quantized=False)
        acc_f = evaluate(fe, class_names, images, gts)
        fps_f = measure_fps(fe, res, args.bench_batch)
        entry = {"float": {**acc_f, **fps_f}}
        del fe
        _release()
        for label, fpn, mhc, vit in variants(args):
            qe = make_engine(args, res, quantized=True, fpn=fpn, mhc=mhc, vit=vit)
            acc_q = evaluate(qe, class_names, images, gts)
            fps_q = measure_fps(qe, res, args.bench_batch)
            del qe
            _release()
            entry[label] = {
                **acc_q, **fps_q,
                "mAP@0.5_delta": round((acc_q.get("mAP@0.5") or 0)
                                       - (acc_f.get("mAP@0.5") or 0), 4),
                "speedup": round(fps_q["fps"] / max(fps_f["fps"], 1e-6), 3),
            }
            print(f"@{res} {label}: mAP={acc_q.get('mAP@0.5')} (float {acc_f.get('mAP@0.5')}) "
                  f"{fps_q['fps']} FPS ({entry[label]['speedup']}x vs {fps_f['fps']})",
                  flush=True)
        report["resolutions"][str(res)] = entry
        if res == calib_res:
            float_engine = None
        _release()

    with open(args.output, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.output}")
    return report


if __name__ == "__main__":
    main()
