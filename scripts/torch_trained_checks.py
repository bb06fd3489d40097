#!/usr/bin/env python
"""Checks of the PyTorch/CUDA port that need trained weights.

1. Bucket 4 against bucket 1, per frame: the engine (buckets 1 and 4) serves
   each group of 4 val frames through its bucket-4 graph (``infer_batch``)
   and each frame alone through its bucket-1 graph (``infer``); detections at
   or above ``--score-threshold`` are matched by class and IoU >= 0.5.
2. Kernels A and C against their plain versions at every site: the inputs
   each fused mHC layer receives in a forward of ``--batch`` letterboxed val
   images (the serve model for A, the training model in eval mode for C),
   with the trained weights and constraints; correlation and mean |diff|.
   Beside each, both against an fp64 evaluation of the same function on
   the same bf16 operands (no intermediate rounding), and the gain of the
   final LayerNorm (median over rows of 1/std of its input). Each site
   takes one gate (``gate``): where the plain version reads at or above
   ``chip_smoke.py``'s KERNEL_MIN_CORR against fp64, the kernel is held
   against the plain version at that limit; below it (a site conditioned
   in its GELUs, where bf16 cannot resolve the function at that limit), the
   kernel's corr to fp64 may be no more than GELU_FP64_MARGIN under the
   plain version's. ``--dump`` saves the two sites that agree least (inputs
   and operands) for study off the card.
3. Serve parity: the serve model's raw head outputs on one image, on the
   card (kernels) against the CPU (plain versions), and each of the two
   against a forward of the same model in fp64 on the CPU (its norms'
   statistics in fp32); each scale gated as the sites are, with
   PARITY_MIN_CORR and the CPU's corr to the fp64 forward; and on the card,
   the bf16 serve model against the fp32 one, and each at batch 4 against
   the same images one at a time (raw head outputs).

    python scripts/torch_trained_checks.py --checkpoint runs/r/checkpoints/final \\
        --data-root data/shapes640 --num-classes 8 --output checks.json

Prints one JSON object (also written to ``--output``) with the card's name
and power limit, and each site's and scale's gate on standard error; exits 1
if a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# chip_smoke.py's limits for A and C against their plain versions, and its
# serve parity limits (card against CPU).
KERNEL_MIN_CORR, KERNEL_MAX_MEAN_ABS = 0.9999, 5e-3
PARITY_MIN_CORR, PARITY_MAX_MEAN_ABS = 0.999, 0.05
# chip_smoke.py's margin for its GELU-conditioned rows: where the plain
# version itself lies under a limit against the fp64 evaluation, bf16 cannot
# tell a right kernel from a wrong one at that limit, so the kernel (or the
# card) is held no more than this below the plain version's (the CPU's)
# corr to fp64 instead.
GELU_FP64_MARGIN = 1e-3
MIN_AGREEMENT = 0.95  # share of detections that bucket 4 and bucket 1 both find


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--data-root", default="data/shapes640")
    p.add_argument("--split", default="val")
    p.add_argument("--num-classes", type=int, default=8)
    p.add_argument("--image-size", type=int, default=640)
    p.add_argument("--frames", type=int, default=64, help="val frames for the bucket check")
    p.add_argument("--batch", type=int, default=4, help="images per kernel-check forward")
    p.add_argument("--score-threshold", type=float, default=0.25)
    p.add_argument("--output", default="trained_checks.json")
    p.add_argument("--dump", default=None, help="save the two least-agreeing sites here")
    p.add_argument("--tiny", action="store_true",
                   help="the tiny model of evaluate --tiny (checks of the script)")
    p.add_argument("--use-rag", action="store_true",
                   help="the retrieval model (its knowledge base: the dataset's classes)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def iou(p, q) -> float:
    w = max(0.0, min(p[2], q[2]) - max(p[0], q[0]))
    h = max(0.0, min(p[3], q[3]) - max(p[1], q[1]))
    inter = w * h
    union = (p[2] - p[0]) * (p[3] - p[1]) + (q[2] - q[0]) * (q[3] - q[1]) - inter
    return inter / union if union > 0 else 0.0


def match(a, b, threshold: float):
    """(matched, unmatched in a, unmatched in b, largest score difference) of
    the detections at or above ``threshold``, greedily by class and IoU."""
    ka = [i for i in range(len(a)) if a.scores[i] >= threshold]
    free = [j for j in range(len(b)) if b.scores[j] >= threshold]
    matched, diff = 0, 0.0
    for i in ka:
        best, best_iou = None, 0.5
        for j in free:
            o = iou(a.boxes[i], b.boxes[j])
            if a.classes[i] == b.classes[j] and o >= best_iou:
                best, best_iou = j, o
        if best is not None:
            free.remove(best)
            matched += 1
            diff = max(diff, abs(float(a.scores[i]) - float(b.scores[best])))
    return matched, len(ka) - matched, len(free), diff


def corr_and_mean_abs(a: torch.Tensor, b: torch.Tensor):
    a, b = a.float().flatten().cpu(), b.float().flatten().cpu()
    return (float(torch.corrcoef(torch.stack([a, b]))[0, 1]), float((a - b).abs().mean()))


def site_inputs(model, images: torch.Tensor):
    """The input of every fused mHC layer in one forward, by module name."""
    from hvs_tpu_torch.models.layers import ManifoldHyperConnection

    seen, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, ManifoldHyperConnection) and m.fused:
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args, name=name: seen.__setitem__(name, args[0].detach())))
    try:
        with torch.inference_mode():
            model(images)
    finally:
        for h in hooks:
            h.remove()
    return seen


def chain64(x, w1, b1, w2, b2, h_post, h_res, ln1s, ln1b, ln2s, ln2b, h_pre=None):
    """The mHC block in fp64 on the given operands, rounding nowhere; returns
    it with the gain of its final LayerNorm (median of 1/std per row)."""
    import torch.nn.functional as F

    def ln(v, scale, bias):
        mu = v.mean(-1, keepdim=True)
        var = (v - mu).square().mean(-1, keepdim=True)
        return (v - mu) / torch.sqrt(var + 1e-6) * scale.double() + bias.double(), var

    d = lambda t: t.double()  # noqa: E731
    x = d(x)
    y, _ = ln(x, ln1s, ln1b)
    if h_pre is not None:
        y = y @ d(h_pre)
    y = F.gelu(y @ d(w1) + d(b1), approximate="tanh")
    y = F.gelu(y @ d(w2) + d(b2), approximate="tanh")
    out, var = ln(x @ d(h_res) + y @ d(h_post), ln2s, ln2b)
    return out, float(torch.median(1.0 / torch.sqrt(var + 1e-6)))


def kernel_checks(engine, train_model, images: torch.Tensor, dump=None):
    """A at the serve model's sites, C at the training model's, each beside
    the fp64 evaluation."""
    from hvs_tpu_torch.ops import mhc_block as mhc_mod
    from hvs_tpu_torch.ops.sinkhorn import sinkhorn_log

    bf = torch.bfloat16
    rows, operands = [], {}

    def row(kernel, name, m, x2d, args, got, plain, h_pre=None):
        ref, gain = chain64(x2d, *args, h_pre=h_pre)
        corr, mean_abs = corr_and_mean_abs(got, plain)
        k_corr, k_abs = corr_and_mean_abs(got, ref)
        p_corr, p_abs = corr_and_mean_abs(plain, ref)
        rows.append({"kernel": kernel, "site": name, "n": x2d.shape[0], "d": m.dim,
                     "corr": corr, "mean_abs": mean_abs, "kernel_vs_fp64_corr": k_corr,
                     "kernel_vs_fp64_mean_abs": k_abs, "plain_vs_fp64_corr": p_corr,
                     "plain_vs_fp64_mean_abs": p_abs, "ln2_gain": gain})
        operands[(kernel, name)] = {"x": x2d.cpu(), "args": [a.cpu() for a in args],
                                    "h_pre": None if h_pre is None else h_pre.cpu(),
                                    "kernel_out": got.cpu(), "plain_out": plain.cpu()}

    for name, x in site_inputs(engine.model, images).items():
        m = engine.model.get_submodule(name)
        x2d = x.to(bf).reshape(-1, m.dim).contiguous()
        args = (m.w1_folded, m.mlp_in_bias, m.mlp_out_kernel.to(bf), m.mlp_out_bias, m.h_post,
                m.h_res, m.norm_pre_scale, m.norm_pre_bias, m.norm_post_scale, m.norm_post_bias)
        with torch.inference_mode():
            row("A", name, m, x2d, args, mhc_mod.mhc_block(x2d, *args),
                mhc_mod.mhc_block_plain(x2d, *args))
    for name, x in site_inputs(train_model, images).items():
        m = train_model.get_submodule(name)
        x2d = x.to(bf).reshape(-1, m.dim).contiguous()
        with torch.inference_mode():
            h_pre = torch.sigmoid(m.H_pre_raw).to(bf)
            h_post = (2.0 * torch.sigmoid(m.H_post_raw)).to(bf)
            h_res = sinkhorn_log(m.H_res_raw, m.sk_iters, m.tau).to(bf).contiguous()
            args = (m.mlp_in_kernel.to(bf), m.mlp_in_bias, m.mlp_out_kernel.to(bf),
                    m.mlp_out_bias, h_post, h_res, m.norm_pre_scale, m.norm_pre_bias,
                    m.norm_post_scale, m.norm_post_bias)
            row("C", name, m, x2d, args, mhc_mod.mhc_block_unfolded(x2d, h_pre, *args),
                mhc_mod.mhc_block_unfolded_plain(x2d, h_pre, *args), h_pre=h_pre)
    if dump:
        worst = sorted(rows, key=lambda r: r["corr"])[:2]
        torch.save({(r["kernel"], r["site"]): operands[(r["kernel"], r["site"])]
                    for r in worst}, dump)
    return rows


def raw_outputs(model, images: torch.Tensor, one_at_a_time: bool = False):
    with torch.inference_mode():
        if not one_at_a_time:
            return model(images)["detection"]["raw"]
        parts = [model(images[i:i + 1])["detection"]["raw"] for i in range(len(images))]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def compare_raw(a: dict, b: dict) -> dict:
    return {k: dict(zip(("corr", "mean_abs"), corr_and_mean_abs(a[k], b[k]))) for k in a}


def gate(corr: float, mean_abs: float, plain_fp64_corr: float, got_fp64_corr: float,
         min_corr: float, max_mean_abs: float) -> dict:
    """The gate one reading takes. Where the plain side (the plain version,
    or the CPU) reads at or above ``min_corr`` against fp64, bf16 resolves
    the function at that limit: the kernel side is held against the plain
    side at ``min_corr`` / ``max_mean_abs`` (gate "plain"), and a miss there
    is a kernel fault. Below it, the kernel side's corr to fp64 may be no
    more than ``GELU_FP64_MARGIN`` under the plain side's (gate "fp64")."""
    if plain_fp64_corr >= min_corr:
        return {"gate": "plain", "ok": corr > min_corr and mean_abs < max_mean_abs}
    return {"gate": "fp64", "ok": got_fp64_corr >= plain_fp64_corr - GELU_FP64_MARGIN}


def gate_sites(kernels: list) -> list:
    """Each A and C site's gate (``gate``), added to its row in place."""
    for r in kernels:
        r.update(gate(r["corr"], r["mean_abs"], r["plain_vs_fp64_corr"],
                      r["kernel_vs_fp64_corr"], KERNEL_MIN_CORR, KERNEL_MAX_MEAN_ABS))
    return kernels


def gate_parity(parity: dict, parity_fp64: dict) -> dict:
    """Each scale's gate for the serve parity, card against CPU, with the
    CPU forward's corr to the fp64 forward as the plain side's."""
    return {k: {**v, **gate(v["corr"], v["mean_abs"], parity_fp64["cpu_vs_fp64"][k]["corr"],
                            parity_fp64["card_vs_fp64"][k]["corr"], PARITY_MIN_CORR,
                            PARITY_MAX_MEAN_ABS)}
            for k, v in parity.items()}


def gate_failures(kernels: list, parity_gates) -> list:
    failures = [f"{r['kernel']} at {r['site']} fails its {r['gate']} gate: {r}"
                for r in kernels if not r["ok"]]
    failures += [f"serve parity at {k} fails its {v['gate']} gate: {v}"
                 for k, v in (parity_gates or {}).items() if not v["ok"]]
    return failures


def gate_counts(kernels: list, parity_gates) -> dict:
    counts = {k: {g: sum(r["gate"] == g for r in kernels if r["kernel"] == k)
                  for g in ("plain", "fp64")} for k in ("A", "C")}
    counts["parity"] = {g: sum(v["gate"] == g for v in (parity_gates or {}).values())
                        for g in ("plain", "fp64")}
    return counts


def main(argv=None) -> dict:
    args = parse_args(argv)
    from hvs_tpu_torch.config import InferenceConfig, ModelConfig
    from hvs_tpu_torch.constants import IMAGENET_MEAN, IMAGENET_STD
    from hvs_tpu_torch.convert import nest
    from hvs_tpu_torch.data import COCODataset, letterbox_cv2, load_image
    from hvs_tpu_torch.inference import InferenceEngine
    from hvs_tpu_torch.models import compute_constraints, load_constraints

    device = args.device or "auto"
    mcfg = ModelConfig(device=device)
    mcfg.detection.num_classes = args.num_classes
    if args.use_rag:
        from hvs_tpu_torch.data.shapes import class_names_for

        mcfg.rag.enabled, mcfg.rag.class_names = True, class_names_for(args.num_classes)
    if args.tiny:
        mcfg.backbone.stage_channels = (16, 24, 32, 40)
        mcfg.backbone.stage_blocks = (1, 1, 1, 1)
        mcfg.vit.dim, mcfg.vit.depth, mcfg.vit.num_heads = 16, 1, 2
        mcfg.fusion.fpn_channels = 16
        mcfg.detection.head_channels = 16
        mcfg.mhc.sinkhorn_iterations = 5
    icfg = InferenceConfig(device=device)
    icfg.preprocessing.image_size = args.image_size
    icfg.performance.batch_buckets = (1, 4)
    icfg.checkpoint_path = args.checkpoint
    engine = InferenceEngine(mcfg, icfg)
    card = "cpu"
    if engine.device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], check=True, capture_output=True,
                              text=True, timeout=60).stdout.strip().splitlines()[0]

    dataset = COCODataset(
        root=os.path.join(args.data_root, args.split),
        annotation_file=os.path.join(args.data_root, "annotations",
                                     f"instances_{args.split}.json"),
        image_size=args.image_size, max_samples=args.frames, normalize=False)
    frames = [load_image(dataset._resolve_path(im["file_name"]))[..., ::-1].copy()
              for im in dataset.images]  # BGR, as a camera gives them

    # 1. Bucket 4 against bucket 1, frame by frame.
    totals = {"matched": 0, "only_bucket4": 0, "only_bucket1": 0, "max_score_diff": 0.0}
    scores = []
    for i in range(0, len(frames) - len(frames) % 4, 4):
        group = frames[i:i + 4]
        for a, b in zip(engine.infer_batch(group), [engine.infer(f) for f in group]):
            m, ua, ub, diff = match(a, b, args.score_threshold)
            totals["matched"] += m
            totals["only_bucket4"] += ua
            totals["only_bucket1"] += ub
            totals["max_score_diff"] = max(totals["max_score_diff"], diff)
            scores.extend(float(s) for s in a.scores if s >= args.score_threshold)
    found = totals["matched"] + max(totals["only_bucket4"], totals["only_bucket1"])
    bucket = {**totals, "frames": len(frames) - len(frames) % 4,
              "agreement": totals["matched"] / max(found, 1),
              "score_median": float(np.median(scores)) if scores else None,
              "score_p90": float(np.percentile(scores, 90)) if scores else None,
              "replays": engine.replays}

    # 2. Kernels A and C at every site, on letterboxed val images.
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    lb = np.stack([letterbox_cv2(f[..., ::-1], args.image_size)[0]
                   for f in frames[:args.batch]]).astype(np.float32) / 255.0
    images = torch.from_numpy((lb - mean) / std).to(engine.device)
    params = {k: v.detach() for k, v in engine.model.named_parameters()}
    train_model = mcfg.build_model(production=False).eval()
    with torch.no_grad():
        for name, p in train_model.named_parameters():
            p.copy_(params[name])
    kernels = kernel_checks(engine, train_model, images, args.dump)
    del train_model

    # 3. Serve parity, card against CPU, on one image, and each against fp64.
    parity = parity_fp64 = None
    if engine.device.type == "cuda":
        def cpu_serve_model(dtype=None):
            cfg = ModelConfig(**{**vars(mcfg), "device": "cpu"})
            if dtype is not None:
                cfg.dtype = lambda: dtype
            model = cfg.build_model(production=True).eval()
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(params[name].cpu())
            load_constraints(model, compute_constraints(nest(
                {k: v for k, v in model.named_parameters()}), mcfg.mhc.sinkhorn_iterations))
            return model

        cpu_model, fp64_model = cpu_serve_model(), cpu_serve_model(torch.float64)
        with torch.inference_mode():
            card_raw = engine.model(images[:1])["detection"]["raw"]
            cpu_raw = cpu_model(images[:1].cpu())["detection"]["raw"]
            fp64_raw = fp64_model(images[:1].cpu())["detection"]["raw"]
        del cpu_model, fp64_model
        parity = compare_raw(card_raw, cpu_raw)
        parity_fp64 = {"card_vs_fp64": compare_raw(card_raw, fp64_raw),
                       "cpu_vs_fp64": compare_raw(cpu_raw, fp64_raw)}
    fp32_model = ModelConfig(**{**vars(mcfg), "precision": "fp32"}).build_model(
        production=True).eval()
    with torch.no_grad():
        for name, p in fp32_model.named_parameters():
            p.copy_(params[name])
    load_constraints(fp32_model, compute_constraints(nest(
        {k: v for k, v in fp32_model.named_parameters()}), mcfg.mhc.sinkhorn_iterations))
    bf16_raw, fp32_raw = raw_outputs(engine.model, images), raw_outputs(fp32_model, images)
    precision = {
        "bf16_vs_fp32": compare_raw(bf16_raw, fp32_raw),
        "bf16_batch_vs_one_at_a_time": compare_raw(
            bf16_raw, raw_outputs(engine.model, images, one_at_a_time=True)),
        "fp32_batch_vs_one_at_a_time": compare_raw(
            fp32_raw, raw_outputs(fp32_model, images, one_at_a_time=True))}
    del fp32_model

    failures = []
    if bucket["agreement"] < MIN_AGREEMENT:
        failures.append(f"bucket 4 and bucket 1 agree on {bucket['agreement']:.4f} of detections")
    gate_sites(kernels)
    parity_gates = gate_parity(parity, parity_fp64) if parity else None
    for r in kernels:
        print(f"{r['kernel']} {r['site']}: gate {r['gate']}, corr {r['corr']:.6f}, "
              f"plain vs fp64 {r['plain_vs_fp64_corr']:.6f}, kernel vs fp64 "
              f"{r['kernel_vs_fp64_corr']:.6f}: {'ok' if r['ok'] else 'FAIL'}", file=sys.stderr)
    for k, v in (parity_gates or {}).items():
        print(f"serve parity {k}: gate {v['gate']}, corr {v['corr']:.6f}: "
              f"{'ok' if v['ok'] else 'FAIL'}", file=sys.stderr)
    failures += gate_failures(kernels, parity_gates)
    report = {"checkpoint": args.checkpoint, "card": card, "bucket4_vs_bucket1": bucket,
              "kernels": kernels, "kernel_limits": {"min_corr": KERNEL_MIN_CORR,
                                                    "max_mean_abs": KERNEL_MAX_MEAN_ABS},
              "worst_kernel_corr": {k: min((r["corr"] for r in kernels if r["kernel"] == k),
                                           default=None) for k in ("A", "C")},
              "worst_kernel_mean_abs": {k: max((r["mean_abs"] for r in kernels
                                                if r["kernel"] == k), default=None)
                                        for k in ("A", "C")},
              "sites_under_min_corr": {k: sum(r["corr"] <= KERNEL_MIN_CORR for r in kernels
                                              if r["kernel"] == k) for k in ("A", "C")},
              "gate_counts": gate_counts(kernels, parity_gates),
              "gate_limits": {"kernel_min_corr": KERNEL_MIN_CORR,
                              "parity_min_corr": PARITY_MIN_CORR,
                              "fp64_margin": GELU_FP64_MARGIN},
              "serve_parity": parity, "serve_parity_gates": parity_gates,
              "serve_parity_fp64": parity_fp64,
              "precision": precision, "failures": failures}
    with open(args.output, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    if failures:
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
