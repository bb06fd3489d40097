"""Ceiling of what fusing the backbone's norm, SE and residual glue can save,
on the card.

Counterpart of ``scripts/gn_fusion_ceiling.py``. The flagship's backbone
(20 Sinkhorn iterations, serve constraints, eval mode: the folded serve
tail) at batch 16, 640², in two forms, each captured as one CUDA graph and
timed by replay (``utils/perf.py``), with its bytes counted
(``ModelProfiler.cost_analysis``):

  * ``full``;
  * ``no_gn_se``: ``use_se=False`` and every ``GroupNorm`` module replaced by
    ``nn.Identity`` after construction (``utils/perf.py::identity_norms``).
    The folded tail then reads each identity as s = 1, t = 0 and computes
    no statistics, so the ablated backbone computes what JAX's patched one
    computes.

``delta_ms`` bounds what any fusion of that glue can save in time,
``delta_bytes_frac`` in counted bytes. The JAX script patches the module
function ``group_norm`` with a lambda, which has no
``affine_from_channel_stats``: its folded tail cannot run so, and the JAX
backbone computes the ablation through its standard tail
(``HVS_FUSE_NORMS=0``), which equals the fold's.

Keys as the JAX script's, ``xla_bytes`` renamed ``bytes_accessed`` (the
table in ``utils/perf.py``). Runs on the card unless ``--device cpu``;
raises without one::

    python -m hvs_tpu_torch.gn_fusion_ceiling
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Sequence, Tuple

import torch

from .utils import perf


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Backbone norm-fusion ceiling (PyTorch/CUDA port)")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--image-size", type=int, default=640)
    p.add_argument("--iters", type=int, default=30, help="timed calls per variant")
    p.add_argument("--output", default=f"{perf.OUTPUT_DIR}/gn_fusion_ceiling.json")
    perf.add_args(p)
    return p.parse_args(argv)


def backbone(device: torch.device, tiny: bool, ablated: bool, seed: int = 0,
             dtype: torch.dtype = torch.bfloat16):
    """The flagship's backbone for serving (constraints installed: kernel B
    once per matrix), ``ablated``: no SE and every GroupNorm the identity."""
    from .models.backbone import HybridVisionBackbone
    from .models.constraints import compute_constraints, load_constraints, param_tree
    from .models.layers import init_weights

    kw = perf.model_kwargs(tiny)
    widths = {k: kw[k] for k in ("stage_channels", "stage_blocks") if k in kw}
    model = HybridVisionBackbone(**widths, sk_iters=kw["sk_iters"], dtype=dtype,
                                 precomputed_constraints=True, use_se=not ablated)
    init_weights(model, seed)
    model = model.to(device).eval()
    if ablated:
        perf.identity_norms(model)
    load_constraints(model, compute_constraints(param_tree(model), kw["sk_iters"]))
    return model


def run(args: argparse.Namespace) -> Tuple[Dict, Dict[str, int]]:
    from .device import resolve_device

    device = resolve_device(args.device)
    pk = perf.peaks(args, device)
    launches = perf.Launches()
    b, s = args.batch, args.image_size
    x = torch.rand((b, s, s, 3), generator=torch.Generator(device=device).manual_seed(0),
                   device=device)
    results = {}
    for variant in ("full", "no_gn_se"):
        model = backbone(device, args.tiny, variant == "no_gn_se")
        with torch.inference_mode():
            counted = perf.cost(lambda: model(x))
            prog = perf.Program(lambda: model(x), device)
            ms = prog.seconds(args.iters) * 1e3
        launches.add(prog)
        results[variant] = {"ms_per_batch": ms, "bytes_accessed": counted["bytes accessed"],
                            "flops": counted["flops"]}
        print(variant, results[variant], flush=True)
        del prog, model
    full, abl = results["full"], results["no_gn_se"]
    report = {
        "batch": b,
        "image_size": s,
        "peaks": pk,
        "full": full,
        "no_gn_se": abl,
        "delta_ms": full["ms_per_batch"] - abl["ms_per_batch"],
        "delta_bytes_frac": 1 - abl["bytes_accessed"] / full["bytes_accessed"],
        "note": ("delta = upper bound on what fused GroupNorm/SE/residual kernels can "
                 "reclaim from the backbone on this card"),
    }
    print(json.dumps({k: v for k, v in report.items() if k != "peaks"}))
    return report, launches.total()


def main(argv: Optional[Sequence[str]] = None) -> Tuple[Dict, Dict[str, int]]:
    args = parse_args(argv)
    report, launches = run(args)
    perf.write(report, args.output)
    print(json.dumps({"kernel_launches": launches}), file=sys.stderr, flush=True)
    return report, launches


if __name__ == "__main__":
    main()
