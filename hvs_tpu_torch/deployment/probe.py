"""Health probe of a serving or training container on an NVIDIA H100.

    python -m hvs_tpu_torch.deployment.probe               # the whole probe
    python -m hvs_tpu_torch.deployment.probe --card-only   # card and capability

Exits 0 and prints one JSON line ``{"status": "healthy", ...}`` only when all
of these hold, in this order; otherwise exits 1 and prints
``{"status": "unhealthy", "reason": ...}`` naming the first that failed:

1. a CUDA card is present;
2. its compute capability is (9, 0): the kernels are built for ``sm_90a``
   alone and launch on no other card;
3. every kernel library is already built for the current sources and loads
   (an image builds them with ``python -m hvs_tpu_torch.build``; the probe
   never builds one);
4. one launch of kernel A (the fused mHC block) at ``PROBE_ROWS`` x
   ``PROBE_WIDTH`` agrees with its plain version at ``chip_smoke.py``'s limits;
5. one launch of kernel B (the Sinkhorn forward) at ``PROBE_WIDTH`` agrees
   with its plain version at those limits;
6. under ``MEMORY_LIMIT`` of the card's memory is in use.

There is no CPU path and no plain-PyTorch path: a probe that cannot launch
the kernels fails. ``--card-only`` stops after 2 (the container entrypoint's
check before it starts a server or a trainer).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Optional, Sequence

# chip_smoke.py's limits: A against its plain version (KERNEL_MIN_CORR,
# KERNEL_MAX_MEAN_ABS), B's P and row sums (SINK_P_ATOL, SINK_ROW_ATOL).
KERNEL_MIN_CORR, KERNEL_MAX_MEAN_ABS = 0.9999, 5e-3
SINK_P_ATOL, SINK_ROW_ATOL = 1e-6, 1e-5
REQUIRED_CAPABILITY = (9, 0)
PROBE_ROWS, PROBE_WIDTH, SK_ITERS = 256, 64, 20
MEMORY_LIMIT = 0.98  # share of the card's memory in use that counts as exhausted


class Unhealthy(RuntimeError):
    """The reason a probe failed."""


def check_card() -> dict:
    """Checks 1 and 2; the card's name and capability."""
    import torch

    if not torch.cuda.is_available():
        raise Unhealthy("no CUDA card: torch.cuda.is_available() is false")
    capability = tuple(torch.cuda.get_device_capability(0))
    name = torch.cuda.get_device_name(0)
    if capability != REQUIRED_CAPABILITY:
        raise Unhealthy(f"compute capability {capability} of {name}: the kernels are built for "
                        f"sm_90a and need {REQUIRED_CAPABILITY} (an H100)")
    return {"card": name, "capability": list(capability)}


def check_libraries() -> dict:
    """Check 3: each library present under its current name, then loaded."""
    from .. import build

    libraries = {}
    for name in build.sources():
        path = build._library_path(name)
        if not path.exists():
            raise Unhealthy(f"kernel library {name} is not built for the current source "
                            f"(no {path}); run python -m hvs_tpu_torch.build")
        try:
            build.load(name)
        except OSError as e:
            raise Unhealthy(f"kernel library {name} does not load: {e}") from e
        libraries[name] = str(path)
    return libraries


def _corr(a, b) -> float:
    import torch

    return float(torch.corrcoef(torch.stack([a.float().flatten(), b.float().flatten()]))[0, 1])


def check_kernels() -> dict:
    """Checks 4 and 5 on seeded inputs: B projects A's H_res."""
    import torch

    from ..ops import mhc_block as mhc_mod
    from ..ops import sinkhorn as sink_mod

    gen = torch.Generator().manual_seed(0)
    dev, bf, n, d = torch.device("cuda"), torch.bfloat16, PROBE_ROWS, PROBE_WIDTH

    def randn(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(*shape, generator=gen)).to(dev)

    logits = (6.0 * torch.eye(d) + torch.randn(d, d, generator=gen)).to(dev)
    p = sink_mod.sinkhorn_log(logits, SK_ITERS)
    p_ref = sink_mod.sinkhorn_log_plain(logits, SK_ITERS)
    p_err = float((p - p_ref).abs().max())
    row_err = float((p.sum(dim=-1) - 1.0).abs().max())
    if not (math.isfinite(p_err) and p_err <= SINK_P_ATOL and row_err <= SINK_ROW_ATOL):
        raise Unhealthy(f"kernel B disagrees with its plain version: P max |diff| {p_err} "
                        f"(limit {SINK_P_ATOL}), row sum error {row_err} (limit {SINK_ROW_ATOL})")

    x = randn(n, d).to(bf)
    args = (randn(d, d, scale=d ** -0.5).to(bf), randn(d, scale=0.01),
            randn(d, d, scale=d ** -0.5).to(bf), randn(d, scale=0.01),
            (2.0 * torch.sigmoid(0.1 * torch.randn(d, d, generator=gen)) / d ** 0.5).to(dev, bf),
            p.to(bf).contiguous(), randn(d, scale=0.1, shift=1.0), randn(d, scale=0.1),
            randn(d, scale=0.1, shift=1.0), randn(d, scale=0.1))
    out = mhc_mod.mhc_block(x, *args)
    ref = mhc_mod.mhc_block_plain(x, *args)
    corr, mean_abs = _corr(out, ref), float((out.float() - ref.float()).abs().mean())
    if not (corr > KERNEL_MIN_CORR and mean_abs < KERNEL_MAX_MEAN_ABS):
        raise Unhealthy(f"kernel A disagrees with its plain version: corr {corr} (limit "
                        f"{KERNEL_MIN_CORR}), mean |diff| {mean_abs} (limit {KERNEL_MAX_MEAN_ABS})")
    return {"a_corr": corr, "a_mean_abs": mean_abs, "b_p_max_abs": p_err, "b_row_err": row_err}


def check_memory() -> dict:
    """Check 6: the card's memory in use, every process's."""
    import torch

    free, total = torch.cuda.mem_get_info(0)
    used = 1.0 - free / total
    if used > MEMORY_LIMIT:
        raise Unhealthy(f"device memory nearly exhausted: {used:.4f} of {total / 2**30:.1f} GiB "
                        f"in use (limit {MEMORY_LIMIT})")
    return {"memory_in_use": used}


def run(card_only: bool = False) -> dict:
    """The probe's checks in order; raises ``Unhealthy`` at the first that fails."""
    t0 = time.perf_counter()
    report = check_card()
    if not card_only:
        report["libraries"] = check_libraries()
        report.update(check_kernels())
        report.update(check_memory())
    report["seconds"] = time.perf_counter() - t0
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Health probe of the card and the port's kernels")
    p.add_argument("--card-only", action="store_true",
                   help="check the card and its compute capability only")
    args = p.parse_args(argv)
    try:
        report = run(args.card_only)
    except Unhealthy as e:
        reason = str(e)
    except Exception as e:  # noqa: BLE001 - any other failure is unhealthy too
        reason = f"{type(e).__name__}: {e}"
    else:
        print(json.dumps({"status": "healthy", **report}), flush=True)
        return 0
    print(json.dumps({"status": "unhealthy", "reason": reason}), flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(main())
