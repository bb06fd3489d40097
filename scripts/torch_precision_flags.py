"""Serve and train parity on one CUDA card under two settings of torch's
process-wide matmul precision flags.

    python3 scripts/torch_precision_flags.py

Runs ``chip_smoke.phase_parity`` (the flagship served on the card against the
CPU at 320², bf16) and ``chip_smoke.phase_train_parity`` (one train step on
the card against the CPU at 320², fp32 and bf16) twice in one process:

  * ``default``: torch's own defaults (cuDNN TF32 on, reduced-precision bf16
    GEMM reductions on, cuBLAS TF32 off);
  * ``pinned``: the three flags that ``hvs_tpu_torch.device.pin_matmul_precision``
    sets (all off), as the package's entry points set them.

In ``default`` mode the pinning of the entry points these phases use
(``Detector``, ``ManifoldConstrainedTrainer``) is switched off for the run,
so the phases see torch's defaults. Each phase prints its JSON line (with
the card's name and power limit): a serve parity that misses its limits
prints ``{"failed": true}`` instead of ending the run, and each train row
says ``within_limits``. Exits non-zero without a card.
"""

from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        raise SystemExit(1)
    import chip_smoke as c
    from hvs_tpu_torch import build
    from hvs_tpu_torch.inference import serve
    from hvs_tpu_torch.training import trainer

    entry_modules = (serve, trainer)
    pin = serve.pin_matmul_precision
    defaults = c.read_flags()
    card = c.card_line()
    build.build(["mhc_block", "sinkhorn"])
    for mode in ("default", "pinned"):
        if mode == "default":
            c.set_flags(defaults)
            for module in entry_modules:
                module.pin_matmul_precision = lambda: None
        else:
            c.set_flags({path: False for path in c.PRECISION_FLAGS})
            for module in entry_modules:
                module.pin_matmul_precision = pin
        print(json.dumps({"phase": "flags", "mode": mode, **c.read_flags(), "card": card}),
              flush=True)
        try:
            c.phase_parity(card)
        except SystemExit:
            print(json.dumps({"phase": "parity", "mode": mode, "failed": True}), flush=True)
        for dtype in (torch.float32, torch.bfloat16):
            row = c.train_step_pair(dtype)
            row.update(mode=mode, within_limits=c.train_parity_within_limits(row), card=card)
            print(json.dumps(row), flush=True)
    print(card)


if __name__ == "__main__":
    main()
