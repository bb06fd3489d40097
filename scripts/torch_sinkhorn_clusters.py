"""Kernel B's time against its cluster size, on one CUDA card.

    python3 scripts/torch_sinkhorn_clusters.py [--iters 20]

For each width of the flagship's mHC matrices, at the batch one train step
launches it (2 x 32, 3 x 64, 4 x 128, 15 x 256, 1 x 512), times the forward
(history kept) and the backward launch with every cluster size that fits
(1, 2, 4, 8, 16 blocks per matrix), and checks each against the plain
version. Prints one JSON line per (width, direction, cluster size), with the
size that ``hvs_tpu_torch.ops.sinkhorn.cluster_size`` picks marked
(``chosen``), beside the card's name and power limit. Exits non-zero without
a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import SINKHORN_MIX, card_line, sinkhorn_logits, time_ms  # noqa: E402
from hvs_tpu_torch.ops import sinkhorn as sink_mod  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    card = card_line()
    k = args.iters
    for n in sorted(set(SINKHORN_MIX)):
        batch = SINKHORN_MIX.count(n)
        logits = torch.stack([sinkhorn_logits(n, seed=n + i) for i in range(batch)])
        dp = torch.stack([sinkhorn_logits(n, seed=500 + n + i) for i in range(batch)])
        x = logits.clone().requires_grad_()
        p_ref = sink_mod.sinkhorn_log_plain(x, k)
        (g_ref,) = torch.autograd.grad(p_ref, x, dp)
        for backward in (False, True):
            chosen = sink_mod.launch_plan(n, backward=backward, batch=batch)["cluster"]
            for c in sink_mod.CLUSTER_SIZES:
                try:
                    plan = sink_mod.launch_plan(n, backward=backward, cluster=c)
                except RuntimeError:
                    continue  # the slab does not fit a block
                if plan["max_active_clusters"] < 1:
                    continue
                p, hist = sink_mod.sinkhorn_forward(logits, k, keep_history=True, cluster=c)
                if backward:
                    g = sink_mod.sinkhorn_backward(logits, p, dp, hist, k, cluster=c)
                    err = float((g - g_ref).abs().max() / g_ref.abs().max())
                    ms = time_ms(lambda: sink_mod.sinkhorn_backward(logits, p, dp, hist, k,
                                                                    cluster=c))
                else:
                    err = float((p - p_ref.detach()).abs().max())
                    ms = time_ms(lambda: sink_mod.sinkhorn_forward(logits, k, keep_history=True,
                                                                   cluster=c))
                print(json.dumps({"n": n, "batch": batch,
                                  "direction": "backward" if backward else "forward",
                                  "cluster": c, "chosen": c == chosen, "ms": ms,
                                  "err": err, "smem_bytes": plan["smem_bytes"],
                                  "max_active_clusters": plan["max_active_clusters"],
                                  "card": card}), flush=True)


if __name__ == "__main__":
    main()
