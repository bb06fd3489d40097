"""The readings a cell's limits are set from: for each seed, one run of the
cell (a short window at its own load) with its numbers and the control's
numbers on the same served frames, one JSON line each, in one process.

    python3 perfbench/tools/readings.py --workload <cell> --seeds 11,12,... --seconds 3
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[2]), str(Path(__file__).resolve().parents[1])]

import run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    ap.add_argument("--set", action="append", default=[],
                    help="traffic field=value override (a sweep point)")
    args = ap.parse_args()
    run._set_environment()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = {c["name"]: c for c in bench["workloads"]}[args.workload]
    traffic = json.loads((run.BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    for kv in args.set:
        k, v = kv.split("=", 1)
        traffic[k] = json.loads(v)
    for seed in [int(s) for s in args.seeds.split(",")]:
        line, _ = run.execute(bench, cell, seed, args.seconds, 0, torch.device("cuda", 0),
                              traffic=traffic, control=True)
        line.pop("device")
        out = {"cell": args.workload, "seed": seed, "traffic": traffic, **line}
        text = json.dumps(out)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
