"""Times variants of the fused mHC kernel source side by side, on one CUDA card.

    python3 scripts/torch_mhc_variants.py variants.json [--shapes-a N,D ...] [--shapes-c N,D ...]
                                          [--twice]

``variants.json`` maps a variant's name to a list of ``[old, new]`` text
replacements applied to ``hvs_tpu_torch/csrc/mhc_block.cu`` (an empty list is
the source as it is). A pair whose ``old`` is ``"ROW_TILE"`` tells the
wrapper's report of the launch the variant's row tiles, with ``new`` a JSON
object ``{"d": tile}`` (for a variant that changes ``Config<d>::BM``).
Every variant is built with the package's nvcc flags, all builds started
together, into ``.variants/<name>/`` under the working directory; the script
prints each variant's registers per kernel (and spills), then, per variant,
kernels A and C at the given (tokens, width) pairs (default: the 18 sites of
a 640² batch-16 serve forward and of a 416² batch-8 validation forward):
device ms (``chip_smoke.time_ms``), row tile, grid, and
correlation and mean |diff| against the plain version, with the ms summed
over the 18 sites, beside the card's name and power limit. ``--twice`` runs
the variants a second time in reverse order, to show the spread.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from hvs_tpu_torch import build  # noqa: E402
from hvs_tpu_torch.ops import mhc_block as mhc  # noqa: E402


def shape(text: str):
    n, d = text.split(",")
    return int(n), int(d)


def build_variants(variants: dict, root: Path) -> dict:
    """Writes and builds every variant; returns name -> library path (None if
    the build failed) and prints each kernel's registers and spills."""
    src = (build.CSRC_DIR / "mhc_block.cu").read_text()
    procs = {}
    for name, pairs in variants.items():
        text = src
        for old, new in pairs:
            if old == "ROW_TILE":
                continue
            if old not in text:
                raise SystemExit(f"variant {name}: text not in the source: {old[:80]!r}")
            text = text.replace(old, new)
        out = root / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "mhc_block.cu").write_text(text)
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out / "lib.so"),
               str(out / "mhc_block.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=open(out / "log", "w"),
                                       stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        ok = proc.wait() == 0
        log = (root / name / "log").read_text()
        kernel, regs = None, {}
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                t = re.search(r"mhc_block_kernelILi(\d+)ELb(\d)", m.group(1))
                kernel = "d{}/{}".format(t[1], "C" if t[2] == "1" else "A") if t else None
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and kernel and int(m.group(1)):
                regs[kernel + " spill bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                regs[kernel] = int(m.group(1))
        print(json.dumps({"variant": name, "built": ok, "registers": regs}), flush=True)
        if not ok:
            print(log[-3000:], file=sys.stderr)
        libs[name] = (root / name / "lib.so") if ok else None
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants")
    ap.add_argument("--shapes-a", type=shape, nargs="*", default=None)
    ap.add_argument("--shapes-c", type=shape, nargs="*", default=None)
    ap.add_argument("--twice", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    variants = json.loads(Path(args.variants).read_text())
    sites = {False: smoke.mhc_sites(smoke.SERVE_BATCH),
             True: smoke.mhc_sites(smoke.TRAIN_BATCH, smoke.TRAIN_IMAGE)}
    shapes = {False: args.shapes_a if args.shapes_a is not None else sorted(set(sites[False])),
              True: args.shapes_c if args.shapes_c is not None else sorted(set(sites[True]))}
    libs = build_variants(variants, Path(".variants"))
    card = smoke.card_line()
    tiles = dict(mhc.ROW_TILE)
    inputs = {}
    order = list(variants) + (list(variants)[::-1] if args.twice else [])
    for name in order:
        if libs[name] is None:
            continue
        build._loaded["mhc_block"] = ctypes.CDLL(str(libs[name]))
        mhc.ROW_TILE = dict(tiles)
        for old, new in variants[name]:
            if old == "ROW_TILE":
                mhc.ROW_TILE.update({int(k): int(v) for k, v in json.loads(new).items()})
        rows, totals = {}, {}
        for unfolded, kernel, plain in ((False, mhc.mhc_block, mhc.mhc_block_plain),
                                        (True, mhc.mhc_block_unfolded,
                                         mhc.mhc_block_unfolded_plain)):
            for n, d in shapes[unfolded]:
                key = (n, d, unfolded)
                if key not in inputs:
                    x, ops = smoke.mhc_inputs(n, d, seed=n + d)
                    if unfolded:
                        r = np.random.default_rng(d)
                        h_pre = torch.sigmoid(torch.from_numpy(
                            (6.0 * np.eye(d) - 3.0 + 0.5 * r.standard_normal((d, d)))
                            .astype(np.float32)))
                        ops = (h_pre.to("cuda", torch.bfloat16).contiguous(), *ops)
                    inputs[key] = (x, ops)
                x, ops = inputs[key]
                a = kernel(x, *ops).float().flatten().cpu().numpy()
                b = plain(x, *ops).float().flatten().cpu().numpy()
                plan = mhc.launch_plan(n, d)
                ms = smoke.time_ms(lambda: kernel(x, *ops))
                rows[f"{'C' if unfolded else 'A'} {n}x{d}"] = {
                    "ms": ms, "bm": plan["bm"], "grid": plan["grid"],
                    "corr": float(np.corrcoef(a, b)[0, 1]),
                    "mean_abs_err": float(np.mean(np.abs(a - b))),
                    "max_abs_err": float(np.max(np.abs(a - b)))}
            if all(s in shapes[unfolded] for s in sites[unfolded]):
                totals["C" if unfolded else "A"] = sum(
                    rows[f"{'C' if unfolded else 'A'} {n}x{d}"]["ms"] for n, d in sites[unfolded])
        print(json.dumps({"variant": name, "ms_over_18_sites": totals, "shapes": rows,
                          "card": card}), flush=True)


if __name__ == "__main__":
    main()
