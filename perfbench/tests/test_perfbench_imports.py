"""What the benchmark loads, each in a fresh process: a cut run on the CPU
loads no module of the JAX stack or of the JAX package (top-level names
compared whole, so ``hvs_tpu_torch`` passes), and the plain reference, the
count, the judge and the serve cells' check load nothing of the program."""

import subprocess
import sys
import textwrap

from conftest import ROOT

BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "hvs_tpu")


def _fresh(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, timeout=600, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_a_run_loads_nothing_of_jax_or_the_jax_package():
    out = _fresh(f"""
        import json, sys
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / "perfbench")!r},
                        {str(ROOT / "perfbench" / "tests")!r}]
        import torch
        import run
        from conftest import tiny_config
        cfg = tiny_config()
        cfg["predict_bias"] = {{"objectness": 1.0, "class": 0.0}}
        mix = {{"generator": "closed_batches", "frame_h": 48, "frame_w": 80, "image_size": 64,
               "batch": 2, "pool": 4, "sample": 2, "check": "detections",
               "limits": {{"logit_gap": 0.55}}, "floors": {{"frames": 1}}}}
        bench = json.load(open(run.ROOT / "BENCHMARK.json"))
        cell = {{"name": "tiny", "config": "tiny", "traffic": "tiny", "chips": 1}}
        line, _ = run.execute(bench, cell, 5, 0.3, 0, torch.device("cpu"), cfg=cfg, traffic=mix)
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
    """)
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert "hvs_tpu_torch" in loaded
    assert not loaded & set(BANNED), loaded & set(BANNED)


def test_the_reference_count_and_judge_load_nothing_of_the_program():
    out = _fresh(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        import perfbench.reference.hybrid, perfbench.count.flops, perfbench.count.bounds
        import perfbench.harness.judge, perfbench.harness.weights, perfbench.harness.frames
        sys.path.insert(0, {str(ROOT / "perfbench")!r})
        import run
        run.load_file(run.BENCH / "checks" / "detections.py")
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
    """)
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert not loaded & {"hvs_tpu_torch", *BANNED}
