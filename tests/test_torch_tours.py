"""The port's runnable tours (``examples/torch_*.py``) at their tiny sizes on
the CPU, each in a subprocess, held against the JAX package.

Each tour prints its numbers as one JSON object on the last line of standard
output and the kernels' launch counters as one ``{"kernel_launches": ...}``
line on standard error. The deterministic numbers are held against the JAX
package computed here (not by running the JAX tours): the quickstart's
parameter estimate and output shapes against ``hvs_tpu.config.ModelConfig``
with the same tiny edits; nb_01's counts, class names, class histogram and
sample-0 box count against JAX's ``COCODataset`` over the directory the tour
generated; nb_02's parameters by subsystem (exact integers) and output shapes
against JAX's init and forward of the same tiny model (shapes only:
``jax.eval_shape``). Each tour's own checks: nb_03's 8 step records and its
bitwise checkpoint round trip, nb_04's burst (served + rejected = the burst),
nb_05's endpoints (200) and its export within the consistency check's rtol
1e-3 / atol 1e-4. Every floating-point number a tour reports is finite, and
each ``ds_error_max`` is at most ``DS_ERROR_MAX``. Without a card and without
``--device cpu`` each tour raises, as every entry point of the port does.

All twelve subprocesses start together on first use (one thread each), so
the file takes about as long as its slowest tour (nb_05's export).
"""

from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOURS = {
    "quickstart": ("torch_quickstart.py", ["--tiny"]),
    "nb_01": ("torch_nb_01_data_exploration.py", []),
    "nb_02": ("torch_nb_02_model_analysis.py", []),
    "nb_03": ("torch_nb_03_training_analysis.py", []),
    "nb_04": ("torch_nb_04_inference_demo.py", []),
    "nb_05": ("torch_nb_05_deployment_test.py", []),
}
TOUR_TIMEOUT_S = 240
DS_ERROR_MAX = 1e-3  # the worst doubly-stochastic error a tour may report
TINY_EDITS = {  # the tours' tiny edits of ModelConfig (the JAX tours' own)
    ("backbone", "stage_channels"): (16, 24, 32, 40), ("backbone", "stage_blocks"): (1, 1, 1, 1),
    ("vit", "dim"): 16, ("vit", "depth"): 1, ("vit", "num_heads"): 2,
    ("fusion", "fpn_channels"): 16, ("detection", "head_channels"): 16,
    ("mhc", "sinkhorn_iterations"): 5,
}
NB02_TINY = dict(num_classes=8, base_channels=8, stage_channels=(16, 24, 32, 40),
                 stage_blocks=(1, 1, 1, 1), vit_dim=16, vit_depth=1, vit_heads=2,
                 fpn_channels=16, head_channels=16, feature_dim=32, sk_iters=5)

# The child: one torch thread (the lane runs several workers), then the tour
# as a script with its own argv.
_CHILD = ("import runpy, sys, torch\n"
          "torch.set_num_threads(1)\n"
          "sys.argv = sys.argv[1:]\n"
          "runpy.run_path(sys.argv[0], run_name='__main__')\n")


def _start(script: str, args, out_dir: str) -> subprocess.Popen:
    """The tour as a child process whose output goes to ``out_dir``'s
    ``stdout`` and ``stderr`` files (a child never waits on a full pipe)."""
    env = dict(os.environ, HVS_NB_TINY="1", HVS_NB_OUT=out_dir, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO)
    with open(os.path.join(out_dir, "stdout"), "w") as so, \
            open(os.path.join(out_dir, "stderr"), "w") as se:
        return subprocess.Popen([sys.executable, "-c", _CHILD,
                                 os.path.join(REPO, "examples", script), *args],
                                cwd=out_dir, env=env, stdout=so, stderr=se)


@pytest.fixture(scope="module")
def tour_runs(tmp_path_factory):
    """Every tour started at once: on the CPU (``--device cpu``), and without
    a device flag (which must raise here, where there is no card)."""
    procs, dirs = {}, {}
    for name, (script, args) in TOURS.items():
        for key, flags in ((name, [*args, "--device", "cpu"]), (f"{name}/no_card", args)):
            dirs[key] = str(tmp_path_factory.mktemp(key.replace("/", "_")))
            procs[key] = _start(script, flags, dirs[key])

    def result(key: str):
        """(exit code, stdout, stderr) of one child, once it has ended."""
        try:
            procs[key].wait(timeout=TOUR_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            procs[key].kill()
            procs[key].wait()
            pytest.fail(f"tour {key} ran past {TOUR_TIMEOUT_S} s")
        with open(os.path.join(dirs[key], "stdout")) as so, \
                open(os.path.join(dirs[key], "stderr")) as se:
            return procs[key].returncode, so.read(), se.read()

    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _finite_numbers(value, where: str = ""):
    """Every float in a JSON value, with its path."""
    if isinstance(value, float):
        yield where, value
    elif isinstance(value, dict):
        for k, v in value.items():
            yield from _finite_numbers(v, f"{where}/{k}")
    elif isinstance(value, list):
        for i, v in enumerate(value):
            yield from _finite_numbers(v, f"{where}/{i}")


def _summary(result, name: str):
    rc, out, err = result(name)
    assert rc == 0, f"{name} exited {rc}:\n{err[-4000:]}"
    summary = json.loads(out.strip().splitlines()[-1])
    launches = [json.loads(line) for line in err.splitlines()
                if line.startswith("{") and '"kernel_launches"' in line]
    assert len(launches) == 1, err[-2000:]
    return summary, launches[0]["kernel_launches"]


def _jax_tiny_config():
    from hvs_tpu.config import ModelConfig as JaxModelConfig

    cfg = JaxModelConfig()
    for (section, field), value in TINY_EDITS.items():
        setattr(getattr(cfg, section), field, value)
    return cfg


def _check_quickstart(s):
    ref = _jax_tiny_config()
    assert s["params_estimate"] == ref.estimate_parameters()
    assert s["output_shapes"] == {k: list(v) for k, v in ref.output_shapes().items()}
    assert len(s["losses"]) == len(s["grad_norms"]) == 3
    assert s["image_size"] == 64 and os.path.exists(s["annotated"])


def _check_nb_01(s):
    from hvs_tpu.data import COCODataset as JaxCOCODataset

    root = s["root"]
    for split, ann in s["annotations"].items():
        ref = JaxCOCODataset(root=os.path.join(root, split), annotation_file=ann,
                             image_size=256)
        assert s["images"][split] == len(ref), split
    ref = JaxCOCODataset(root=os.path.join(root, "train"),
                         annotation_file=s["annotations"]["train"], image_size=256,
                         max_boxes=16)
    assert s["class_names"] == list(ref.class_names)
    assert s["class_histogram"] == {ref.class_names[c]: int(n)
                                    for c, n in sorted(ref.class_distribution().items())}
    assert s["sample0_boxes"] == int(np.asarray(ref[0]["box_mask"]).sum())
    assert s["batch_shapes"]["images"] == [4, 256, 256, 3]
    assert s["ground_truth_drawn"] == 3


def _check_nb_02(s):
    from hvs_tpu.models import HybridVisionSystem as JaxHybridVisionSystem

    model = JaxHybridVisionSystem(**NB02_TINY)
    images = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    variables = jax.eval_shape(functools.partial(model.init, task="detection"),
                               jax.random.PRNGKey(0), images)
    by_top = {top: sum(math.prod(leaf.shape) for leaf in jax.tree_util.tree_leaves(sub))
              for top, sub in variables["params"].items()}
    assert s["params_by_subsystem"] == by_top
    assert s["params_total"] == sum(by_top.values())
    out = jax.eval_shape(functools.partial(model.apply, task="detection"), variables, images)
    shapes = {f"raw/{k}": list(v.shape) for k, v in out["detection"]["raw"].items()}
    shapes["boxes"] = list(out["detection"]["boxes"].shape)
    shapes["features"] = list(out["features"].shape)
    assert s["output_shapes"] == shapes
    assert s["num_layers"] > 0 and s["ds_error_64"] <= DS_ERROR_MAX
    assert s["flops"] > 0 and s["bytes_accessed"] > 0 and s["transcendentals"] > 0


def _check_nb_03(s):
    assert s["records"] == s["steps"] == 8
    assert {"step", "loss", "grad_norm", "lr"} <= set(s["record_keys"])
    assert s["all_finite"]
    assert s["round_trip_bitwise"] is True and s["moved_by_step"] > 0
    assert s["checkpoint_step"] == 8 and s["ema_distance"] is not None


def _check_nb_04(s):
    assert s["concurrent_served"] == 2 * s["batch"] == 8
    assert s["served"] + s["rejected"] == s["burst"] == 32
    assert s["served"] > 0


def _check_nb_05(s):
    assert s["endpoints"] and all(code == 200 for code in s["endpoints"].values()), s["endpoints"]
    assert s["export"]["consistent"] is True  # rtol 1e-3, atol 1e-4
    assert s["gate"] == {"good": True, "bad": False}
    assert s["repository"] == {"v1_admitted": True, "v2_admitted": False, "latest_admitted": 1}
    assert s["health"] == "healthy"


CHECKS = {"quickstart": _check_quickstart, "nb_01": _check_nb_01, "nb_02": _check_nb_02,
          "nb_03": _check_nb_03, "nb_04": _check_nb_04, "nb_05": _check_nb_05}


@pytest.mark.parametrize("name", list(TOURS))
def test_tour_on_cpu_against_jax(tour_runs, name):
    summary, launches = _summary(tour_runs, name)
    assert summary["tour"] == name and summary["device"] == "cpu"
    # On the CPU every wrapper runs its kernel's plain version: no launches.
    assert launches == {"mhc_block": 0, "mhc_block_unfolded": 0, "sinkhorn_forward": 0,
                        "sinkhorn_backward": 0}
    for where, value in _finite_numbers(summary):
        assert math.isfinite(value), (name, where, value)
    if "ds_error_max" in summary:
        assert 0.0 <= summary["ds_error_max"] <= DS_ERROR_MAX
    CHECKS[name](summary)


@pytest.mark.parametrize("name", list(TOURS))
def test_tour_needs_a_card_unless_cpu_is_asked(tour_runs, name):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the tours run on it by default")
    rc, out, err = tour_runs(f"{name}/no_card")
    assert rc != 0
    assert "device='cpu'" in err, err[-2000:]
    assert not out.strip().endswith("}"), "a tour without a device printed a summary"
