"""The port's roofline tools on the CPU against the JAX package's scripts:
``python -m hvs_tpu_torch.roofline`` against ``scripts/roofline.py``,
``bytes_attribution``, ``train_roofline``, ``gn_fusion_ceiling``,
``head_fusion_ceiling`` against their scripts, and ``cls_loss_ab``'s probe
against the script's ``make_probe``.

The JAX scripts run in-process with ``sys.argv`` patched, their model
patched to the tiny one in fp32 (no Pallas) and their timing loops cut to
one call; the port's tools run on the CPU with ``--tiny`` and explicit
peaks. Reports are held key for key under the rename table of
``hvs_tpu_torch/utils/perf.py``; stage outputs and both ablated forwards
against JAX's patched ones on the same converted weights, at rtol 2e-3 /
atol 5e-3. ``scripts/cls_loss_ab.py`` trains at import, so its
``make_probe`` is taken from its source.
"""

import ast
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hvs_tpu.models as jax_models
from hvs_tpu.models import ProductionHybridVision as JaxProduction
from hvs_tpu.models import backbone as jbb
from hvs_tpu.models import layers as jly
from hvs_tpu.models import yolo_head as jyh
from hvs_tpu.models.constraints import compute_constraints as jax_constraints
from hvs_tpu.models.hybrid import HybridVisionSystem as JaxSystem
from hvs_tpu_torch import (bytes_attribution, cls_loss_ab, gn_fusion_ceiling,
                           head_fusion_ceiling, make_shapes_dataset, roofline, train_roofline)
from hvs_tpu_torch.convert import load_flax_params
from hvs_tpu_torch.inference import Detector
from hvs_tpu_torch.models import HybridVisionSystem, ProductionHybridVision
from hvs_tpu_torch.models.constraints import compute_constraints, load_constraints, param_tree
from hvs_tpu_torch.utils import perf
from tests.test_torch_bench_tools import _keep_compile_cache, _last_json, _load

torch.set_num_threads(1)

RTOL, ATOL = 2e-3, 5e-3
TINY = perf.TINY
SIZE, BATCH = 64, 2
PEAKS = ["--peak-tflops-bf16", "1", "--peak-hbm-gbps", "50"]
PORT = ["--device", "cpu", "--tiny", *PEAKS]
# perf.py's table: the JAX scripts' keys that name XLA or the MXU.
RENAME = {"mxu_utilization": "mfu", "xla_flops_per_batch": "flops_per_batch",
          "xla_bytes_accessed_per_batch": "bytes_accessed_per_batch",
          "xla_bytes": "bytes_accessed"}
BOUNDS = {"compute (MXU)": perf.COMPUTE_BOUND, "MXU": perf.COMPUTE_BOUND,
          "HBM bandwidth": perf.HBM_BOUND, "HBM": perf.HBM_BOUND}


def _paths(tree, prefix=()):
    """Every key path of a JSON object, the JAX names renamed."""
    out = set()
    for k, v in tree.items():
        path = prefix + (RENAME.get(k, k),)
        out.add(path)
        if isinstance(v, dict):
            out |= _paths(v, path)
    return out


def _same_keys(jax_report, port_report, extra):
    """The port's report has the JAX script's key paths (renamed) and, beside
    them, exactly the paths ending in one of ``extra``."""
    want, got = (_paths(json.loads(json.dumps(r))) for r in (jax_report, port_report))
    assert want <= got, sorted(want - got)
    assert all(p[-1] in extra or any(p[:i + 1][-1] in extra for i in range(len(p)))
               for p in got - want), sorted(got - want)


def _tiny_production(**kw):
    """The JAX flagship at the tiny widths in fp32, without Pallas."""
    return JaxProduction(**{**kw, **TINY, "dtype": jnp.float32, "use_pallas": False})


def _one_call(module, name):
    """A script's timing function cut to one timed call."""
    orig = getattr(module, name)
    setattr(module, name, lambda fn, x, iters=1: orig(fn, x, iters=1))


def _images(batch=BATCH, size=SIZE):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (batch, size, size, 3),
                                         jnp.float32))


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


def _port_flagship(params, production=True, **kw):
    cls = ProductionHybridVision if production else HybridVisionSystem
    model = cls(**TINY, dtype=torch.float32, device="cpu", **kw)
    load_flax_params(model, params)
    return model


def test_roofline_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(jax_models, "ProductionHybridVision", _tiny_production)
    _keep_compile_cache(monkeypatch)
    script = _load("scripts/roofline.py", "_jax_roofline")
    _one_call(script, "measure")
    monkeypatch.setattr(sys, "argv", ["roofline.py", "--image-size", str(SIZE), "--buckets",
                                      "1,2", "--output", str(tmp_path / "jax.json")])
    assert script.main() == 0
    want = json.loads((tmp_path / "jax.json").read_text())
    got, launches = roofline.main([*PORT, "--image-size", str(SIZE), "--buckets", "1,2",
                                   "--iters", "1", "--output", str(tmp_path / "port.json")])
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(json.dumps(got))
    _same_keys(want, got, {"transcendentals_per_batch", "card", "power_limit"})
    for b, row in got["buckets"].items():
        assert row["bound"] in BOUNDS.values()
        assert want["buckets"][str(b)]["bound"] in BOUNDS
        assert row["mfu"] == row["flops_per_batch"] / (row["batch_ms"] / 1e3) / 1e12
        assert row["flops_per_batch"] > 0 and row["bytes_accessed_per_batch"] > 0
    assert got["peaks"]["card"] == "cpu" and set(launches) == {
        "mhc_block", "mhc_block_unfolded", "sinkhorn_forward", "sinkhorn_backward"}


def test_bytes_attribution_stages_match_the_jax_script(tmp_path, monkeypatch, capsys):
    """The port's stages on the JAX script's weights and images give its
    stage outputs; the report has its keys (and the port's ``features``
    stage, which XLA drops from the serve program)."""
    import hvs_tpu.models.vit as jvit

    monkeypatch.setattr(jax_models, "ProductionHybridVision", _tiny_production)
    # The script builds the encoder without its input width (flagship only).
    encoder = jvit.HybridVisionEncoder
    monkeypatch.setattr(jvit, "HybridVisionEncoder", lambda **kw: encoder(
        **kw, cnn_channels=TINY["stage_channels"][-1]))
    _keep_compile_cache(monkeypatch)
    script = _load("scripts/bytes_attribution.py", "_jax_bytes")
    outputs = []
    orig = script.measure

    def measure(fn, args_, iters=1):
        outputs.append(jax.tree_util.tree_map(np.asarray, fn(*args_)))
        return orig(fn, args_, iters=1)

    script.measure = measure
    monkeypatch.setattr(sys, "argv", ["bytes_attribution.py", "--batch", str(BATCH),
                                      "--image-size", str(SIZE), "--output",
                                      str(tmp_path / "jax.json")])
    assert script.main() == 0
    want = json.loads((tmp_path / "jax.json").read_text())

    model = _tiny_production(sk_iters=20)
    params = jax.device_get(jax.jit(functools.partial(model.init, task="detection"))(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))["params"])
    det = Detector(_port_flagship(params, sk_iters=20), device="cpu")
    x = torch.from_numpy(_images())
    stages = bytes_attribution.stages(det.model)
    with torch.inference_mode():
        scales = stages["backbone"](x)
        for k in scales:
            _close(scales[k], outputs[0][k], k)
        blended = stages["vit_encoder"](scales)
        _close(blended["scale_large"],
               0.5 * outputs[0]["scale_large"] + 0.5 * outputs[1], "blend")
        fused = stages["fpn"](blended)
        for k in fused:
            _close(fused[k], outputs[2][k], k)
        head = stages["features"](stages["detection_head"](fused))
        for k in ("boxes", "scores", "class_scores"):
            _close(head[k], outputs[3][k], k)
        post = stages["decode_nms"](head)
        _close(post.scores, outputs[4].scores, "nms scores")
        _close(post.boxes, outputs[4].boxes, "nms boxes")

    got, _ = bytes_attribution.main([*PORT, "--batch", str(BATCH), "--image-size", str(SIZE),
                                     "--iters", "1", "--output", str(tmp_path / "port.json")])
    _same_keys(want, got, {"features", "transcendentals", "peaks", "serve",
                           "stage_sums_equal_serve"})
    assert got["stage_sums_equal_serve"]


@pytest.fixture(scope="module")
def shapes80(tmp_path_factory):
    """An 80-class shapes set at 64² (16 train images), as the JAX generator
    writes it."""
    root = str(tmp_path_factory.mktemp("shapes80") / "s80")
    make_shapes_dataset.main(["--root", root, "--num-classes", "80", "--size", str(SIZE),
                              "--train", "16", "--val", "1"])
    return root


def test_train_roofline_matches_the_jax_script(shapes80, tmp_path, monkeypatch):
    """Key for key, at 64² batch 8 with one timed call per program; JAX's
    chunked run (its fixed 50 + 200 steps) stubbed."""
    from hvs_tpu.training import ManifoldConstrainedTrainer as JaxTrainer
    from tests.test_torch_infer import _tiny_jax_config

    monkeypatch.setattr("hvs_tpu.config.ModelConfig", _tiny_jax_config)
    monkeypatch.setattr(JaxTrainer, "train_chunked", lambda self, *a, **k: None)
    _keep_compile_cache(monkeypatch)
    script = _load("scripts/train_roofline.py", "_jax_train_roofline")
    monkeypatch.setattr(sys, "argv", ["train_roofline.py", "--data-root", shapes80,
                                      "--resolutions", str(SIZE), "--iters", "1",
                                      "--output", str(tmp_path / "jax.json")])
    assert script.main() == 0
    want = json.loads((tmp_path / "jax.json").read_text())
    got, launches = train_roofline.main([
        *PORT, "--data-root", shapes80, "--resolutions", str(SIZE), "--iters", "1",
        "--chunk-warmup", "1", "--chunked-steps", "2", "--output", str(tmp_path / "p.json")])
    _same_keys(want, got, {"card", "power_limit", "transcendentals", "kernel_launches"})
    row = got["resolutions"][str(SIZE)]
    assert row["batch"] == want["resolutions"][str(SIZE)]["batch"] == 8
    for name in ("forward_loss", "forward_backward", "full_step"):
        assert row[name]["bound"] in BOUNDS.values()
        assert row[name]["transcendentals"] > 0  # kernel B's operators
    assert got["chunked_steps_per_sec"][str(SIZE)] > 0


def _jax_backbone_ablated(monkeypatch, x):
    """``gn_fusion_ceiling.py``'s ablated backbone at the tiny widths: its
    ``group_norm`` patch and ``use_se=False``, through the standard tail
    (the patch's lambda has no ``affine_from_channel_stats``, so the folded
    tail cannot run it)."""
    monkeypatch.setenv("HVS_FUSE_NORMS", "0")
    identity = lambda *a, **k: (lambda y: y)  # noqa: E731
    monkeypatch.setattr(jly, "group_norm", identity)
    monkeypatch.setattr(jbb, "group_norm", identity)
    model = jbb.HybridVisionBackbone(stage_channels=TINY["stage_channels"],
                                     stage_blocks=TINY["stage_blocks"], sk_iters=20,
                                     use_se=False, dtype=jnp.float32,
                                     precomputed_constraints=True)
    params = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), x[:1])["params"])
    out = model.apply({"params": params, "constraints": jax_constraints(params, 20)}, x)
    return params, jax.tree_util.tree_map(np.asarray, out)


def test_gn_fusion_ceiling_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    """The report key for key; the ablated backbone (its folded tail with
    identity norms, no SE) against JAX's patched one on its weights."""
    x = jnp.asarray(_images())
    params, want_out = _jax_backbone_ablated(monkeypatch, x)
    port = gn_fusion_ceiling.backbone(torch.device("cpu"), True, True, dtype=torch.float32)
    load_flax_params(port, params)
    load_constraints(port, compute_constraints(param_tree(port), 20))
    with torch.no_grad():
        got_out = port(torch.from_numpy(np.asarray(x)))
    for k in want_out:
        _close(got_out[k], want_out[k], k)
    monkeypatch.undo()

    orig = jbb.HybridVisionBackbone
    monkeypatch.setattr(jbb, "HybridVisionBackbone", lambda **kw: orig(**{
        **kw, "stage_channels": TINY["stage_channels"], "stage_blocks": TINY["stage_blocks"],
        "dtype": jnp.float32, "use_pallas": False}))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, dtype=jnp.float32: x)
    monkeypatch.setenv("HVS_FUSE_NORMS", "0")
    _keep_compile_cache(monkeypatch)
    (tmp_path / "artifacts").mkdir()
    monkeypatch.chdir(tmp_path)
    script = _load("scripts/gn_fusion_ceiling.py", "_jax_gn_ceiling")
    _one_call(script, "bench")
    capsys.readouterr()
    script.main()
    want = _last_json(capsys.readouterr().out)
    got, _ = gn_fusion_ceiling.main([*PORT, "--batch", str(BATCH), "--image-size", str(SIZE),
                                     "--iters", "1", "--output", str(tmp_path / "p.json")])
    _same_keys(want, got, {"peaks", "flops"})
    assert got["no_gn_se"]["bytes_accessed"] < got["full"]["bytes_accessed"]


def test_head_fusion_ceiling_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    """The report key for key; the serve forward with the detection head's
    norms the identity against JAX's patched one on its weights."""
    x = _images()
    identity = lambda *a, **k: (lambda y: y)  # noqa: E731
    monkeypatch.setattr(jyh, "group_norm", identity)
    model = _tiny_production(sk_iters=20)
    params = jax.device_get(jax.jit(functools.partial(model.init, task="detection"))(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"])
    want_out = model.apply({"params": params, "constraints": jax_constraints(params, 20)},
                           jnp.asarray(x), task="detection")["detection"]
    monkeypatch.undo()
    port = ProductionHybridVision(**TINY, sk_iters=20, dtype=torch.float32, device="cpu")
    assert perf.identity_norms(port.detection_head) == 6
    load_flax_params(port, params)
    det = Detector(port, device="cpu")
    with torch.inference_mode():
        got_out = det.model(torch.from_numpy(x))["detection"]
    for k in ("boxes", "scores", "class_scores"):
        _close(got_out[k], want_out[k], k)

    monkeypatch.setattr(jax_models, "ProductionHybridVision", _tiny_production)
    _keep_compile_cache(monkeypatch)
    script = _load("scripts/head_fusion_ceiling.py", "_jax_head_ceiling")
    _one_call(script, "bench")
    monkeypatch.setattr(sys, "argv", ["head_fusion_ceiling.py", "--batch", str(BATCH),
                                      "--image-size", str(SIZE), "--output",
                                      str(tmp_path / "jax.json")])
    script.main()
    want = json.loads((tmp_path / "jax.json").read_text())
    got, _ = head_fusion_ceiling.main([*PORT, "--batch", str(BATCH), "--image-size",
                                       str(SIZE), "--iters", "1",
                                       "--output", str(tmp_path / "p.json")])
    _same_keys(want, got, {"peaks", "flops"})


def _make_probe():
    """``make_probe`` from ``scripts/cls_loss_ab.py``'s source (the script
    trains when imported)."""
    from hvs_tpu.training.losses import build_targets

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "cls_loss_ab.py")
    tree = ast.parse(open(path).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "make_probe")
    namespace = {"jax": jax, "jnp": jnp, "build_targets": build_targets}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), namespace)
    return namespace["make_probe"]


def test_cls_loss_ab_probe_matches_the_script(shapes80):
    """The port's probe against the script's on the same converted weights
    and images: positives exact, the means within the tolerance."""
    from hvs_tpu_torch.data.device_pipeline import load_coco_arrays

    imgs, boxes, labels, mask = load_coco_arrays(shapes80, "train", max_boxes=16, limit=8)
    model = JaxSystem(**TINY, num_classes=80, sk_iters=5, dtype=jnp.float32, monitor=True)
    params = jax.device_get(jax.jit(functools.partial(model.init, task="detection"))(
        jax.random.PRNGKey(2), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))["params"])
    want = _make_probe()(model)(params, jnp.asarray(imgs), jnp.asarray(boxes),
                                jnp.asarray(labels), jnp.asarray(mask))
    port = _port_flagship(params, production=False, num_classes=80, sk_iters=5, monitor=True)
    got = cls_loss_ab.probe(port, *(torch.from_numpy(np.asarray(a)) for a in
                                    (imgs, boxes, labels, mask)))
    assert float(got[3]) == float(want[3]) > 0
    for g, w in zip(got[:3], want[:3]):
        _close(float(g), float(w))


def test_cls_loss_ab_runs_both_arms(shapes80, tmp_path, capsys):
    got, _ = cls_loss_ab.main(["--device", "cpu", "--tiny", "--data-root", shapes80,
                               "--steps", "2", "--images", "16", "--batch", "4",
                               "--probe-every", "2", "--probe-images", "4",
                               "--output", str(tmp_path / "ab.json")])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("loaded") and "done" in lines
    assert [ln.split("]")[0] for ln in lines if ln.startswith("[")] == \
        ["[A:bce_pw79"] * 2 + ["[B:softmax"] * 2
    assert json.loads(lines[-1]) == json.loads(json.dumps(got))
    assert set(got["arms"]) == {"A:bce_pw79", "B:softmax"} and got["winner"] in got["arms"]


@pytest.mark.parametrize("module,argv", [
    ("roofline", []), ("bytes_attribution", []), ("gn_fusion_ceiling", []),
    ("head_fusion_ceiling", []), ("train_roofline", ["--data-root", "missing"]),
    ("cls_loss_ab", ["--data-root", "missing"])])
def test_tools_raise_without_a_card(module, argv, monkeypatch):
    """Without CUDA and without ``--device cpu`` each tool raises before
    anything runs; on the CPU, peaks must be given."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tool = importlib.import_module(f"hvs_tpu_torch.{module}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
    if module != "cls_loss_ab":
        with pytest.raises(ValueError, match="no peaks known"):
            tool.main(["--device", "cpu", "--tiny", *argv])
