"""The port's serve path against the JAX package's, end to end on the CPU.

A tiny ProductionHybridVision is initialised in JAX; its weights go through
the converter into the port, and the same 64² images go through both in
fp32: raw head outputs, decoded boxes and class scores, class indices and
the final fixed-K NMS output. Also: the port imports no JAX, and its entry
points refuse to fall back to the CPU on their own.
"""

import functools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvs_tpu.models import ProductionHybridVision as JaxProductionHybridVision
from hvs_tpu.models import compute_constraints as jax_constraints
from hvs_tpu.models.yolo_head import postprocess_detections as jax_postprocess
from hvs_tpu_torch.inference import Detector
from hvs_tpu_torch.models import ProductionHybridVision
from hvs_tpu_torch.models.layers import ManifoldHyperConnection

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_classes=3, stage_blocks=(1, 1, 1, 1), stage_channels=(32, 64, 128, 256),
            vit_dim=64, vit_depth=1, vit_heads=4, fpn_channels=64, head_channels=64,
            sk_iters=5)
# Template of the sharded-vs-single-device serve check (__graft_entry__.py):
# floats within rtol 2e-3 / atol 5e-3 (reassociation through the exp box
# decode), class indices exact where the top-2 class margin exceeds 5e-3.
RTOL, ATOL, MARGIN = 2e-3, 5e-3, 5e-3


@pytest.fixture(scope="module")
def jax_serve():
    """Tiny JAX serve model, its weights (as numpy) and its outputs on seeded
    images. The prediction convs are rescaled so that objectness and class
    scores spread across the 0.25 threshold: the NMS then has real work."""
    jm = JaxProductionHybridVision(dtype=jnp.float32, **TINY)
    images = np.random.default_rng(0).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    v = jax.jit(functools.partial(jm.init, task="detection"))(
        jax.random.PRNGKey(0), jnp.asarray(images))
    params = jax.device_get(v["params"])
    r = np.random.default_rng(1)
    for head in params["detection_head"].values():
        pred = head["predict"]
        pred["kernel"] = (pred["kernel"] * 4.0).astype(np.float32)
        bias = np.array(pred["bias"]).reshape(3, 5 + TINY["num_classes"])
        bias[:, 4] = 1.0
        bias[:, 5:] = r.standard_normal(bias[:, 5:].shape)
        pred["bias"] = bias.reshape(-1).astype(np.float32)
    variables = {"params": params, "constraints": jax_constraints(params, sk_iters=5)}

    @jax.jit
    def serve(x):
        d = jm.apply(variables, x, task="detection")["detection"]
        det = jax_postprocess(d, score_threshold=0.25, max_detections=100, pre_nms_top_k=512)
        return d, det

    d, det = jax.device_get(serve(jnp.asarray(images)))
    return params, images, d, det


def test_serve_fp32_matches_jax(jax_serve):
    params, images, want, want_det = jax_serve
    port = ProductionHybridVision(dtype=torch.float32, device="cpu", **TINY)
    det = Detector(port, params, device="cpu")
    with torch.inference_mode():
        got = det.model(torch.from_numpy(images))["detection"]
    for key, raw in want["raw"].items():
        np.testing.assert_allclose(got["raw"][key].numpy(), raw, rtol=RTOL, atol=ATOL,
                                   err_msg=key)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["class_scores"].numpy(), want["class_scores"],
                               rtol=RTOL, atol=ATOL)
    top2 = np.sort(want["scores"], axis=-1)
    decided = (top2[..., -1] - top2[..., -2]) > MARGIN
    assert decided.mean() > 0.5  # the check is not vacuous
    np.testing.assert_array_equal(got["class_indices"].numpy()[decided],
                                  want["class_indices"][decided])

    boxes, scores, classes = det(images)
    assert int((want_det.scores > 0).sum()) > 10  # real detections survive NMS
    np.testing.assert_array_equal(classes.numpy(), want_det.classes)
    np.testing.assert_allclose(scores.numpy(), want_det.scores, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(boxes.numpy(), want_det.boxes, rtol=RTOL, atol=ATOL)


def test_serve_bf16_on_cpu_gives_fixed_k_outputs(jax_serve):
    params, images, _, want_det = jax_serve
    port = ProductionHybridVision(dtype=torch.bfloat16, device="cpu", **TINY)
    boxes, scores, classes = Detector(port, params, device="cpu")(images)
    assert boxes.shape == (2, 100, 4) and scores.shape == (2, 100) and classes.shape == (2, 100)
    assert classes.dtype == torch.int32
    assert torch.isfinite(boxes).all() and torch.isfinite(scores).all()
    assert abs(int((scores > 0).sum()) - int((want_det.scores > 0).sum())) <= 8


def test_flagship_has_18_kernel_sites_of_25_mhc_layers():
    flagship = ProductionHybridVision(device="cpu")
    mhc = [m for m in flagship.modules() if isinstance(m, ManifoldHyperConnection)]
    assert len(mhc) == 25
    assert sorted(m.dim for m in mhc if m.fused) == [32] * 2 + [64] * 3 + [128] * 4 + \
        [256] * 8 + [512]


def test_entry_points_raise_without_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProductionHybridVision(**TINY)
    port = ProductionHybridVision(dtype=torch.float32, device="cpu", **TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Detector(port)


_JAX_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|hvs_tpu)(\.|\s|$)", re.M)


def test_port_imports_no_jax():
    """Importing every module of the port, its subpackages included (and
    chip_smoke.py), leaves jax, flax, optax, orbax and hvs_tpu out of
    sys.modules; no source line of them, of the port's card scripts
    (scripts/torch_*.py) or of its tours (examples/torch_*.py), imports them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import hvs_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(hvs_tpu_torch.__path__, 'hvs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules\n"
        "       if n.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'hvs_tpu')]\n"
        "print(sorted(bad))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    sources = [os.path.join(REPO, "chip_smoke.py")]
    # The card scripts; not the host tools that import the JAX package by
    # design and so run where JAX is installed: the checkpoint import tool
    # (it reads the JAX package's orbax and msgpack files) and the training
    # parity probe (it holds the port's trainer against JAX's; on the card it
    # runs the port alone, without reaching those imports).
    sources += [os.path.join(REPO, "scripts", f) for f in os.listdir(os.path.join(REPO, "scripts"))
                if f.startswith("torch_") and f.endswith(".py")
                and f not in ("torch_import_checkpoint.py", "torch_train_parity.py")]
    assert len(sources) >= 7
    # The port's runnable tours, which import only the port.
    tours = [os.path.join(REPO, "examples", f) for f in os.listdir(os.path.join(REPO, "examples"))
             if f.startswith("torch_") and f.endswith(".py")]
    assert len(tours) == 6
    sources += tours
    for root, _, files in os.walk(os.path.join(REPO, "hvs_tpu_torch")):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in sources:
        with open(path) as f:
            assert not _JAX_IMPORT.search(f.read()), path
