"""The port's ViT-less models against the JAX package on the CPU:
``LightweightHybridVision`` (forward in fp32, served by ``Detector``, its
kernel sites, its full-width parameter tree) and ``use_vit=False`` on the
flagship."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvs_tpu.models import HybridVisionSystem as JaxHybridVisionSystem
from hvs_tpu.models import LightweightHybridVision as JaxLightweightHybridVision
from hvs_tpu.ops.pallas.mhc_pallas import mhc_pallas_packed_supported
from hvs_tpu_torch.convert import export_flax_params, flatten, load_flax_params
from hvs_tpu_torch.inference import Detector
from hvs_tpu_torch.models import HybridVisionSystem, LightweightHybridVision
from hvs_tpu_torch.models.layers import ManifoldHyperConnection
from hvs_tpu_torch.train import TINY

torch.set_num_threads(1)

RTOL, ATOL = 2e-3, 5e-3  # tests/test_torch_serve.py's fp32 end-to-end tolerance
IMG = 64


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


def _shapes(tree):
    """{dotted path: shape} of a (possibly abstract) nested tree."""
    return {".".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def jax_lightweight():
    jm = JaxLightweightHybridVision(dtype=jnp.float32, num_classes=4, sk_iters=5)
    x = np.random.default_rng(0).uniform(size=(2, IMG, IMG, 3)).astype(np.float32)
    params = jax.device_get(jax.jit(functools.partial(jm.init, task="detection"))(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3), jnp.float32))["params"])
    out = jax.device_get(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    return dict(params=params, x=x, out=out)


def test_lightweight_forward_matches_jax(jax_lightweight):
    want = jax_lightweight
    port = LightweightHybridVision(dtype=torch.float32, num_classes=4, sk_iters=5,
                                   device="cpu")
    assert port.vit_encoder is None
    load_flax_params(port, want["params"])
    port.eval()
    with torch.no_grad():
        out = port(torch.from_numpy(want["x"]))
    for key in want["out"]["detection"]["raw"]:
        _close(out["detection"]["raw"][key].numpy(), want["out"]["detection"]["raw"][key],
               msg=key)
    _close(out["detection"]["scores"].numpy(), want["out"]["detection"]["scores"])
    _close(out["features"].numpy(), want["out"]["features"])


def test_lightweight_served_by_detector_matches_its_training_branch(jax_lightweight):
    """Constraints computed once at load (the serve flags) against the same
    weights computing them per forward: the same function."""
    want = jax_lightweight
    served = LightweightHybridVision(dtype=torch.float32, num_classes=4, sk_iters=5,
                                     precomputed_constraints=True, dropout_rate=0.0,
                                     device="cpu")
    det = Detector(served, want["params"], device="cpu")
    with torch.no_grad():
        raw = det.model(torch.from_numpy(want["x"]))["detection"]["raw"]
    for key, value in raw.items():
        _close(value.numpy(), want["out"]["detection"]["raw"][key], msg=key)
    boxes, scores, classes = det(want["x"])
    assert boxes.shape == (2, 100, 4) and scores.shape == (2, 100) and classes.shape == (2, 100)


def test_lightweight_runs_kernel_a_at_the_sites_the_pallas_kernel_takes():
    """Kernel A serves the 3 FPN levels and 3 head towers at d = 128; the
    bottleneck widths (24, 48, 96, 192) are neither the port's kernel widths
    nor the Pallas kernel's, so both packages pick the same sites."""
    port = LightweightHybridVision(precomputed_constraints=True, dropout_rate=0.0,
                                   device="cpu")
    mhc = {name: m for name, m in port.named_modules() if isinstance(m, ManifoldHyperConnection)}
    assert sorted(m.dim for m in mhc.values()) == [24, 48, 48, 96, 96, 128, 128, 128, 128, 128,
                                                   128, 192, 256]
    fused = sorted(name for name, m in mhc.items() if m.fused)
    assert [mhc[n].dim for n in fused] == [128] * 6
    assert all(n.startswith(("fpn.", "detection_head.")) for n in fused)
    # The JAX layer's rule: expansion 1, mlp ratio 1, a width the packed
    # Pallas kernel serves.
    pallas = sorted(name for name, m in mhc.items()
                    if m.H_pre_raw.shape == m.mlp_in_kernel.shape == (m.dim, m.dim)
                    and mhc_pallas_packed_supported(m.dim))
    assert pallas == fused


@pytest.mark.parametrize("name", ["lightweight", "flagship_without_vit"])
def test_full_width_parameters_match_jax(name):
    if name == "lightweight":
        jm, port = JaxLightweightHybridVision(), LightweightHybridVision(device="cpu")
    else:
        jm = JaxHybridVisionSystem(use_vit=False)
        port = HybridVisionSystem(use_vit=False, device="cpu")
    want = _shapes(jax.eval_shape(functools.partial(jm.init, task="detection"),
                                  jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))["params"])
    got = {k: tuple(v.shape) for k, v in flatten(export_flax_params(port)).items()}
    assert got == want
    assert not any(k.startswith("vit_encoder") for k in got)


def test_flagship_without_vit_matches_jax():
    jm = JaxHybridVisionSystem(dtype=jnp.float32, use_vit=False, **TINY)
    x = np.random.default_rng(1).uniform(size=(1, IMG, IMG, 3)).astype(np.float32)
    params = jax.device_get(jax.jit(functools.partial(jm.init, task="detection"))(
        jax.random.PRNGKey(1), jnp.zeros((1, IMG, IMG, 3), jnp.float32))["params"])
    want = jax.device_get(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    port = HybridVisionSystem(dtype=torch.float32, use_vit=False, device="cpu", **TINY)
    load_flax_params(port, params)
    port.eval()
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    for key, value in out["detection"]["raw"].items():
        _close(value.numpy(), want["detection"]["raw"][key], msg=key)
    _close(out["features"].numpy(), want["features"])
