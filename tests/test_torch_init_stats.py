"""The port's fresh init of the full-width flagship (80 classes) against the
JAX package's, leaf by leaf, through ``hvs_tpu_torch.convert`` (the port's
parameters in flax's layout and names).

One seed on each side. Every leaf has the same shape. A leaf whose JAX init
does not depend on the seed (zeros, ones, the prediction bias's -4 prior:
JAX's init gives it bitwise the same under two seeds) is exactly equal. For
every other leaf of at least ``STATS_MIN_SIZE`` elements, the distribution
matches: the mean within ``MEAN_STD_FRACTION`` of JAX's std plus
``MEAN_ATOL``, and the std within ``STD_RTOL``.

The JAX init is compiled once at the smallest input the parameter shapes
allow (32², one cell of the coarsest map; no parameter's shape depends on
the input size) with XLA's backend optimisations off, and called with two
keys (~30 s here, nearly all of it XLA's compile).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvs_tpu.models import HybridVisionSystem as JaxHybridVisionSystem
from hvs_tpu_torch.convert import export_flax_params, flatten
from hvs_tpu_torch.models import HybridVisionSystem

NUM_CLASSES = 80
INIT_SIZE = 32
STATS_MIN_SIZE = 1024
MEAN_STD_FRACTION = 0.1
MEAN_ATOL = 1e-3
STD_RTOL = 0.10


@pytest.fixture(scope="module")
def inits():
    """(the port's leaves, JAX's leaves under key 0, JAX's under key 1), each
    {flax path: fp32 numpy array}."""
    torch.set_num_threads(1)
    port = HybridVisionSystem(num_classes=NUM_CLASSES, device="cpu", seed=0)
    port_leaves = {k: np.asarray(v, np.float32)
                   for k, v in flatten(export_flax_params(port)).items()}
    model = JaxHybridVisionSystem(num_classes=NUM_CLASSES)
    images = jnp.zeros((1, INIT_SIZE, INIT_SIZE, 3), jnp.float32)
    keys = [jax.random.PRNGKey(seed) for seed in (0, 1)]
    init = jax.jit(functools.partial(model.init, task="detection")).lower(
        keys[0], images).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})
    jax_leaves = [{k: np.asarray(v, np.float32) for k, v in
                   flatten(jax.device_get(init(key, images)["params"])).items()}
                  for key in keys]
    return port_leaves, *jax_leaves


def _seed_independent(a: np.ndarray, b: np.ndarray) -> bool:
    return np.array_equal(a, b)


def test_init_leaves_and_shapes_equal(inits):
    port, ref, _ = inits
    assert sorted(port) == sorted(ref)
    bad = {k: (port[k].shape, ref[k].shape) for k in ref if port[k].shape != ref[k].shape}
    assert not bad, bad
    assert sum(v.size for v in port.values()) == sum(v.size for v in ref.values())


def test_seed_independent_leaves_equal_exactly(inits):
    port, ref, other = inits
    constant = [k for k in ref if _seed_independent(ref[k], other[k])]
    # zeros (biases, LayerNorm and GroupNorm biases, FPN scale weights), ones
    # (norm scales) and the prediction convs' bias prior.
    assert len(constant) > 100
    bad = [k for k in constant if not np.array_equal(port[k], ref[k])]
    assert not bad, bad[:10]


def test_random_leaves_match_in_distribution(inits):
    port, ref, other = inits
    random_leaves = [k for k in ref if not _seed_independent(ref[k], other[k])
                     and ref[k].size >= STATS_MIN_SIZE]
    assert len(random_leaves) > 100
    bad = {}
    for k in random_leaves:
        p, r = port[k].astype(np.float64), ref[k].astype(np.float64)
        mean_ok = abs(p.mean() - r.mean()) <= MEAN_STD_FRACTION * r.std() + MEAN_ATOL
        std_ok = abs(p.std() - r.std()) <= STD_RTOL * r.std()
        if not (mean_ok and std_ok):
            bad[k] = {"port": (p.mean(), p.std()), "jax": (r.mean(), r.std())}
    assert not bad, bad
