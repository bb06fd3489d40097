"""Weights carried across: a flax tree onto the port's modules, and the mHC
constraints computed from them, against the JAX package."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvs_tpu.models import ProductionHybridVision as JaxProductionHybridVision
from hvs_tpu.models import compute_constraints as jax_constraints
from hvs_tpu_torch.convert import export_flax_params, flatten, load_flax_params
from hvs_tpu_torch.models import ProductionHybridVision, compute_constraints, param_tree
from hvs_tpu_torch.models.constraints import load_constraints
from hvs_tpu_torch.models.layers import ManifoldHyperConnection

torch.set_num_threads(1)

TINY = dict(num_classes=3, stage_blocks=(1, 1, 1, 1), stage_channels=(32, 64, 128, 256),
            vit_dim=64, vit_depth=1, vit_heads=4, fpn_channels=64, head_channels=64,
            sk_iters=5)


@pytest.fixture(scope="module")
def flax_params():
    jm = JaxProductionHybridVision(dtype=jnp.float32, **TINY)
    v = jax.jit(functools.partial(jm.init, task="detection"))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    return jax.device_get(v["params"])


def _port(params=None):
    port = ProductionHybridVision(dtype=torch.float32, device="cpu", **TINY)
    if params is not None:
        load_flax_params(port, params)
    return port


def test_every_flax_leaf_maps_and_round_trips(flax_params):
    port = _port(flax_params)
    want, got = flatten(flax_params), flatten(export_flax_params(port))
    assert set(got) == set(want)  # no leaf dropped, none invented
    assert len(want) == len(dict(port.named_parameters()))
    for name, a in want.items():
        assert got[name].shape == a.shape, name
        np.testing.assert_array_equal(got[name], a, err_msg=name)
    # Conv kernels are OIHW in the port, HWIO in flax.
    stem = flax_params["backbone"]["stem1"]["kernel"]
    np.testing.assert_array_equal(port.backbone.stem1.kernel.detach().numpy(),
                                  stem.transpose(3, 2, 0, 1))


def test_load_rejects_a_tree_that_does_not_match(flax_params):
    port = _port()
    missing = copy.deepcopy(flax_params)
    del missing["fpn"]["mhc0"]["H_res_raw"]
    with pytest.raises(KeyError, match="missing"):
        load_flax_params(port, missing)
    extra = copy.deepcopy(flax_params)
    extra["classifier"] = {"kernel": np.zeros((4, 3), np.float32)}
    with pytest.raises(KeyError, match="unexpected"):
        load_flax_params(port, extra)
    wrong = copy.deepcopy(flax_params)
    wrong["feature_proj"]["bias"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="feature_proj.bias"):
        load_flax_params(port, wrong)


def test_compute_constraints_matches_jax(flax_params):
    want = flatten(jax.device_get(jax_constraints(flax_params, sk_iters=5)))
    port = _port(flax_params)
    got = flatten(_numpy_tree(compute_constraints(param_tree(port), sk_iters=5)))
    assert set(got) == set(want)
    for name, a in want.items():
        np.testing.assert_allclose(got[name], a, rtol=0, atol=1e-6, err_msg=name)


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.detach().numpy()
            for k, v in tree.items()}


def test_load_constraints_covers_every_mhc_layer(flax_params):
    port = _port(flax_params)
    n_layers = sum(isinstance(m, ManifoldHyperConnection) for m in port.modules())
    # backbone 4 blocks, ViT 1 ffn + fuse, FPN 3, head 3, global features 1
    assert n_layers == 13
    assert load_constraints(port, compute_constraints(param_tree(port), sk_iters=5)) == n_layers
    for m in port.modules():
        if isinstance(m, ManifoldHyperConnection):
            assert m.h_res is not None and m.h_res.dtype == torch.float32
