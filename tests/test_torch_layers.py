"""Parity of the port's layers with the JAX package's, in fp32 on the CPU.

The same seeded numpy parameters and inputs go through the flax module and
the port's module; flax paths carry over by name (conv kernels HWIO -> OIHW).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvs_tpu.models import layers as jl
from hvs_tpu.models.backbone import ConvMHCBlock as JaxConvMHCBlock
from hvs_tpu.models.constraints import compute_constraints as jax_constraints
from hvs_tpu.models.fpn import upsample2x as jax_upsample2x
from hvs_tpu.models.vit import interpolate_pos_embed as jax_interp
from hvs_tpu.models.yolo_head import decode_predictions as jax_decode
from hvs_tpu.models.yolo_head import effective_anchors, make_anchor_grid
from hvs_tpu_torch.convert import load_flax_params
from hvs_tpu_torch.models import layers as tl
from hvs_tpu_torch.models.backbone import ConvMHCBlock
from hvs_tpu_torch.models.constraints import compute_constraints, load_constraints, param_tree
from hvs_tpu_torch.models.fpn import upsample2x
from hvs_tpu_torch.models.vit import interpolate_pos_embed
from hvs_tpu_torch.models.yolo_head import decode_predictions

torch.set_num_threads(1)
F32 = jnp.float32


def _perturbed(params, seed, scale=0.1):
    """Seeded offsets on every leaf, so scales and biases are not at init."""
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + scale * r.standard_normal(np.shape(v))).astype(np.float32),
        jax.device_get(params))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("channels,shape", [(16, (2, 5, 6, 16)), (24, (1, 4, 4, 24)),
                                            (12, (2, 3, 7, 12))])
def test_group_norm_and_affine_match_jax(channels, shape):
    jmod = jl.group_norm(channels, F32)
    x = np.random.default_rng(channels).standard_normal(shape).astype(np.float32) * 3 + 1
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = tl.group_norm(channels, torch.float32)
    assert tmod.num_groups == jmod.num_groups
    load_flax_params(tmod, params)
    np.testing.assert_allclose(tmod(_t(x)).detach().numpy(), want, rtol=1e-5, atol=1e-5)

    mean, m2 = x.mean(axis=(1, 2)), (x * x).mean(axis=(1, 2))
    s_j, t_j = jmod.apply({"params": params}, jnp.asarray(mean), jnp.asarray(m2),
                          method=jl.GroupNorm.affine_from_channel_stats)
    s_t, t_t = tmod.affine_from_channel_stats(_t(mean), _t(m2))
    np.testing.assert_allclose(s_t.detach().numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_t.detach().numpy(), np.asarray(t_j), rtol=1e-5, atol=1e-6)


# At scale 1e-3 the variance is ~1e-6, where eps 1e-6 and torch's 1e-5 part.
# (Zero offset there: flax's E[x²] - E[x]² would cancel catastrophically.)
@pytest.mark.parametrize("scale,offset", [(2.0, 0.5), (1e-3, 0.0)])
def test_layer_norms_match_jax(scale, offset):
    x = np.random.default_rng(0).standard_normal((3, 7, 32)).astype(np.float32) * scale + offset
    jmod = fnn.LayerNorm(dtype=F32)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 2)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = tl.LayerNorm(32, dtype=torch.float32)
    load_flax_params(tmod, params)
    np.testing.assert_allclose(tmod(_t(x)).detach().numpy(), want, rtol=1e-4, atol=1e-4)
    # The mHC LayerNorm (two-pass variance, eps 1e-6).
    s, b = params["scale"], params["bias"]
    want = np.asarray(jl._layernorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    got = tl._layernorm(_t(x), _t(s), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 241).astype(np.float32)
    want = np.asarray(fnn.gelu(jnp.asarray(x)))
    got = tl.gelu(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(_t(x)).numpy()
    assert np.max(np.abs(erf - want)) > 1e-4  # the erf form would not match


@pytest.mark.parametrize("pooled_mode", [True, False])
def test_squeeze_excite_matches_jax(pooled_mode):
    c = 32
    jmod = jl.SqueezeExcite(c, dtype=F32)
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 5, 5, c)).astype(np.float32)
    pooled = r.standard_normal((2, c)).astype(np.float32)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 4)
    tmod = tl.SqueezeExcite(c, dtype=torch.float32)
    load_flax_params(tmod, params)
    if pooled_mode:
        want = jmod.apply({"params": params}, pooled=jnp.asarray(pooled), return_gates=True)
        got = tmod(pooled=_t(pooled), return_gates=True)
    else:
        want = jmod.apply({"params": params}, jnp.asarray(x))
        got = tmod(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_dense_attention_matches_jax():
    dim, heads = 32, 4
    x = np.random.default_rng(5).standard_normal((2, 9, dim)).astype(np.float32)
    jmod = jl.DenseAttention(dim=dim, num_heads=heads, dropout_rate=0.0, dtype=F32)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 6)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = tl.DenseAttention(dim, heads, dtype=torch.float32, dropout_rate=0.0)
    load_flax_params(tmod, params)
    np.testing.assert_allclose(tmod(_t(x)).detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_mhc_transformer_block_matches_jax():
    dim, heads = 32, 4
    x = np.random.default_rng(7).standard_normal((2, 10, dim)).astype(np.float32)
    jmod = jl.MHCTransformerBlock(dim=dim, num_heads=heads, sk_iters=10, dropout_rate=0.0,
                                  dtype=F32, precomputed_constraints=True)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 8)
    want = np.asarray(jmod.apply({"params": params, "constraints": jax_constraints(params, 10)},
                                 jnp.asarray(x)))
    tmod = tl.MHCTransformerBlock(dim, heads, dtype=torch.float32, dropout_rate=0.0,
                                  precomputed_constraints=True)
    load_flax_params(tmod, params)
    load_constraints(tmod, compute_constraints(param_tree(tmod), 10))
    with torch.no_grad():
        got = tmod(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("size", [8, 9, 16, 15])
@pytest.mark.parametrize("kernel,stride", [(3, 2), (1, 2), (3, 1)])
def test_same_padded_conv_matches_flax(size, kernel, stride):
    """flax SAME pads a stride-2 3x3 conv over an even size by (0, 1)."""
    x = np.random.default_rng(size).standard_normal((2, size, size + 2, 5)).astype(np.float32)
    jmod = fnn.Conv(7, (kernel, kernel), strides=(stride, stride), use_bias=False, dtype=F32)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = tl.Conv(5, 7, (kernel, kernel), (stride, stride), use_bias=False, dtype=torch.float32)
    load_flax_params(tmod, params)
    got = tmod(_t(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if kernel == 3 and stride == 2 and size % 2 == 0:
        assert tl.same_padding(size, 3, 2) == (0, 1)


@pytest.mark.parametrize("dst", [20, 10, 2, 13])
def test_interpolate_pos_embed_matches_jax(dst):
    pos = np.random.default_rng(dst).standard_normal((1, 13 * 13 + 1, 16)).astype(np.float32)
    want = np.asarray(jax_interp(jnp.asarray(pos), (13, 13), (dst, dst)))
    got = interpolate_pos_embed(_t(pos), (13, 13), (dst, dst)).numpy()
    assert got.shape == (1, dst * dst + 1, 16)
    # Both resize in fp32 but derive the bilinear weights differently: a few
    # ulps of these O(1) values.
    np.testing.assert_allclose(got, want, atol=5e-6)
    if dst < 13:  # shrinking: plain bilinear (no antialias) is far off
        grid = _t(pos)[:, 1:].reshape(1, 13, 13, 16).permute(0, 3, 1, 2)
        plain = torch.nn.functional.interpolate(grid, size=(dst, dst), mode="bilinear",
                                                align_corners=False, antialias=False)
        plain = plain.permute(0, 2, 3, 1).reshape(1, -1, 16).numpy()
        assert np.max(np.abs(plain - want[:, 1:])) > 0.1


def test_conv_mhc_block_serve_tail_matches_jax():
    """Projected shortcut (stride 2, new width) and identity shortcut."""
    for in_ch, ch, stride in ((16, 32, 2), (32, 32, 1)):
        x = np.random.default_rng(ch + stride).standard_normal((2, 8, 8, in_ch))
        x = x.astype(np.float32)
        jmod = JaxConvMHCBlock(channels=ch, stride=stride, sk_iters=10, dtype=F32,
                               precomputed_constraints=True)
        params = _perturbed(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 9)
        want = np.asarray(jmod.apply(
            {"params": params, "constraints": jax_constraints(params, 10)}, jnp.asarray(x)))
        tmod = ConvMHCBlock(in_ch, ch, stride, dtype=torch.float32,
                            precomputed_constraints=True).eval()
        load_flax_params(tmod, params)
        load_constraints(tmod, compute_constraints(param_tree(tmod), 10))
        with torch.no_grad():
            got = tmod(_t(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_upsample_and_decode_match_jax():
    r = np.random.default_rng(11)
    x = r.standard_normal((2, 3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(upsample2x(_t(x)).numpy(), np.asarray(jax_upsample2x(x)))

    raw = r.standard_normal((2, 4, 6, 3, 5 + 7)).astype(np.float32) * 3
    raw[..., 5 + 2] = raw[..., 5 + 4]  # a tie for the class argmax: first index wins
    grid = make_anchor_grid(4, 6, effective_anchors(1, 4))
    want = jax_decode(jnp.asarray(raw), jnp.asarray(grid))
    got = decode_predictions(_t(raw), _t(grid))
    for k in ("boxes", "scores", "objectness", "class_scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got["class_indices"].numpy(), np.asarray(want["class_indices"]))
