"""The port's off-path model pieces against the JAX package's on the CPU:
RMSNorm, MultiHeadManifoldAttention and the encoder built with it (forward,
gradients, serve forward with constraints at load, the sites that every
Sinkhorn consumer finds), PatchEmbedding, VisionTransformerDecoder, the FPN
fusion variants, collect_stability_metrics, and the backbone's
get_output_channels and compute_flops.

The same seeded numpy parameters (a JAX init, perturbed so that scales and
biases are not at their init) go into both packages through ``convert.py``,
which raises unless every flax path maps onto one port parameter.
Tolerances:
  * fp32 forwards within 1e-5 of the output's largest magnitude (1 at least);
  * bf16 forwards without mHC layers within 2 bf16 steps of the output's
    largest magnitude, and a correlation with JAX above 0.9999. Not the
    port's end-to-end rtol 2e-3 / atol 5e-3: XLA on the CPU keeps some of
    JAX's bf16 intermediates in fp32 (it may skip a rounding), so single
    elements differ by one or two bf16 steps of the largest intermediate
    (0.0156-0.031 here);
  * bf16 forwards with mHC layers, whose weights at the init scale (H_post
    near 1) make LN2 amplify each GELU's last bit (ROADMAP §3), as
    ``tests/test_torch_serve_sum.py`` holds them: a correlation with JAX
    above ``MIN_CORR``, and the port as far from the fp32 function (JAX's
    fp32 module, same weights) as JAX's bf16 output, their correlations with
    it within ``MAX_GAP``;
  * gradients per parameter group within 1e-4 of the group's largest.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvs_tpu.models import backbone as jbackbone
from hvs_tpu.models import fpn as jfpn
from hvs_tpu.models import layers as jlayers
from hvs_tpu.models import vit as jvit
from hvs_tpu.models.constraints import compute_constraints as jax_constraints
from hvs_tpu.models.hybrid import HybridVisionSystem as JaxHybridVisionSystem
from hvs_tpu.models.hybrid import collect_stability_metrics as jax_collect
from hvs_tpu_torch.convert import load_flax_params
from hvs_tpu_torch.models import (AdaptiveFeatureFusion, CrossScaleAttention,
                                  HybridVisionBackbone, HybridVisionEncoder, HybridVisionSystem,
                                  MultiHeadManifoldAttention, MultiScaleFeatureFusion,
                                  PatchEmbedding, RMSNorm, VisionTransformerDecoder,
                                  collect_stability_metrics, compute_constraints,
                                  load_constraints, param_tree)
from hvs_tpu_torch.models import layers as tlayers
from hvs_tpu_torch.training.losses import iter_h_res_leaves
from hvs_tpu_torch.training.optimizer import ManifoldAwareOptimizer, _is_square_h_res

torch.set_num_threads(1)

MIN_CORR, MAX_GAP = 0.99, 0.02  # bf16 with mHC layers (the module docstring)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
SK = 5  # Sinkhorn iterations of the tiny modules


def _perturbed(params, seed, scale=0.05):
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v, np.float32)
                   + scale * r.standard_normal(np.shape(v))).astype(np.float32),
        jax.device_get(params))


def _init(jmod, seed, *args, **kwargs):
    return _perturbed(jax.jit(functools.partial(jmod.init, **kwargs))(
        jax.random.PRNGKey(seed), *args)["params"], seed + 100)


def _np(x):
    return np.asarray(jax.device_get(x), np.float64) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy().astype(np.float64)


def _corr(a, b) -> float:
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def _match(got, want, precision):
    """fp32: within 1e-5 of the output's scale; bf16: within 2 bf16 steps of
    the output's largest magnitude, correlation above 0.9999."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    top = max(1.0, np.abs(want).max())
    if precision == "fp32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * top)
    else:
        step = 2.0 ** (np.floor(np.log2(top)) - 7)  # bf16 spacing at the largest value
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * step)
        assert _corr(got, want) > 0.9999


def _as_far(got, want, exact):
    """bf16 through mHC layers: correlated with JAX's output, and as far from
    the fp32 function as JAX's output is."""
    got, want, exact = _np(got), _np(want), _np(exact)
    assert got.shape == want.shape and np.isfinite(got).all()
    c, gap = _corr(got, want), abs(_corr(got, exact) - _corr(want, exact))
    assert c > MIN_CORR and gap < MAX_GAP, (c, gap)


def _features(seed, channels=(12, 20, 24), sizes=(6, 4, 2), batch=2):
    r = np.random.default_rng(seed)
    return {k: r.standard_normal((batch, s, s, c)).astype(np.float32)
            for k, s, c in zip(jfpn.SCALES, sizes, channels)}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_rmsnorm_matches_jax(precision):
    jdt, tdt = DTYPES[precision]
    x = 3.0 * np.random.default_rng(0).standard_normal((2, 5, 24)).astype(np.float32) + 0.5
    jmod = jlayers.RMSNorm(dtype=jdt)
    params = _init(jmod, 0, jnp.asarray(x))
    port = RMSNorm(24, dtype=tdt)
    load_flax_params(port, params)
    _match(port(torch.from_numpy(x)), jmod.apply({"params": params}, jnp.asarray(x)), precision)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_manifold_attention_matches_jax(precision):
    jdt, tdt = DTYPES[precision]
    x = np.random.default_rng(1).standard_normal((2, 7, 16)).astype(np.float32)
    kw = dict(dim=16, num_heads=2, sk_iters=SK, dropout_rate=0.0)
    jmod = jlayers.MultiHeadManifoldAttention(dtype=jdt, **kw)
    params = _init(jmod, 1, jnp.asarray(x))
    port = MultiHeadManifoldAttention(16, 2, dtype=tdt, dropout_rate=0.0, sk_iters=SK).eval()
    load_flax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    want = jmod.apply({"params": params}, jnp.asarray(x))
    if precision == "fp32":
        _match(got, want, precision)
    else:
        exact = jlayers.MultiHeadManifoldAttention(dtype=jnp.float32, **kw).apply(
            {"params": params}, jnp.asarray(x))
        _as_far(got, want, exact)


ENCODER = dict(cnn_channels=32, dim=16, num_heads=2, sk_iters=SK, dropout_rate=0.0,
               use_manifold_attention=True)


def _encoder_pair(precision, serve=False, depth=2):
    """A tiny manifold-attention encoder in both packages (mhc_fuse at the
    kernel width 32), with the same weights."""
    jdt, tdt = DTYPES[precision]
    feat = np.random.default_rng(2).standard_normal((2, 3, 3, 32)).astype(np.float32)
    jmod = jvit.HybridVisionEncoder(dtype=jdt, precomputed_constraints=serve, depth=depth,
                                    **ENCODER)
    params = _init(jmod, 2, jnp.asarray(feat))
    port = HybridVisionEncoder(dtype=tdt, precomputed_constraints=serve, depth=depth,
                               **ENCODER)
    load_flax_params(port, params)
    return jmod, params, port, feat


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_manifold_attention_encoder_serve_forward_matches_jax(precision):
    """Serve mode: the constrained matrices computed once at load (31 layers
    at depth 6 in the flagship; here depth 2: 4 · 2 + 2 + 1 = 11), mhc_fuse
    through the fused block's plain version in bf16."""
    jmod, params, port, feat = _encoder_pair(precision, serve=True)
    assert load_constraints(port, compute_constraints(param_tree(port), SK)) == 11
    assert port.mhc_fuse.fused == (precision == "bf16")
    variables = {"params": params, "constraints": jax_constraints(params, SK)}
    want = jmod.apply(variables, jnp.asarray(feat))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(feat))
    if precision == "fp32":
        _match(got, want, precision)
    else:
        exact = jvit.HybridVisionEncoder(dtype=jnp.float32, precomputed_constraints=True,
                                         depth=2, **ENCODER).apply(variables, jnp.asarray(feat))
        _as_far(got, want, exact)


def _group(name: str) -> str:
    """Parameter groups: the manifold attention, the FFN mHC layers and the
    block norms per block, the fusion layer, and the token path."""
    parts = name.split(".")
    if parts[0] == "encoder" and parts[1].startswith("block"):
        return ".".join(parts[:3])
    return "mhc_fuse" if parts[0] == "mhc_fuse" else "tokens"


def test_manifold_attention_encoder_gradients_match_jax_grad():
    """Train mode, dropout 0, fp32: d sum(out · w) / d every parameter,
    group by group, against jax.grad of the same loss."""
    jmod, params, port, feat = _encoder_pair("fp32")
    w = np.random.default_rng(3).standard_normal((2, 3, 3, 32)).astype(np.float32)

    @jax.jit
    def jax_grads(p):
        def loss(p_):
            out = jmod.apply({"params": p_}, jnp.asarray(feat), deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(0)})
            return jnp.sum(out * w)
        return jax.grad(loss)(p)

    want = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(jax_grads(params))}
    port.train()
    (port(torch.from_numpy(feat)) * torch.from_numpy(w)).sum().backward()
    got = {n: p.grad for n, p in port.named_parameters()}
    assert set(got) == set(want)
    groups = {}
    for n in got:
        groups.setdefault(_group(n), []).append(n)
    assert len(groups) == 2 * 3 + 2
    for names in groups.values():
        scale = max(np.abs(want[n]).max() for n in names)
        assert scale > 0
        for n in names:
            g = got[n].numpy()
            if g.ndim == 4:  # conv kernels: OIHW here, HWIO in flax
                g = g.transpose(2, 3, 1, 0)
            np.testing.assert_allclose(g, want[n], rtol=0, atol=1e-4 * scale, err_msg=n)


def test_every_sinkhorn_consumer_finds_the_manifold_attention_sites(monkeypatch):
    """At depth 6 the encoder holds 31 mHC layers, 24 of them in the
    attention: the constraints at load, a training forward (and its
    backward, through autograd), the manifold regulariser's leaves and the
    optimizer's periodic projection each find all 31."""
    _, _, port, feat = _encoder_pair("fp32", depth=6)
    named = dict(port.named_parameters())
    attn = [n for n, _ in iter_h_res_leaves(named) if ".attn.mhc_" in n]
    assert len(attn) == 24 and len(list(iter_h_res_leaves(named))) == 31
    assert sum(_is_square_h_res(n, t) for n, t in named.items()) == 31
    tx = ManifoldAwareOptimizer(named, 1e-3, project_every=1, sk_iters=SK)
    grads = {n: torch.zeros_like(p) for n, p in named.items()}
    calls = []
    real = tlayers.sinkhorn_log
    monkeypatch.setattr(tlayers, "sinkhorn_log",
                        lambda m, *a: calls.append(tuple(m.shape)) or real(m, *a))
    out = port.train()(torch.from_numpy(feat))
    assert len(calls) == 31
    out.float().square().mean().backward()
    assert all(named[n].grad is not None and named[n].grad.abs().sum() > 0
               for n in attn)
    before = {n: named[n].detach().clone() for n in attn}
    tx.step(grads)  # a projection step: every square H_res_raw is re-projected
    assert all(not torch.equal(named[n].detach(), before[n]) for n in attn)
    # The serve model's constraints at load.
    _, _, serve, _ = _encoder_pair("fp32", serve=True, depth=6)
    assert load_constraints(serve, compute_constraints(param_tree(serve), SK)) == 31


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_patch_embedding_matches_jax(precision):
    jdt, tdt = DTYPES[precision]
    # 40 is not a multiple of the patch: flax pads SAME (0 low, 8 high); the
    # grid (3, 3) is below the reference grid, so the embedding shrinks.
    images = np.random.default_rng(4).standard_normal((2, 40, 40, 3)).astype(np.float32)
    jmod = jvit.PatchEmbedding(dim=16, patch_size=16, reference_grid=5, dtype=jdt)
    params = _init(jmod, 4, jnp.asarray(images))
    port = PatchEmbedding(3, 16, 16, reference_grid=5, dtype=tdt)
    load_flax_params(port, params)
    got = port(torch.from_numpy(images))
    assert got.shape == (2, 1 + 9, 16)
    _match(got, jmod.apply({"params": params}, jnp.asarray(images)), precision)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_vit_decoder_matches_jax(precision):
    jdt, tdt = DTYPES[precision]
    memory = np.random.default_rng(5).standard_normal((2, 11, 24)).astype(np.float32)
    jmod = jvit.VisionTransformerDecoder(dim=16, depth=2, num_heads=2, num_queries=5,
                                         dropout_rate=0.0, dtype=jdt)
    params = _init(jmod, 5, jnp.asarray(memory))
    assert {"LayerNorm_5", "Dense_3", "xproj1", "self_attn1"} <= set(params)
    port = VisionTransformerDecoder(16, 2, 2, num_queries=5, dropout_rate=0.0, dtype=tdt,
                                    memory_dim=24).eval()
    load_flax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(memory))
    _match(got, jmod.apply({"params": params}, jnp.asarray(memory)), precision)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("sizes", [(8, 4, 2), (6, 4, 2)])
def test_fpn_fusion_variants_match_jax(precision, sizes):
    """(6, 4, 2): medium resized by 1.5, where only half-pixel nearest
    sampling agrees with jax.image.resize."""
    jdt, tdt = DTYPES[precision]
    feats = _features(6, sizes=sizes)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    tfeats = {k: torch.from_numpy(v) for k, v in feats.items()}
    for jcls, tcls, kw in ((jfpn.MultiScaleFeatureFusion, MultiScaleFeatureFusion,
                            dict(out_channels=16)),
                           (jfpn.CrossScaleAttention, CrossScaleAttention,
                            dict(channels=16, num_heads=4)),
                           (jfpn.AdaptiveFeatureFusion, AdaptiveFeatureFusion,
                            dict(out_channels=16))):
        jmod = jcls(dtype=jdt, **kw)
        params = _init(jmod, 7, jfeats)
        port = tcls((12, 20, 24), dtype=tdt, **kw)
        load_flax_params(port, params)
        with torch.no_grad():
            got = port(tfeats)
        want = jmod.apply({"params": params}, jfeats)
        if isinstance(want, dict):
            assert set(got) == set(want)
            for k in want:
                _match(got[k], want[k], precision)
        else:
            _match(got, want, precision)


def test_backbone_output_channels_and_flops_match_jax():
    jmod = jbackbone.HybridVisionBackbone(stage_channels=(16, 24, 32, 40))
    port = HybridVisionBackbone(8, (1, 1, 1, 1), (16, 24, 32, 40), dtype=torch.float32)
    assert port.get_output_channels() == jmod.get_output_channels()
    for size in ((416, 416), (640, 480), (320, 320)):
        assert HybridVisionBackbone.compute_flops(size) == \
            jbackbone.HybridVisionBackbone.compute_flops(size)


def test_collect_stability_metrics_matches_jax():
    """A monitored tiny model, fp32, eval forward: the same summary, the
    per-layer keys the flax paths of the monitored layers; each number
    within rtol 1e-5, atol 1e-6 (the ds_error readings are fp32 rounding of
    row sums, a few 1e-7)."""
    cfg = dict(num_classes=3, stage_blocks=(1, 1, 1, 1), stage_channels=(16, 24, 32, 40),
               base_channels=8, vit_dim=16, vit_depth=1, vit_heads=2, fpn_channels=16,
               head_channels=16, sk_iters=SK)
    images = np.random.default_rng(8).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    jm = JaxHybridVisionSystem(dtype=jnp.float32, monitor=True, **cfg)
    params = _init(jm, 8, jnp.asarray(images), task="detection")
    _, coll = jax.jit(functools.partial(jm.apply, task="detection", mutable=["stability"]))(
        {"params": params}, jnp.asarray(images))
    want = jax_collect(jax.device_get(coll["stability"]))
    port = HybridVisionSystem(dtype=torch.float32, monitor=True, device="cpu", **cfg)
    load_flax_params(port, params)
    with torch.no_grad():
        got = collect_stability_metrics(port.eval()(torch.from_numpy(images))["stability"])
    assert got["num_layers"] == want["num_layers"] > 5
    assert list(got["per_layer"]) == list(want["per_layer"])
    assert set(got) == set(want)
    for key in set(want) - {"per_layer", "num_layers"}:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)
    for layer, metrics in want["per_layer"].items():
        assert set(got["per_layer"][layer]) == set(metrics)
        for k, v in metrics.items():
            np.testing.assert_allclose(float(got["per_layer"][layer][k]), float(v),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{layer}/{k}")
