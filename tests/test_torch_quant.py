"""The port's int8 serving (W8A8) against the JAX package's, on the CPU.

Primitives on the same numpy inputs: int8 codes, per-channel int8 weights
and int32 accumulators exactly equal, fp32 outputs within 1 ulp, the
percentile merge within 1e-6. Calibration of a tiny fp32 model against
JAX's ``calibrate_quant_scales``. The tiny int8 model at each variant, with
JAX's ``quant`` tree carried across (``convert.load_flax_quant``), against
JAX's int8 model. The engine's scales (sidecar, embedded, missing, reload)
and ``python -m hvs_tpu_torch.quantize`` end to end.

Tolerances. The float paths of the two packages agree to fp32 rounding
(XLA and PyTorch sum products and evaluate tanh in other orders), not
bitwise: calibrated scales read the same sites to 1e-7 relative at the first
sites and to 2.4e-5 by the heads, so they are held to 1e-4 relative, and
the first sites exactly. An int8 code sits on a rounding boundary now and
then, and a code flipped by one moves every value downstream by a
quantization step, so whole int8 models drift apart: 10 % (int8) to 32 %
(int8 with the ViT) of their codes differ (held under 50 %). Their
site-by-site arithmetic is held by feeding the port JAX's codes at every
site: then the port's own codes differ from JAX's in at most 1.6e-4 of
elements (held under 1e-3), by one, and the raw head outputs agree to 1.2e-4
(held to rtol 2e-3 / atol 5e-3, as the float serve path in
``tests/test_torch_serve.py``).
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hvs_tpu.models.backbone as jax_backbone
import hvs_tpu.models.yolo_head as jax_yolo_head
import hvs_tpu.ops.quant as jq
from hvs_tpu.models import ProductionHybridVision as JaxProductionHybridVision
from hvs_tpu.models import calibrate_quant_scales as jax_calibrate
from hvs_tpu.models import compute_constraints as jax_constraints
from hvs_tpu.models.layers import ManifoldHyperConnection as JaxMHC
from hvs_tpu.models.layers import MHCTransformerBlock as JaxTransformerBlock
from hvs_tpu_torch.convert import (export_flax_quant, flatten, load_flax_params,
                                   load_flax_quant)
from hvs_tpu_torch.models import ProductionHybridVision, compute_constraints, \
    load_constraints, param_tree
from hvs_tpu_torch.models import backbone as port_backbone
from hvs_tpu_torch.models import fpn as port_fpn
from hvs_tpu_torch.models import layers as port_layers
from hvs_tpu_torch.models import yolo_head as port_yolo_head
from hvs_tpu_torch.models.layers import ManifoldHyperConnection, MHCTransformerBlock
from hvs_tpu_torch.models.quantize import calibrate_quant_scales, int8_sites_read, \
    load_quant_scales, quant_site_names
from hvs_tpu_torch.ops import quant as pq

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_classes=3, stage_blocks=(1, 1, 1, 1), stage_channels=(32, 64, 128, 256),
            vit_dim=64, vit_depth=1, vit_heads=4, fpn_channels=64, head_channels=64,
            sk_iters=5)
RTOL, ATOL = 2e-3, 5e-3  # the float serve path's parity (tests/test_torch_serve.py)
VARIANTS = {
    "int8": dict(act_quant=True),
    "fpn": dict(act_quant=True, act_quant_fpn=True),
    "mhc": dict(act_quant=True, act_quant_mhc=True),
    "vit": dict(act_quant=True, act_quant_vit=True),
    "all": dict(act_quant=True, act_quant_fpn=True, act_quant_mhc=True, act_quant_vit=True),
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(a) -> np.ndarray:
    return np.asarray(a)


# ---------------------------------------------------------------------------
# Primitives


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [0.0, 0.37, 3.0, 250.0])
def test_quantize_and_dequantize_match_jax(dtype, scale):
    r = np.random.default_rng(0)
    x = (r.standard_normal((64, 48)) * 3.0).astype(np.float32)
    x[0, :8] = np.arange(8) * (scale / 127.0) + scale / 254.0  # on rounding boundaries
    jx = jnp.asarray(x, dtype)
    px = _t(x).to(getattr(torch, dtype))
    s = np.float32(scale)
    q_jax, q_port = _np(jq.quantize_tensor(jx, jnp.asarray(s))), pq.quantize_tensor(px, _t(s))
    assert q_port.dtype == torch.int8
    np.testing.assert_array_equal(q_port.numpy(), q_jax)
    d_jax = _np(jq.dequantize_tensor(jnp.asarray(q_jax), jnp.asarray(s), jnp.float32))
    d_port = pq.dequantize_tensor(q_port, _t(s), torch.float32).numpy()
    np.testing.assert_array_max_ulp(d_port, d_jax, maxulp=1)
    e_jax = float(jq.quantization_error(jnp.asarray(x), jnp.asarray(s)))
    np.testing.assert_allclose(float(pq.quantization_error(_t(x), _t(s))), e_jax, rtol=1e-6)


@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (1, 1, 24, 40)])
def test_conv_weight_per_channel_matches_jax(shape):
    r = np.random.default_rng(1)
    k = r.standard_normal(shape).astype(np.float32)
    k[..., 0] *= 10.0  # one loud channel
    k[..., 3] = 0.0  # a dead one: scale 1
    q_jax, s_jax = jax.device_get(jq.quantize_weight_per_channel(jnp.asarray(k)))
    q_port, s_port = pq.quantize_weight_per_channel(_t(k.transpose(3, 2, 0, 1)), 0)
    np.testing.assert_array_equal(q_port.numpy().transpose(2, 3, 1, 0), q_jax)
    np.testing.assert_array_equal(s_port.numpy(), s_jax)
    assert float(s_port[3]) == 1.0


def test_dense_weight_per_channel_matches_jax():
    r = np.random.default_rng(2)
    w = r.standard_normal((24, 48)).astype(np.float32)
    w[:, 5] = 0.0
    w32 = jnp.asarray(w)
    s_jax = jnp.max(jnp.abs(w32), axis=0)  # matmul_int8's inline weight scales
    s_jax = jnp.where(s_jax > 0, s_jax, 1.0)
    q_jax = jnp.clip(jnp.round(w32 * (jq.INT8_MAX / s_jax)), -127, 127).astype(jnp.int8)
    q_port, s_port = pq.prepare_dense_weight(_t(w))
    np.testing.assert_array_equal(q_port.numpy().T, _np(q_jax))
    np.testing.assert_array_equal(s_port.numpy(), _np(s_jax))


@pytest.mark.parametrize("hw,kernel,stride", [
    ((16, 16), 3, 1), ((16, 16), 3, 2), ((15, 13), 3, 2), ((16, 16), 1, 2), ((9, 9), 1, 1)])
def test_conv_int8_accumulators_and_output_match_jax(hw, kernel, stride):
    """SAME pads: a stride-2 3x3 conv over an even size pads (0, 1)."""
    r = np.random.default_rng(3)
    x = r.standard_normal((2, *hw, 8)).astype(np.float32)
    k = (r.standard_normal((kernel, kernel, 8, 16)) * 0.1).astype(np.float32)
    s = np.float32(np.abs(x).max())
    x_q = jq.quantize_tensor(jnp.asarray(x), jnp.asarray(s))
    k_q, _ = jq.quantize_weight_per_channel(jnp.asarray(k))
    dn = jax.lax.conv_dimension_numbers(x_q.shape, k_q.shape, ("NHWC", "HWIO", "NHWC"))
    acc_jax = _np(jax.lax.conv_general_dilated(x_q, k_q, (stride, stride), "SAME",
                                               dimension_numbers=dn,
                                               preferred_element_type=jnp.int32))
    out_jax = _np(jq.conv_int8(x_q, jnp.asarray(k), jnp.asarray(s), strides=(stride, stride),
                               out_dtype=jnp.float32))

    xq_port = _t(_np(x_q))
    kernel_oihw = _t(k.transpose(3, 2, 0, 1))
    q, w_scale = pq.prepare_conv_weight(kernel_oihw)
    cols, (b, ho, wo) = pq.im2col(xq_port, (kernel, kernel), (stride, stride))
    acc_port = pq.int_mm(cols, q).reshape(b, ho, wo, -1)
    assert acc_port.dtype == torch.int32
    np.testing.assert_array_equal(acc_port.numpy(), acc_jax)
    out_port = pq.conv_int8(xq_port, kernel_oihw, _t(s), (stride, stride), torch.float32)
    np.testing.assert_array_max_ulp(out_port.numpy(), out_jax, maxulp=1)


@pytest.mark.parametrize("shape", [(32, 24), (2, 5, 16), (3, 40)])
def test_matmul_int8_accumulators_and_output_match_jax(shape):
    r = np.random.default_rng(4)
    x = r.standard_normal(shape).astype(np.float32)
    w = r.standard_normal((shape[-1], 48)).astype(np.float32)
    s = np.float32(np.abs(x).max())
    x_q = jq.quantize_tensor(jnp.asarray(x), jnp.asarray(s))
    w_q = jnp.clip(jnp.round(jnp.asarray(w) * (127.0 / jnp.max(jnp.abs(w), axis=0))),
                   -127, 127).astype(jnp.int8)
    acc_jax = _np(jax.lax.dot_general(x_q, w_q, (((x_q.ndim - 1,), (0,)), ((), ())),
                                      preferred_element_type=jnp.int32))
    out_jax = _np(jq.matmul_int8(x_q, jnp.asarray(w), jnp.asarray(s), out_dtype=jnp.float32))
    xq_port = _t(_np(x_q))
    q, _ = pq.prepare_dense_weight(_t(w))
    acc_port = pq.int_mm(xq_port.reshape(-1, shape[-1]), q).reshape(*shape[:-1], 48)
    np.testing.assert_array_equal(acc_port.numpy(), acc_jax)
    out_port = pq.matmul_int8(xq_port, _t(w), _t(s), torch.float32)
    assert out_port.shape == (*shape[:-1], 48)
    np.testing.assert_array_max_ulp(out_port.numpy(), out_jax, maxulp=1)


def test_int_mm_is_the_exact_integer_product_and_takes_int8_only():
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (37, 2304), generator=g, dtype=torch.int8)
    b_t = torch.randint(-127, 128, (19, 2304), generator=g, dtype=torch.int8)
    want = (a.long() @ b_t.long().T).to(torch.int32)  # |sums| < 2^31: exact in int32
    assert torch.equal(pq.int_mm(a, b_t), want)
    with pytest.raises(TypeError, match="int8"):
        pq.int_mm(a.float(), b_t)


def test_merges_and_quant_collection_match_jax():
    values = [1.0, 1.1, 0.9, 1.05, 50.0]  # one outlier batch
    jax_trees = [{"block": {"x_scale": (jnp.asarray(v, jnp.float32),),
                            "y_scale": (jnp.asarray(v * 0.3, jnp.float32),)}} for v in values]
    port_trees = [{"block.x_scale": torch.tensor(v, dtype=torch.float32),
                   "block.y_scale": torch.tensor(v * 0.3, dtype=torch.float32)} for v in values]
    for margin in (1.0, 0.8, 1.25):
        want = flatten(jax.device_get(jq.build_quant_collection(
            jq.merge_max_stats(jax_trees), margin=margin)))
        got = pq.build_quant_collection(pq.merge_max_stats(port_trees), margin=margin)
        assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
    for p in (50.0, 90.0, 99.0, 100.0):
        want = flatten(jax.device_get(jq.build_quant_collection(
            jq.merge_percentile_stats(jax_trees, p))))
        got = pq.build_quant_collection(pq.merge_percentile_stats(port_trees, p))
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    assert float(pq.build_quant_collection(pq.merge_max_stats(port_trees))["block.x_scale"]) \
        == 50.0
    assert pq.merge_max_stats([]) == {} and pq.merge_percentile_stats([]) == {}
    with pytest.raises(ValueError, match="different sites"):
        pq.merge_max_stats([port_trees[0], {"block.x_scale": torch.tensor(1.0)}])


# ---------------------------------------------------------------------------
# Layers: the mHC int8 chain and the transformer block's projections


def _jax_layer_pair(dim, block=False):
    r = np.random.default_rng(5)
    if block:
        kw = dict(dim=dim, num_heads=2, expansion_rate=1, mlp_ratio=2, sk_iters=5,
                  dropout_rate=0.0, dtype=jnp.float32)
        cls, x = JaxTransformerBlock, r.standard_normal((2, 9, dim)).astype(np.float32)
    else:
        kw = dict(dim=dim, expansion_rate=1, mlp_ratio=1, sk_iters=5, dropout_rate=0.0,
                  dtype=jnp.float32)
        cls, x = JaxMHC, r.standard_normal((2, 4, 4, dim)).astype(np.float32)
    v = jax.jit(cls(**kw, precomputed_constraints=True).init)(jax.random.PRNGKey(1), x)
    params = jax.device_get(v["params"])
    _, mut = cls(**kw, quant_calib=True).apply({"params": params}, x, mutable=["quant_stats"])
    scales = jax.device_get(jq.build_quant_collection(mut["quant_stats"]))
    want = cls(**kw, precomputed_constraints=True, act_quant=True).apply(
        {"params": params, "constraints": jax_constraints(params, sk_iters=5),
         "quant": scales}, x)
    return params, scales, x, _np(want)


@pytest.mark.parametrize("dim", [16, 32, 64, 128])
def test_mhc_int8_chain_matches_jax(dim):
    """Same input, same scales: every one of the chain's int8 codes equal."""
    params, scales, x, want = _jax_layer_pair(dim)
    layer = ManifoldHyperConnection(dim, 1, 1, dtype=torch.float32, sk_iters=5,
                                    dropout_rate=0.0, precomputed_constraints=True,
                                    act_quant=True, quant_sites=True).eval()
    assert not layer.fused and layer.quant_reads == layer.quant_sites
    load_flax_params(layer, params)
    load_constraints(layer, compute_constraints(param_tree(layer), 5))
    load_quant_scales(layer, load_flax_quant(layer, scales))
    with torch.no_grad():
        got = layer(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)


def test_mhc_int8_is_a_noop_without_serve_constraints():
    """As JAX: act_quant on a training-branch layer reads no scales and
    computes the float layer."""
    layer = ManifoldHyperConnection(16, 1, 1, dtype=torch.float32, sk_iters=5, dropout_rate=0.0,
                                    act_quant=True)
    base = ManifoldHyperConnection(16, 1, 1, dtype=torch.float32, sk_iters=5, dropout_rate=0.0)
    port_layers.init_weights(layer, 0)
    base.load_state_dict(layer.state_dict())
    assert not layer.int8 and layer.quant_reads == ()
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(layer.eval()(x), base.eval()(x))


def test_transformer_block_int8_matches_jax():
    params, scales, x, want = _jax_layer_pair(32, block=True)
    assert "qkv_in_scale" in scales["attn"] and "y1_scale" in scales["mhc_ffn"]
    block = MHCTransformerBlock(32, 2, dtype=torch.float32, dropout_rate=0.0, sk_iters=5,
                                precomputed_constraints=True, act_quant=True).eval()
    load_flax_params(block, params)
    load_constraints(block, compute_constraints(param_tree(block), 5))
    load_quant_scales(block, load_flax_quant(block, scales))
    with torch.no_grad():
        got = block(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)


# ---------------------------------------------------------------------------
# The tiny model: calibration and every int8 variant against JAX


@pytest.fixture(scope="module")
def calibrated():
    """A tiny fp32 JAX serve model, its weights, two calibration batches and
    JAX's calibrated scales; the port's float twin on the same weights."""
    jm = JaxProductionHybridVision(dtype=jnp.float32, **TINY)
    r = np.random.default_rng(0)
    images = [r.standard_normal((2, 64, 64, 3)).astype(np.float32) for _ in range(2)]
    v = jax.jit(functools.partial(jm.init, task="detection"))(
        jax.random.PRNGKey(0), jnp.asarray(images[0]))
    params = jax.device_get(v["params"])
    variables = {"params": params, "constraints": jax_constraints(params, sk_iters=5)}
    scales = jax.device_get(jax_calibrate(jm, variables, [jnp.asarray(i) for i in images]))
    port = ProductionHybridVision(dtype=torch.float32, device="cpu", **TINY).eval()
    load_flax_params(port, params)
    load_constraints(port, compute_constraints(param_tree(port), 5))
    return params, variables, images, scales, port


def test_calibration_matches_jax(calibrated):
    _, _, images, jax_scales, port = calibrated
    want = {k: float(v) for k, v in flatten(jax_scales).items()}
    got = calibrate_quant_scales(port, [_t(i) for i in images])
    # Every site JAX records, and only those; the int8 twin reads a subset.
    assert set(got) == set(want) == set(quant_site_names(port))
    assert len(want) == 54
    rel = {k: abs(float(got[k]) - want[k]) / want[k] for k in want}
    assert max(rel.values()) < 1e-4, sorted(rel.items(), key=lambda kv: -kv[1])[:4]
    for first in ("backbone.stem2_scale", "backbone.stage1_block0.x_scale"):
        assert rel[first] == 0.0  # nothing but the stem's convolution upstream
    # The recording leaves the model as it was: float, no recorder.
    assert all(getattr(m, "quant_stats", None) is None for m in port.modules())
    with pytest.raises(ValueError, match="at least one"):
        calibrate_quant_scales(port, [])


def _spy_codes(monkeypatch, modules, feed=None):
    """Record every quantize_tensor call of ``modules`` (the port's); with
    ``feed``, return the next of those codes instead of the port's own."""
    seen, orig = [], pq.quantize_tensor

    def spy(x, s):
        q = orig(x, s)
        seen.append(q)
        return torch.from_numpy(np.asarray(feed.pop(0))) if feed is not None else q

    for mod in modules:
        monkeypatch.setattr(mod, "quantize_tensor", spy)
    return seen


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_int8_model_matches_jax(calibrated, variant, monkeypatch):
    params, variables, images, jax_scales, _ = calibrated
    flags = VARIANTS[variant]
    jm = JaxProductionHybridVision(dtype=jnp.float32, **TINY, **flags)
    jax_codes, orig = [], jq.quantize_tensor

    def jax_spy(x, s):
        q = orig(x, s)
        jax_codes.append(q)
        return q

    for mod in (jq, jax_backbone, jax_yolo_head):
        monkeypatch.setattr(mod, "quantize_tensor", jax_spy)

    @jax.jit
    def serve(vs, x):
        jax_codes.clear()
        return jm.apply(vs, x, task="detection")["detection"]["raw"], list(jax_codes)

    want, codes = jax.device_get(serve({**variables, "quant": jax_scales},
                                       jnp.asarray(images[0])))
    monkeypatch.undo()

    port = ProductionHybridVision(dtype=torch.float32, device="cpu", **TINY, **flags).eval()
    load_flax_params(port, params)
    load_constraints(port, compute_constraints(param_tree(port), 5))
    load_quant_scales(port, load_flax_quant(port, jax_scales))
    modules = (port_layers, port_backbone, port_fpn, port_yolo_head)

    # Free-running: the share of codes that differ (flips compound downstream).
    own = _spy_codes(monkeypatch, modules)
    with torch.no_grad():
        free = port(_t(images[0]))["detection"]["raw"]
    assert len(own) == len(codes) and [tuple(c.shape) for c in own] == \
        [tuple(c.shape) for c in codes]
    free_share = sum(int((a.numpy() != b).sum()) for a, b in zip(own, codes)) / \
        sum(c.size for c in codes)
    assert free_share < 0.5 and all(np.isfinite(v.numpy()).all() for v in free.values())
    monkeypatch.undo()

    # Fed JAX's codes at every site: the same arithmetic, site by site.
    own = _spy_codes(monkeypatch, modules, feed=list(codes))
    with torch.no_grad():
        got = port(_t(images[0]))["detection"]["raw"]
    diffs = [np.abs(a.numpy().astype(int) - b.astype(int)) for a, b in zip(own, codes)]
    share = sum(int((d > 0).sum()) for d in diffs) / sum(d.size for d in diffs)
    assert share < 1e-3 and max(int(d.max()) for d in diffs) <= 1, share
    for key, raw in want.items():
        np.testing.assert_allclose(got[key].numpy(), raw, rtol=RTOL, atol=ATOL, err_msg=key)


def test_int8_model_loads_float_weights_and_names_its_sites():
    """The int8 twin has the float model's parameters (float checkpoints
    load unchanged); each variant reads a subset of the calibrated sites; the
    flagship keeps kernel A at 18, 18, 7, 17 and 6 sites."""
    float_names = [n for n, _ in ProductionHybridVision(device="cpu", **TINY).named_parameters()]
    for flags in VARIANTS.values():
        model = ProductionHybridVision(device="cpu", **TINY, **flags)
        assert [n for n, _ in model.named_parameters()] == float_names
        assert set(int8_sites_read(model)) <= set(quant_site_names(model))
    sites = {}
    for variant, flags in VARIANTS.items():
        flagship = ProductionHybridVision(device="cpu", **flags)
        sites[variant] = sum(m.fused for m in flagship.modules()
                             if isinstance(m, ManifoldHyperConnection))
    assert sites == {"int8": 18, "fpn": 18, "mhc": 7, "vit": 17, "all": 6}


def test_missing_or_unknown_scales_raise(calibrated):
    params, _, images, jax_scales, _ = calibrated
    model = ProductionHybridVision(dtype=torch.float32, device="cpu", **TINY, act_quant=True)
    load_flax_params(model, params)
    load_constraints(model, compute_constraints(param_tree(model), 5))
    with pytest.raises(RuntimeError, match="not loaded"):
        with torch.no_grad():
            model(_t(images[0]))
    with pytest.raises(ValueError, match="float twin"):
        calibrate_quant_scales(model, [_t(images[0])])
    scales = load_flax_quant(model, jax_scales)
    partial = dict(scales)
    partial.pop("backbone.stem2_scale")
    with pytest.raises(KeyError, match="stem2_scale"):
        load_quant_scales(model, partial)
    with pytest.raises(KeyError, match="does not have"):
        load_quant_scales(model, {**scales, "backbone.nowhere_scale": torch.tensor(1.0)})
    # The quant tree crosses both ways; a leaf off the model's sites raises.
    back = load_flax_quant(model, export_flax_quant(scales))
    assert {k: float(v) for k, v in back.items()} == {k: float(v) for k, v in scales.items()}
    with pytest.raises(KeyError, match="int8 sites"):
        load_flax_quant(model, {"fpn": {"bogus_scale": np.float32(1.0)}})


def test_jax_calibration_through_pallas_records_no_mhc_chain(monkeypatch):
    """A defect of the reference (ROADMAP §3): where JAX's calibration
    forward takes the Pallas kernel, the layer returns before its chain's
    ``sow``s, so the calibrated tree lacks the y1/a1/a2/x scales that
    ``act_quant_mhc`` reads. The port's calibration runs the unfused chain at
    every mHC site and records them."""
    monkeypatch.setenv("HVS_PALLAS_MIN_TOKENS", "0")
    monkeypatch.setenv("HVS_PALLAS_MIN_BATCH", "1")
    kw = dict(dim=32, expansion_rate=1, mlp_ratio=1, sk_iters=5, dropout_rate=0.0,
              dtype=jnp.float32)
    x = np.random.default_rng(6).standard_normal((4, 4, 4, 32)).astype(np.float32)
    layer = JaxMHC(**kw, precomputed_constraints=True, use_pallas=True, quant_calib=True)
    v = jax.jit(JaxMHC(**kw, precomputed_constraints=True).init)(jax.random.PRNGKey(0), x)
    params = jax.device_get(v["params"])
    _, mut = layer.apply({"params": params, "constraints": jax_constraints(params, sk_iters=5)},
                         x, mutable=["quant_stats"])
    assert "quant_stats" not in mut or not mut["quant_stats"]
    port = ManifoldHyperConnection(32, 1, 1, dtype=torch.float32, sk_iters=5, dropout_rate=0.0,
                                   precomputed_constraints=True, quant_sites=True).eval()
    load_flax_params(port, params)
    load_constraints(port, compute_constraints(param_tree(port), 5))
    assert port.fused is False  # fp32: the fused block serves bf16 sites only
    record = {}
    port.quant_stats = record
    with torch.no_grad():
        port(_t(x))
    port.quant_stats = None
    assert set(record) == {"y1_scale", "a1_scale", "a2_scale", "x_scale"}


# ---------------------------------------------------------------------------
# The engine and the entry point


def _engine_configs(tmp_path=None, **quant):
    from tests.test_torch_engine_serving import port_inference_config, port_model_config

    mcfg = port_model_config()
    if quant:
        mcfg.quantization.enabled = True
        for k, v in quant.items():
            setattr(mcfg.quantization, k, v)
    return mcfg, port_inference_config()


def _frame(seed=0):
    return np.random.default_rng(seed).integers(0, 255, (64, 64, 3), np.uint8)


def _serve(engine, frame):
    entry = engine._serve_fn(1)
    entry.static_in.copy_(torch.from_numpy(frame[None]))
    out, _ = entry.run(None)
    return out.numpy().copy()


def test_engine_scales_from_sidecar_embedded_or_raise(tmp_path):
    from hvs_tpu_torch.inference import InferenceEngine

    float_engine = InferenceEngine(*_engine_configs())
    images = [torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(i))
              for i in range(2)]
    scales = calibrate_quant_scales(float_engine.model, images)
    params = {k: v.detach().clone() for k, v in float_engine.model.named_parameters()}
    sidecar = str(tmp_path / "scales.pt")
    torch.save(scales, sidecar)

    with pytest.raises(ValueError, match="requires calibrated scales"):
        InferenceEngine(*_engine_configs(quantize_mhc=True))
    with pytest.raises(ValueError, match="requires calibrated scales"):
        InferenceEngine(*_engine_configs(quantize_mhc=True), variables={"params": params})

    # The sidecar, read at init (no made-up scales shadow it: the model has
    # none before it is read) ...
    from_file = InferenceEngine(*_engine_configs(scales_path=sidecar, quantize_mhc=True),
                                variables={"params": params})
    read = {f"{name}.{site}": float(getattr(m, site))
            for name, m in from_file.model.named_modules()
            for site in getattr(m, "quant_reads", ())}
    assert read == {k: float(scales[k]) for k in int8_sites_read(from_file.model)}
    assert len(read) > 10
    # ... equals the scales embedded in the variables, as the port's dict or
    # as a flax quant tree (what a hot swap passes), and the random-init
    # engine with only the sidecar.
    embedded = InferenceEngine(*_engine_configs(quantize_mhc=True),
                               variables={"params": params, "quant": scales})
    tree = InferenceEngine(*_engine_configs(quantize_mhc=True),
                           variables={"params": params, "quant": export_flax_quant(scales)})
    seeded = InferenceEngine(*_engine_configs(scales_path=sidecar, quantize_mhc=True))
    want = _serve(from_file, _frame())
    for other in (embedded, tree, seeded):
        np.testing.assert_array_equal(_serve(other, _frame()), want)
    assert not np.array_equal(want, _serve(float_engine, _frame()))

    # A reload with new scales changes the output; back again restores it.
    from_file.reload({"params": params, "quant": {k: v * 1.5 for k, v in scales.items()}})
    changed = _serve(from_file, _frame())
    assert not np.array_equal(changed, want)
    from_file.reload({"params": params})  # no scales given: the sidecar again
    np.testing.assert_array_equal(_serve(from_file, _frame()), want)


def test_quantize_entry_point_end_to_end(tmp_path):
    from hvs_tpu_torch import quantize
    from hvs_tpu_torch.data import generate_shapes_dataset

    root = str(tmp_path / "s64")
    generate_shapes_dataset(root, num_train=2, num_val=8, size=64, seed=0)
    out, scales = str(tmp_path / "report.json"), str(tmp_path / "scales.pt")
    report = quantize.main([
        "--random-init", "--tiny", "--device", "cpu", "--data-root", root,
        "--resolutions", "32,64", "--calib-images", "8", "--calib-batch", "4",
        "--bench-batch", "2", "--eval-fpn", "--eval-mhc", "--eval-vit",
        "--scales-out", scales, "--output", out])
    assert report["card"] == "cpu" and report["calibration"]["images"] == 8
    assert report["calibration"]["resolution"] == 64 and os.path.exists(scales)
    labels = {"float", "int8", "int8_fpn", "int8_mhc", "int8_vit", "int8_all"}
    for res in ("32", "64"):
        entry = report["resolutions"][res]
        assert set(entry) == labels
        for label in labels - {"float"}:
            assert {"mAP@0.5", "mAP@[.5:.95]", "batch_ms", "fps", "mAP@0.5_delta",
                    "speedup"} <= set(entry[label])
            assert entry[label]["num_images"] == 8 and entry[label]["batch_ms"] > 0
    assert len(torch.load(scales)) == report["calibration"]["sites"]
    # The module runs as a program, and refuses to run without weights.
    proc = subprocess.run([sys.executable, "-m", "hvs_tpu_torch.quantize", "--device", "cpu"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "--checkpoint is required" in proc.stderr
