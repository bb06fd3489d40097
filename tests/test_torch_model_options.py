"""The JAX modules' options in the port, held against JAX on converted
weights in fp32 on the CPU, and every field of every public flax module in
``hvs_tpu/models/`` against the port's constructor.

Options: ``use_mhc`` (the model without mHC: no ``mhc*`` parameters, no
matrix projected, kernel A at no site), ``use_se``, ``bottleneck_ratio``,
``num_anchors``, ``anchors`` and ``out_channels``.
"""

import dataclasses
import importlib
import inspect

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvs_tpu.models import backbone as jbb
from hvs_tpu.models import fpn as jfpn
from hvs_tpu.models import yolo_head as jyh
from hvs_tpu.models.constraints import compute_constraints as jax_constraints
from hvs_tpu_torch.convert import flatten, load_flax_params
from hvs_tpu_torch.models import backbone as tbb
from hvs_tpu_torch.models import fpn as tfpn
from hvs_tpu_torch.models import yolo_head as tyh
from hvs_tpu_torch.models.constraints import compute_constraints, load_constraints, param_tree
from hvs_tpu_torch.ops import mhc_block as mhc_mod
from hvs_tpu_torch.ops import sinkhorn as sink_mod

torch.set_num_threads(1)
F32 = jnp.float32
SK = 5
RTOL, ATOL = 2e-3, 5e-3  # the port against JAX end to end (fp32 here)


def _perturbed(params, seed, scale=0.1):
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + scale * r.standard_normal(np.shape(v))).astype(np.float32),
        jax.device_get(params))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _pair(jmod, tmod, x, serve: bool, seed: int):
    """JAX's output and the port's on the same perturbed weights; ``serve``:
    the constraints precomputed (the fused tail, the serve branch)."""
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(seed), x)
    params = _perturbed(variables["params"], seed)
    jvars = {"params": params}
    if serve:
        jvars["constraints"] = jax_constraints(params, SK)
    want = jmod.apply(jvars, x, mutable=["stability"])[0]
    load_flax_params(tmod, params)
    tmod.eval()
    if serve:
        load_constraints(tmod, compute_constraints(param_tree(tmod), SK))
    with torch.no_grad():
        got = tmod(jax.tree_util.tree_map(_t, x) if isinstance(x, dict) else _t(x))
    return params, want, got


def _close(got, want):
    """Every leaf of ``got`` (port) against ``want`` (JAX), by path."""
    got = flatten(_np_tree(got) if isinstance(got, dict) else {"out": _np_tree(got)})
    want = flatten(_np_tree(want) if isinstance(want, dict) else {"out": _np_tree(want)})
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda v: np.asarray(v.detach() if isinstance(
        v, torch.Tensor) else v, np.float32), tree)


@pytest.mark.parametrize("serve", [False, True])
@pytest.mark.parametrize("ratio,use_mhc,use_se", [
    (0.5, False, True), (0.5, True, False), (0.25, False, False), (0.75, True, True)])
def test_conv_mhc_block_options_match_jax(ratio, use_mhc, use_se, serve):
    """Both tails (the standard one, and the serve fold), a projected
    shortcut; the block without mHC holds no ``mhc`` parameters."""
    x = jnp.asarray(np.random.default_rng(3).standard_normal((2, 8, 8, 16)), F32)
    jmod = jbb.ConvMHCBlock(channels=64, stride=2, bottleneck_ratio=ratio, use_mhc=use_mhc,
                            use_se=use_se, sk_iters=SK, dtype=F32, dropout_rate=0.0,
                            precomputed_constraints=serve)
    tmod = tbb.ConvMHCBlock(16, 64, 2, dtype=torch.float32, bottleneck_ratio=ratio,
                            use_mhc=use_mhc, use_se=use_se, sk_iters=SK,
                            precomputed_constraints=serve)
    params, want, got = _pair(jmod, tmod, x, serve, seed=int(ratio * 100))
    assert ("mhc" in params) == use_mhc and ("se" in params) == use_se
    assert tmod.reduce.kernel.shape[0] == max(16, int(64 * ratio))
    _close(got, want)


@pytest.mark.parametrize("use_mhc,use_se", [(False, True), (True, False), (False, False)])
def test_backbone_options_match_jax(use_mhc, use_se):
    x = jnp.asarray(np.random.default_rng(5).standard_normal((1, 64, 64, 3)), F32)
    kw = dict(base_channels=8, stage_blocks=(1, 1, 1, 1), stage_channels=(16, 32, 32, 64))
    jmod = jbb.HybridVisionBackbone(**kw, sk_iters=SK, use_mhc=use_mhc, use_se=use_se,
                                    dtype=F32, precomputed_constraints=True)
    tmod = tbb.HybridVisionBackbone(**kw, dtype=torch.float32, use_mhc=use_mhc, use_se=use_se,
                                    sk_iters=SK, precomputed_constraints=True)
    params, want, got = _pair(jmod, tmod, x, True, seed=7)
    names = flatten(params)
    assert any(".mhc." in n for n in names) == use_mhc
    assert any(".se." in n for n in names) == use_se
    _close(got, want)


def test_fpn_options_match_jax():
    """``out_channels`` and ``use_mhc=False`` (no ``mhc{i}``)."""
    r = np.random.default_rng(9)
    feats = {k: jnp.asarray(r.standard_normal((2, s, s, c)), F32) for k, s, c in
             (("scale_small", 8, 16), ("scale_medium", 4, 24), ("scale_large", 2, 32))}
    out = (24, 40, 56)
    jmod = jfpn.FeaturePyramidNetwork(fpn_channels=32, out_channels=out, use_mhc=False,
                                      sk_iters=SK, dtype=F32, precomputed_constraints=True)
    tmod = tfpn.FeaturePyramidNetwork((16, 24, 32), 32, dtype=torch.float32, out_channels=out,
                                      use_mhc=False, sk_iters=SK, precomputed_constraints=True)
    params, want, got = _pair(jmod, tmod, feats, True, seed=11)
    assert not any(k.startswith("mhc") for k in params)
    assert [got[k].shape[-1] for k in tfpn.OUT_NAMES] == list(out)
    _close(got, want)


@pytest.mark.parametrize("use_mhc", [False, True])
def test_detection_head_anchor_options_match_jax(use_mhc):
    """``num_anchors`` 2 with a custom ``anchors`` table: raw outputs and the
    decode (boxes, scores) as JAX's."""
    anchors = (((0.02, 0.03), (0.05, 0.04)), ((0.1, 0.12), (0.2, 0.15)),
               ((0.3, 0.35), (0.6, 0.5)))
    r = np.random.default_rng(13)
    feats = {k: jnp.asarray(r.standard_normal((2, s, s, c)), F32) for k, s, c in
             (("fused_small", 8, 16), ("fused_medium", 4, 24), ("fused_large", 2, 32))}
    jmod = jyh.YOLODetectionHead(num_classes=5, num_anchors=2, head_channels=32,
                                 use_mhc=use_mhc, anchors=anchors, sk_iters=SK, dtype=F32,
                                 precomputed_constraints=True)
    tmod = tyh.YOLODetectionHead((16, 24, 32), 5, 32, dtype=torch.float32, num_anchors=2,
                                 use_mhc=use_mhc, anchors=anchors, sk_iters=SK,
                                 precomputed_constraints=True)
    params, want, got = _pair(jmod, tmod, feats, True, seed=17)
    assert got["raw"]["fused_small"].shape == (2, 8, 8, 2, 10)
    assert any(".mhc." in n for n in flatten(params)) == use_mhc
    for k in ("raw", "boxes", "scores", "class_scores"):
        _close(got[k], want[k])


def test_models_without_mhc_project_nothing_and_launch_no_kernel():
    """``use_mhc=False`` on the backbone, FPN and head: no ``mhc*``
    parameters, an empty constraints tree (kernel B at no matrix), and no
    mHC layer in the forward (kernel A at no site)."""
    kw = dict(sk_iters=SK, precomputed_constraints=True, use_mhc=False)
    mods = [tbb.HybridVisionBackbone(8, (1, 1, 1, 1), (16, 32, 32, 64), dtype=torch.float32,
                                     **kw),
            tfpn.FeaturePyramidNetwork((32, 32, 64), 32, dtype=torch.float32, **kw),
            tyh.YOLODetectionHead((256, 512, 1024), 5, 32, dtype=torch.float32, **kw)]
    for m in mods:
        assert not any("mhc" in n for n, _ in m.named_parameters())
        assert compute_constraints(param_tree(m), SK) == {}
        assert load_constraints(m, {}) == 0
    calls = []
    orig = mhc_mod.mhc_block_op, sink_mod.sinkhorn_log_op
    mhc_mod.mhc_block_op = lambda *a: calls.append("A") or orig[0](*a)
    sink_mod.sinkhorn_log_op = lambda *a: calls.append("B") or orig[1](*a)
    try:
        with torch.no_grad():
            scales = mods[0].eval()(torch.randn(1, 64, 64, 3))
            det = mods[2].eval()(mods[1].eval()(scales))
    finally:
        mhc_mod.mhc_block_op, sink_mod.sinkhorn_log_op = orig
    assert det["raw"]["fused_small"].shape == (1, 8, 8, 3, 10) and not calls


# ---------------------------------------------------------------------------
# Every field of every public flax module against the port's constructor.

MODULES = ("backbone", "fpn", "yolo_head", "hybrid", "layers", "vit", "rag", "quantize",
           "constraints")

# Fields the port's constructors do not take, each with its reason.
EXEMPT = {
    "use_pallas": "the port has no gate: its kernels always run on the card",
    "quant_calib": "calibration is a mode of the port's modules (QuantSites.calibrating, "
                   "models/quantize.py), not a constructor field",
    ("QuantConv", "out_dtype"): "named dtype in the port",
    ("QuantDense", "out_dtype"): "named dtype in the port",
    ("ManifoldHyperConnection", "monitor_eigs"): "the eigenvalue telemetry is the host "
                                                 "loops' (training/stability.py "
                                                 "make_eig_telemetry), not the layer's",
}
# Options of the mHC layer that a module takes in ``**mhc`` and hands on.
MHC_PASSED = ("sk_iters", "monitor", "precomputed_constraints", "tau")


def _flax_modules():
    for m in MODULES:
        jmod = importlib.import_module(f"hvs_tpu.models.{m}")
        tmod = importlib.import_module(f"hvs_tpu_torch.models.{m}")
        for name, cls in vars(jmod).items():
            if not name.startswith("_") and inspect.isclass(cls) \
                    and issubclass(cls, fnn.Module) and cls.__module__ == jmod.__name__:
                yield name, cls, getattr(tmod, name, None)


def _taken(tcls) -> set:
    """The keyword options the port's constructor takes: its own (a subclass
    whose constructor takes only ``**kwargs`` hands them all to its base),
    and with a ``**mhc`` the mHC layer's options it hands on."""
    params = inspect.signature(tcls.__init__).parameters
    while list(params) == ["self", "kwargs"]:
        tcls = tcls.__mro__[1]
        params = inspect.signature(tcls.__init__).parameters
    taken = {p for p, v in params.items() if v.kind != v.VAR_KEYWORD}
    if any(v.kind == v.VAR_KEYWORD for v in params.values()):
        taken |= set(MHC_PASSED)
    return taken


def test_every_flax_module_field_is_a_port_option():
    names = []
    for name, jcls, tcls in _flax_modules():
        names.append(name)
        assert tcls is not None, f"{name} has no counterpart in hvs_tpu_torch.models"
        taken = _taken(tcls)
        for f in dataclasses.fields(jcls):
            if f.name in ("parent", "name") or f.name in taken:
                continue
            assert f.name in EXEMPT or (name, f.name) in EXEMPT, \
                f"{name}.{f.name} is not an option of the port's {tcls.__name__}"
    assert {"ConvMHCBlock", "HybridVisionBackbone", "FeaturePyramidNetwork",
            "YOLOPredictionHead", "YOLODetectionHead", "HybridVisionSystem"} <= set(names)
