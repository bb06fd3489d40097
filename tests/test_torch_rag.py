"""The retrieval-augmented model of the port (``hvs_tpu_torch/models/rag.py``
and ``use_rag``) against the JAX package's, on the CPU.

The knowledge base equals JAX's bitwise. ``RAGVisionKnowledge`` and
``KnowledgeAwareDetection`` match JAX's forward on the same weights: fp32 to
``MODULE_RTOL``, bf16 to ``BF16_MIN_CORR``, the retrieved indices exactly,
ties included (lower index first, as ``lax.top_k``). A tiny
``HybridVisionSystem(use_rag=True)`` with its weights carried across by
``convert`` and the gate set to ``GATE`` (at its init value 0 the blend is an
exact no-op and a comparison would test nothing of the retrieval): the serve
and validation forwards and one fp32 train step (loss, gradient norm and the
gradients of every rag parameter, ``rag_gate`` included) against JAX's, to
the serve path's end-to-end tolerance (``tests/test_torch_serve.py``), and
the engine's detections against the JAX engine's on the same tiny config.
Also the converter's round trip, the int8 variants (the rag site stays bf16
and uncalibrated, as in JAX), the ``.pt2`` export (one more ``hvs::mhc_block``
call) and ``train_device --use-rag`` into ``evaluate --use-rag``.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvs_tpu.inference import InferenceEngine as JaxEngine
from hvs_tpu.models import HybridVisionSystem as JaxHybridVisionSystem
from hvs_tpu.models import ProductionHybridVision as JaxProductionHybridVision
from hvs_tpu.models import compute_constraints as jax_constraints
from hvs_tpu.models import rag as jrag
from hvs_tpu.training import losses as jlosses
from hvs_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from hvs_tpu.training.trainer import global_norm as jax_global_norm
from hvs_tpu_torch.config import InferenceConfig, ModelConfig, from_dict
from hvs_tpu_torch.convert import export_flax_params, flatten, load_flax_params, to_flax_layout
from hvs_tpu_torch.data import generate_shapes_dataset
from hvs_tpu_torch.data.shapes import SHAPE_CLASSES
from hvs_tpu_torch.inference import Detector, InferenceEngine
from hvs_tpu_torch.models import HybridVisionSystem, ProductionHybridVision
from hvs_tpu_torch.models import rag as prag
from hvs_tpu_torch.models.layers import Dropout, ManifoldHyperConnection
from hvs_tpu_torch.models.quantize import quant_site_names
from hvs_tpu_torch.train import TINY, make_synthetic_loader
from hvs_tpu_torch.training.trainer import ManifoldConstrainedTrainer, TrainerConfig, \
    batch_to, train_step
from tests.test_inference import tiny_inference_config, tiny_model_config

torch.set_num_threads(1)

MODULE_RTOL, MODULE_ATOL = 1e-5, 1e-5   # one module in fp32: sums reassociated only
BF16_MIN_CORR = 0.999                   # one module in bf16 (measured 0.9999+)
# The whole model in fp32, as tests/test_torch_serve.py and test_torch_train.py.
RTOL, ATOL = 2e-3, 5e-3
GATE = 0.5
NUM_CLASSES = 8
IMAGE = 64
SHAPES = tuple(SHAPE_CLASSES)


def _corr(a, b) -> float:
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


def _perturbed(params, seed):
    """Every leaf moved off its init value (zero biases, unit norms) so that
    each one takes part."""
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + 0.1 * r.standard_normal(np.shape(v))).astype(np.float32),
        params)


# ---------------------------------------------------------------------------
# The knowledge base and the modules


@pytest.mark.parametrize("classes,rows", [(None, 85), (SHAPES, 13)])
def test_knowledge_base_equals_jax_bitwise(classes, rows):
    want_facts, want = jrag.build_knowledge_base(128, classes)
    facts, emb = prag.build_knowledge_base(128, classes)
    assert facts == want_facts and len(facts) == rows
    assert emb.dtype == want.dtype == np.float32 and emb.shape == (rows, 128)
    assert emb.tobytes() == want.tobytes()


# Four facts of each of two names, then the five common ones: 13 rows with
# two groups of equal similarities, so every top-5 meets ties.
TIED = ("circle",) * 4 + ("square",) * 4


def _conditioned_mhc(node, seed):
    """H_res, H_pre and H_post near the identity, as
    ``tests/test_torch_mhc_block.py`` conditions its bf16 layers: at their
    init values the mHC sum is ill-conditioned, where JAX's bf16 GELU
    (rounded at each step) and PyTorch's (rounded once) drift apart, whatever
    the module around the layer does (``tests/test_torch_serve_sum.py``)."""
    d = node["H_res_raw"].shape[0]
    r, eye = np.random.default_rng(seed), np.eye(d)
    node["H_res_raw"] = (6.0 * eye + r.standard_normal((d, d))).astype(np.float32)
    node["H_pre_raw"] = (6.0 * eye - 3.0 + 0.5 * r.standard_normal((d, d))).astype(np.float32)
    node["H_post_raw"] = (6.0 * eye - 6.0 + 0.5 * r.standard_normal((d, d))).astype(np.float32)


def _rag_module_pair(dtype, kb_classes, c=32, t=12, seed=0):
    jm = jrag.RAGVisionKnowledge(channels=c, num_heads=4, sk_iters=5, dtype=dtype,
                                 kb_classes=kb_classes)
    x = np.random.default_rng(seed).standard_normal((2, t, c)).astype(np.float32)
    params = _perturbed(jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                                        jnp.asarray(x))["params"]), seed)
    if dtype == jnp.bfloat16:
        _conditioned_mhc(params["mhc_fuse"], seed)
    out, state = jax.jit(functools.partial(jm.apply, capture_intermediates=True,
                                           mutable=["intermediates"]))(
        {"params": params}, jnp.asarray(x))
    query = state["intermediates"]["query_proj"]["__call__"][0]
    kb = jnp.asarray(jrag.build_knowledge_base(128, kb_classes)[1])
    idx = jax.jit(lambda q: jax.lax.top_k(
        (q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + 1e-8)) @ kb.T, 5)[1])(query)
    port = prag.RAGVisionKnowledge(c, num_heads=4, sk_iters=5,
                                   dtype=torch.float32 if dtype == jnp.float32
                                   else torch.bfloat16, kb_classes=kb_classes)
    load_flax_params(port, params)
    return port.eval(), torch.from_numpy(x), np.asarray(out, np.float32), np.asarray(idx)


@pytest.mark.parametrize("kb_classes", [SHAPES, TIED], ids=["shapes", "ties"])
def test_rag_module_fp32_and_retrieval_match_jax(kb_classes):
    port, x, want, want_idx = _rag_module_pair(jnp.float32, kb_classes)
    with torch.no_grad():
        idx = port.retrieve(x)
        got = port(x)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    if kb_classes == TIED:
        assert any(len(set(row)) < len(row) for row in
                   (port.kb[idx].sum(-1).numpy().round(6).tolist()))  # ties were met
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=MODULE_RTOL, atol=MODULE_ATOL)


def test_rag_module_bf16_matches_jax():
    """bf16: the fused mHC site (the unfolded block's plain version in this
    eval forward, conditioned) and the bf16 projections; fp32 query and
    softmax."""
    port, x, want, want_idx = _rag_module_pair(jnp.bfloat16, SHAPES, c=64, seed=1)
    assert port.mhc_fuse.fused
    with torch.no_grad():
        idx = port.retrieve(x.bfloat16())
        got = port(x)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    assert got.dtype == torch.bfloat16
    assert _corr(got.float().numpy(), want) > BF16_MIN_CORR


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_knowledge_aware_detection_matches_jax(dtype):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16,
                                                                      torch.bfloat16)
    r = np.random.default_rng(3)
    fmap = r.standard_normal((2, 8, 8, 32)).astype(np.float32)
    xy = r.uniform(0.0, 0.6, (2, 6, 2))
    boxes = np.concatenate([xy, xy + r.uniform(0.1, 0.4, (2, 6, 2))], -1).astype(np.float32)
    scores = r.uniform(0.2, 1.0, (2, 6)).astype(np.float32)
    classes = r.integers(0, NUM_CLASSES, (2, 6)).astype(np.int32)
    classes[:, 4:] = -1  # padding rows
    jm = jrag.KnowledgeAwareDetection(num_classes=NUM_CLASSES, dtype=jdt)
    args = [jnp.asarray(a) for a in (fmap, boxes, scores, classes)]
    params = _perturbed(jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(2),
                                                        *args)["params"]), 2)
    want = jax.device_get(jax.jit(jm.apply)({"params": params}, *args))
    port = prag.KnowledgeAwareDetection(32, num_classes=NUM_CLASSES, dtype=tdt)
    load_flax_params(port, params)
    with torch.no_grad():
        got = port(*[torch.from_numpy(a) for a in (fmap, boxes, scores, classes)])
    np.testing.assert_allclose(got["region_features"].numpy(), want["region_features"],
                               rtol=MODULE_RTOL, atol=MODULE_ATOL)
    np.testing.assert_array_equal(got["classes"].numpy(), want["classes"])
    assert (got["classes"].numpy()[:, 4:] == -1).all()
    tol = MODULE_RTOL if dtype == "fp32" else 1e-2  # bf16 class probabilities
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# The tiny model with retrieval, end to end


def _jax_model(cls=JaxHybridVisionSystem, **kw):
    return cls(num_classes=NUM_CLASSES, dtype=jnp.float32, use_rag=True, rag_classes=SHAPES,
               **TINY, **kw)


def _port_model(cls=HybridVisionSystem, **kw):
    return cls(num_classes=NUM_CLASSES, dtype=torch.float32, device="cpu", use_rag=True,
               rag_classes=SHAPES, **TINY, **kw)


@pytest.fixture(scope="module")
def rag_jax_run():
    """The tiny JAX model with retrieval, its weights (``rag_gate`` = GATE),
    one synthetic batch, and in one jit: the serve model's raw head outputs,
    the training model's deterministic forward, and the loss and gradients
    of its train step (as ``tests/test_torch_train.py`` composes it)."""
    jm = _jax_model(monitor=True)
    serve = _jax_model(JaxProductionHybridVision)
    batch = next(make_synthetic_loader(2, IMAGE, 1, NUM_CLASSES, 8, seed=3)())
    images = jnp.asarray(batch["images"])
    params = jax.device_get(jax.jit(functools.partial(jm.init, task="detection"))(
        jax.random.PRNGKey(0), images)["params"])
    params["rag_gate"] = np.float32(GATE)
    cfg = JaxTrainerConfig(num_classes=NUM_CLASSES, sk_iters=20)
    sizes = [(IMAGE // s, IMAGE // s) for s in (8, 16, 32)]

    @jax.jit
    def run(params, batch):
        served = serve.apply({"params": params,
                              "constraints": jax_constraints(params, TINY["sk_iters"])},
                             batch["images"], task="detection")["detection"]["raw"]
        targets = jlosses.build_targets(batch["boxes"], batch["labels"], batch["box_mask"],
                                        sizes, NUM_CLASSES)

        def loss_fn(p):
            out, _ = jm.apply({"params": p}, batch["images"], task="detection",
                              deterministic=True, mutable=["stability"])
            det_loss, _ = jlosses.mhc_yolo_loss(out["detection"]["raw"], targets, NUM_CLASSES)
            reg_loss, _ = jlosses.manifold_regularization_loss(p, sk_iters=cfg.sk_iters)
            return det_loss + cfg.manifold_reg_alpha * reg_loss, out["detection"]["raw"]

        (loss, raw), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return served, raw, {"loss": loss, "grad_norm": jax_global_norm(grads)}, grads

    served, raw, metrics, grads = jax.device_get(
        run(params, {k: jnp.asarray(v) for k, v in batch.items()}))
    return dict(params=params, batch=batch, served=served, raw=raw, metrics=metrics,
                grads=grads)


def test_rag_model_serve_forward_matches_jax(rag_jax_run):
    run = rag_jax_run
    port = _port_model(ProductionHybridVision)
    det = Detector(port, run["params"], device="cpu")
    assert float(port.rag_gate.detach()) == GATE
    with torch.inference_mode():
        out = det.model(torch.from_numpy(run["batch"]["images"]))
    assert out["fused_features"]["fused_small"].dtype == torch.float32  # the gate's promotion
    for key, want in run["served"].items():
        _close(out["detection"]["raw"][key].numpy(), want, msg=key)


def test_rag_model_validation_forward_and_train_step_match_jax(rag_jax_run):
    run = rag_jax_run
    model = _port_model(monitor=True)
    load_flax_params(model, run["params"])
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    model.eval()
    with torch.no_grad():
        raw = model(torch.from_numpy(run["batch"]["images"]))["detection"]["raw"]
    for key, want in run["raw"].items():
        _close(raw[key].numpy(), want, msg=key)

    trainer = ManifoldConstrainedTrainer(
        model, TrainerConfig(num_classes=NUM_CLASSES, sk_iters=20), device="cpu")
    trainer.init_state()
    metrics, grads = train_step(trainer.model, trainer.tx, trainer.config, trainer.state,
                                batch_to(run["batch"], torch.device("cpu")))
    for k, v in run["metrics"].items():
        _close(float(metrics[k]), float(v), msg=k)
    want_g = {k: g for k, g in flatten(run["grads"]).items()
              if k.startswith("rag.") or k == "rag_gate"}
    assert "rag_gate" in want_g and len(want_g) == 26 and abs(float(want_g["rag_gate"])) > 0
    for name, g in want_g.items():
        _close(to_flax_layout(name, grads[name].numpy()), g, msg=name)


def test_rag_converter_round_trip(rag_jax_run):
    """The JAX tree (rag parameters and the scalar gate, no knowledge base)
    onto the port and back, bitwise."""
    params = rag_jax_run["params"]
    model = _port_model()
    load_flax_params(model, params)
    back = flatten(export_flax_params(model))
    want = flatten(params)
    assert set(back) == set(want) and "rag.kb" not in back
    assert {k for k in want if k.startswith("rag.")} == {
        f"rag.{m}.{p}" for m in ("query_proj", "knowledge_proj", "xq", "xk", "xv", "concat_proj")
        for p in ("kernel", "bias")} | {f"rag.out_norm.{p}" for p in ("scale", "bias")} | {
        f"rag.mhc_fuse.{p}" for p in (
            "H_pre_raw", "H_post_raw", "H_res_raw", "mlp_in_kernel", "mlp_in_bias",
            "mlp_out_kernel", "mlp_out_bias", "norm_pre_scale", "norm_pre_bias",
            "norm_post_scale", "norm_post_bias")}
    for k, v in want.items():
        assert back[k].tobytes() == np.asarray(v, np.float32).tobytes(), k
    assert "rag.kb" not in model.state_dict()


def _engine_configs():
    jm = tiny_model_config()
    jm.precision = "fp32"
    jm.rag.enabled, jm.rag.class_names = True, SHAPES
    ji = tiny_inference_config()
    ji.postprocessing.score_threshold = 0.25
    pm = from_dict(ModelConfig, {**json.loads(json.dumps(jm.to_dict())), "device": "cpu"})
    pi = from_dict(InferenceConfig, {**json.loads(json.dumps(ji.to_dict())), "device": "cpu"})
    pi.performance.batch_buckets = tuple(ji.performance.batch_buckets)
    return jm, ji, pm, pi


def test_rag_engine_detections_match_jax_engine():
    """The JAX engine tests' tiny config with ``rag.enabled`` and the shapes
    classes, fp32, the head conditioned as in ``tests/test_torch_engine.py``:
    the same frames through both engines at bucket 2."""
    jm, ji, pm, pi = _engine_configs()
    jax_model = jm.build_model(production=True)
    v = jax.jit(functools.partial(jax_model.init, task="detection"))(
        jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3), jnp.float32))
    params = jax.device_get(v["params"])
    params["rag_gate"] = np.float32(GATE)
    r = np.random.default_rng(1)
    for head in params["detection_head"].values():
        pred = head["predict"]
        pred["kernel"] = (pred["kernel"] * 4.0).astype(np.float32)
        bias = np.array(pred["bias"]).reshape(3, -1)
        bias[:, 4] = 1.0
        bias[:, 5:] = r.standard_normal(bias[:, 5:].shape)
        pred["bias"] = bias.reshape(-1).astype(np.float32)
    j = JaxEngine(jm, ji, variables={"params": params})
    p = InferenceEngine(pm, pi, variables={"params": params})
    assert p.model.rag is not None and tuple(p.model.rag.kb.shape) == (13, 128)
    images = [np.random.default_rng(5 + i).integers(0, 256, (IMAGE, IMAGE, 3), dtype=np.uint8)
              for i in range(2)]
    jh, ph = j.dispatch_batch(images), p.dispatch_batch(images)
    want, got = np.asarray(jh["device"]), ph["out"].numpy().copy()
    np.testing.assert_array_equal(got[:, 0, 6], want[:, 0, 6])  # detections per image
    assert want[:, 0, 6].sum() >= 4
    np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_allclose(got[..., :5], want[..., :5], rtol=RTOL, atol=ATOL)
    for w, g in zip(j.finalize_batch(jh), p.finalize_batch(ph)):
        np.testing.assert_array_equal(g.classes, w.classes)


def test_rag_site_stays_bf16_in_every_int8_variant():
    """JAX's knowledge module takes no ``act_quant`` and no ``quant_calib``:
    in every int8 variant its mHC layer stays a bf16 kernel-A site and no rag
    site is calibrated."""
    cfg = ModelConfig(device="cpu")
    cfg.rag.enabled = True
    q = cfg.quantization
    q.enabled = q.quantize_fpn = q.quantize_mhc = q.quantize_vit = True
    model = cfg.build_model(production=True)
    assert model.backbone.act_quant and model.fpn.act_quant
    fuse = model.rag.mhc_fuse
    assert fuse.fused and not fuse.int8 and fuse.quant_sites == fuse.quant_reads == ()
    assert not any(n.startswith("rag.") for n in quant_site_names(model))


def test_rag_export_adds_one_kernel_a_call(tmp_path):
    """``python -m hvs_tpu_torch.export_model --model-config`` with
    ``rag.enabled``: the tiny model's only kernel-A width is the knowledge
    module's (d = 256), one ``hvs::mhc_block`` call in the program."""
    from hvs_tpu_torch import export_model
    from hvs_tpu_torch.deployment.model_server import ModelExporter

    path = tmp_path / "model.json"
    path.write_text(json.dumps({"rag": {"enabled": True, "class_names": list(SHAPES)}}))
    mcfg = export_model.model_config(str(path), "cpu")
    export_model.tiny_configs(mcfg, InferenceConfig(device="cpu"), IMAGE)
    fused = [n for n, m in mcfg.build_model(production=True).named_modules()
             if isinstance(m, ManifoldHyperConnection) and m.fused]
    assert fused == ["rag.mhc_fuse"]
    report = export_model.main(["--tiny", "--device", "cpu", "--format", "pt2",
                                "--model-config", str(path), "--output", str(tmp_path)])
    assert report["pt2"]["consistency"]["consistent"], report
    program = ModelExporter.load_program(str(tmp_path / "model.pt2"))
    assert sum("hvs.mhc_block" in str(n.target) for n in program.graph.nodes) == 1


def test_train_takes_the_retrieval_model_from_its_model_config(tmp_path):
    """``python -m hvs_tpu_torch.train --model-config``: the file's ``rag``
    block trains the retrieval model, as ``scripts/train.py`` takes it."""
    from hvs_tpu_torch import train

    path = tmp_path / "model.json"
    path.write_text(json.dumps({"rag": {"enabled": True, "class_names": list(SHAPES)}}))
    train.main(["--synthetic", "--tiny", "--steps", "2", "--epochs", "1", "--device", "cpu",
                "--num-classes", "8", "--model-config", str(path), "--checkpoint-dir",
                str(tmp_path / "ckpt"), "--log-dir", str(tmp_path / "logs")])
    saved = sorted((tmp_path / "ckpt").glob("*.pt"))
    assert saved
    params = torch.load(saved[-1], map_location="cpu")["params"]
    assert "rag_gate" in params and params["rag.query_proj.kernel"].shape == (256, 128)


def test_train_device_use_rag_checkpoint_scored_by_evaluate_use_rag(tmp_path):
    from hvs_tpu_torch import evaluate, train_device

    root = str(tmp_path / "shapes")
    generate_shapes_dataset(root, num_train=8, num_val=4, size=IMAGE, seed=0)
    run = tmp_path / "run"
    summary = train_device.main(["--data-root", root, "--num-classes", "8", "--use-rag",
                                 "--tiny", "--device", "cpu", "--total-steps", "2",
                                 "--chunk-steps", "2", "--run-dir", str(run)])
    assert summary["steps"] == 2
    ckpt = str(run / "checkpoints" / "final")
    flags = ["--data-root", root, "--split", "val", "--tiny", "--device", "cpu",
             "--checkpoint", ckpt, "--image-size", str(IMAGE)]
    report = evaluate.main([*flags, "--use-rag", "--output", str(tmp_path / "eval.json")])
    assert 0.0 <= report["accuracy"]["mAP@0.5"] <= 1.0
    assert json.loads((tmp_path / "eval.json").read_text())["accuracy"] == report["accuracy"]
    with pytest.raises(KeyError, match="rag"):  # without the retrieval path it cannot load
        evaluate.main([*flags, "--output", str(tmp_path / "plain.json")])
