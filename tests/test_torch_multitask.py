"""The port's multi-task model family against the JAX package on the CPU:
the transposed convolution, the segmentation and depth heads, the model's
tasks and flags, ``multi_task_loss`` with its gradients, the parameter trees
at full width, and the multi-task train step and evaluation as
``scripts/train_multitask.py`` builds them (tiny model, fp32, dropout off on
both sides).
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from hvs_tpu.config import ModelConfig as JaxModelConfig
from hvs_tpu.constants import IMAGENET_MEAN, IMAGENET_STD
from hvs_tpu.models import HybridVisionSystem as JaxHybridVisionSystem
from hvs_tpu.models.hybrid import DepthHead as JaxDepthHead
from hvs_tpu.models.hybrid import SegmentationHead as JaxSegmentationHead
from hvs_tpu.training import losses as jlosses
from hvs_tpu.training.optimizer import make_optimizer
from hvs_tpu.training.schedule import cosine_annealing_with_warmup
from hvs_tpu_torch.convert import (export_flax_params, flatten, load_flax_params, nest,
                                   to_flax_layout)
from hvs_tpu_torch.data import put_dense_data
from hvs_tpu_torch.models import DepthHead, HybridVisionSystem, SegmentationHead
from hvs_tpu_torch.models.hybrid import TASKS
from hvs_tpu_torch.models.layers import ConvTranspose, Dropout
from hvs_tpu_torch.train import TINY
from hvs_tpu_torch.train_multitask import model_config, synthetic_dense_arrays
from hvs_tpu_torch.training import MultiTaskChunk, MultiTaskEval, multi_task_loss
from hvs_tpu_torch.training.trainer import ManifoldConstrainedTrainer, TrainerConfig

torch.set_num_threads(1)

# tests/test_torch_train.py's end-to-end tolerance (fp32 through the model,
# sums in other orders in XLA and PyTorch).
RTOL, ATOL = 2e-3, 5e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


def _load(module, params):
    load_flax_params(module, jax.device_get(params))
    return module


# ---------------------------------------------------------------------------
# Transposed convolution and the heads


@pytest.mark.parametrize("h,w", [(5, 7), (8, 8)])
def test_conv_transpose_matches_flax(h, w):
    x = np.random.default_rng(h * w).standard_normal((2, h, w, 6)).astype(np.float32)
    flax_conv = fnn.ConvTranspose(5, (4, 4), strides=(2, 2), dtype=jnp.float32)
    params = flax_conv.init(jax.random.PRNGKey(h), jnp.asarray(x))["params"]
    params = {"kernel": params["kernel"],
              "bias": 0.1 * jax.random.normal(jax.random.PRNGKey(1), (5,))}
    want = flax_conv.apply({"params": params}, jnp.asarray(x))
    # Under its flax auto-name, as in the heads (the converter keys on it).
    port = torch.nn.Module()
    port.ConvTranspose_0 = ConvTranspose(6, 5, dtype=torch.float32)
    _load(port, {"ConvTranspose_0": params})
    got = port.ConvTranspose_0(_t(x))
    assert got.shape == (2, 2 * h, 2 * w, 5) == want.shape
    _close(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    # The kernel keeps flax's HWIO layout both ways.
    np.testing.assert_array_equal(export_flax_params(port)["ConvTranspose_0"]["kernel"],
                                  params["kernel"])


def _fused_maps(seed, channels=(16, 24, 32), sizes=((5, 7), (3, 4), (2, 2))):
    r = np.random.default_rng(seed)
    return {name: r.standard_normal((2, h, w, c)).astype(np.float32)
            for name, c, (h, w) in zip(("fused_small", "fused_medium", "fused_large"),
                                       channels, sizes)}


def _perturbed(params, seed):
    """Non-trivial GroupNorm affines and biases (flax inits them to 1 and 0)."""
    flat = flatten(jax.device_get(params))
    r = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        if k.endswith("scale"):
            v = v + 0.2 * r.standard_normal(v.shape).astype(np.float32)
        elif k.endswith("bias"):
            v = v + 0.1 * r.standard_normal(v.shape).astype(np.float32)
        out[k] = v
    return nest(out)


@pytest.mark.parametrize("form", ["multi_scale", "single_map"])
def test_segmentation_head_matches_jax(form):
    maps = _fused_maps(3)
    head = JaxSegmentationHead(num_classes=5, dtype=jnp.float32)
    if form == "multi_scale":
        jin = {k: jnp.asarray(v) for k, v in maps.items()}
        port = SegmentationHead((16, 24, 32), 5, dtype=torch.float32)
        tin = {k: _t(v) for k, v in maps.items()}
    else:
        jin = jnp.asarray(maps["fused_medium"])
        port = SegmentationHead(24, 5, dtype=torch.float32)
        tin = _t(maps["fused_medium"])
    params = _perturbed(head.init(jax.random.PRNGKey(0), jin)["params"], 1)
    want = head.apply({"params": params}, jin)
    got = _load(port, params)(tin)
    assert got.shape == want.shape
    _close(got.detach().numpy(), want, rtol=1e-4, atol=1e-4)


def test_depth_head_matches_jax():
    x = _fused_maps(4)["fused_small"]
    head = JaxDepthHead(dtype=jnp.float32)
    params = _perturbed(head.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"], 2)
    want = head.apply({"params": params}, jnp.asarray(x))
    got = _load(DepthHead(16, dtype=torch.float32), params)(_t(x))
    assert got.shape == want.shape == (2, 20, 28, 1)
    assert bool((got > 0).all())
    _close(got.detach().numpy(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The model: every task, fp32, against JAX

MODEL = dict(num_classes=3, use_segmentation=True, use_depth=True, **TINY)
IMG = 64


@pytest.fixture(scope="module")
def jax_multitask():
    jm = JaxHybridVisionSystem(dtype=jnp.float32, **MODEL)
    x = np.random.default_rng(5).uniform(size=(2, IMG, IMG, 3)).astype(np.float32)
    params = jax.jit(functools.partial(jm.init, task="multi_task"))(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3), jnp.float32))["params"]
    params = jax.device_get(params)
    out = jax.device_get(jax.jit(functools.partial(jm.apply, task="multi_task"))(
        {"params": params}, jnp.asarray(x)))
    # The keys and shapes of every other task (a trace, no compile).
    shapes = {task: jax.eval_shape(functools.partial(jm.apply, task=task),
                                   {"params": params}, jnp.asarray(x)) for task in TASKS}
    return dict(params=params, x=x, out=out, shapes=shapes)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def test_multi_task_model_matches_jax_for_every_task(jax_multitask):
    want = jax_multitask
    port = HybridVisionSystem(dtype=torch.float32, device="cpu", task="multi_task", **MODEL)
    load_flax_params(port, want["params"])
    # Through the converter and back, bit for bit.
    back = flatten(export_flax_params(port))
    assert set(back) == set(flatten(want["params"]))
    for name, a in flatten(want["params"]).items():
        np.testing.assert_array_equal(back[name], a, err_msg=name)
    port.eval()
    ref = _leaves(want["out"])
    with torch.no_grad():
        for task in TASKS:
            got = _leaves(jax.tree_util.tree_map(
                lambda t: t.numpy(), port(_t(want["x"]), task=task)))
            shapes = _leaves(want["shapes"][task])
            assert set(got) == set(shapes), task
            for key, value in got.items():
                assert value.shape == shapes[key].shape, (task, key)
                _close(value, ref[key], msg=f"{task}: {key}")


def test_a_head_the_model_was_not_built_for_raises():
    port = HybridVisionSystem(dtype=torch.float32, device="cpu", **MODEL)
    assert port.segmentation_head is None and port.classifier is None
    x = torch.zeros(1, IMG, IMG, 3)
    with pytest.raises(ValueError, match="no segmentation_head"):
        port(x, task="segmentation")
    with pytest.raises(ValueError, match="task must be one of"):
        port(x, task="everything")
    out = port(x)  # the detection task
    assert set(out) == {"detection", "features", "fused_features"}


# ---------------------------------------------------------------------------
# multi_task_loss and its gradients


def _seg_case(name):
    """The four cases of tests/test_multitask_loss.py: (logits, labels, k)."""
    if name == "rare_class":
        labels = np.zeros((1, 32, 32), np.int32)
        labels[0, :2, :8] = 1
        logits = np.full((1, 32, 32, 3), -10.0, np.float32)
        logits[..., 0] = 10.0
        return logits, labels
    if name == "perfect":
        labels = np.random.default_rng(0).integers(0, 4, (2, 16, 16)).astype(np.int32)
        logits = np.stack([np.where(labels == c, 20.0, -20.0) for c in range(4)], -1)
        return logits.astype(np.float32), labels
    if name == "downsampled":
        labels = np.random.default_rng(1).integers(0, 3, (1, 64, 64)).astype(np.int32)
        logits = np.random.default_rng(2).standard_normal((1, 32, 32, 3)).astype(np.float32)
        return logits, labels
    labels = np.zeros((1, 16, 16), np.int32)  # absent classes: only background
    logits = np.random.default_rng(3).standard_normal((1, 16, 16, 5)).astype(np.float32)
    return logits, labels


def _grad_pair(jax_loss, torch_loss, arrays):
    """Value and gradient w.r.t. every array, JAX against the port."""
    jv, jg = jax.value_and_grad(lambda a: jax_loss(a)[0])([jnp.asarray(a) for a in arrays])
    ts = [_t(a).requires_grad_() for a in arrays]
    tv, tm = torch_loss(ts)
    tg = torch.autograd.grad(tv, ts)
    tv, tm = float(tv.detach()), {k: float(v.detach()) for k, v in tm.items()}
    _, jm = jax_loss([jnp.asarray(a) for a in arrays])
    return (float(jv), jax.device_get(jm), jg), (tv, tm, tg)


@pytest.mark.parametrize("case", ["rare_class", "perfect", "downsampled", "absent_class"])
def test_multi_task_loss_segmentation_matches_jax(case):
    logits, labels = _seg_case(case)
    k = logits.shape[-1]
    (jv, jm, jg), (tv, tm, tg) = _grad_pair(
        lambda a: jlosses.multi_task_loss({"segmentation": a[0]},
                                          {"seg_labels": jnp.asarray(labels)}, k - 1),
        lambda a: multi_task_loss({"segmentation": a[0]}, {"seg_labels": _t(labels)}, k - 1),
        [logits])
    _close(tv, jv, rtol=1e-5, atol=1e-6)
    for key in ("segmentation_loss", "segmentation_dice_loss", "total_loss"):
        _close(float(tm[key]), float(jm[key]), rtol=1e-5, atol=1e-6, msg=key)
    assert tg[0].shape == logits.shape and bool(torch.isfinite(tg[0]).all())
    _close(tg[0].numpy(), jg[0], rtol=1e-4, atol=1e-7)
    if case == "rare_class":  # the weighting the JAX test checks
        assert 0.0 < float(tm["segmentation_loss"])


def test_multi_task_loss_every_term_matches_jax():
    """Detection (targets from build_targets), classification, segmentation
    at stride 2 and depth at stride 2, with their gradients."""
    r = np.random.default_rng(7)
    b, nc = 2, 3
    grids = [(8, 8), (4, 4), (2, 2)]
    raw = [r.standard_normal((b, h, w, 3, 5 + nc)).astype(np.float32) for h, w in grids]
    wh = r.uniform(0.1, 0.5, (b, 5, 2))
    boxes = np.concatenate([r.uniform(wh / 2, 1 - wh / 2), wh], -1).astype(np.float32)
    labels = r.integers(0, nc, (b, 5)).astype(np.int32)
    mask = (r.uniform(size=(b, 5)) > 0.3).astype(np.float32)
    cls_logits = r.standard_normal((b, nc)).astype(np.float32)
    cls_labels = r.integers(0, nc, b).astype(np.int32)
    seg = r.standard_normal((b, 16, 16, nc + 1)).astype(np.float32)
    seg_labels = r.integers(0, nc + 1, (b, 32, 32)).astype(np.int32)
    depth = np.log1p(np.exp(r.standard_normal((b, 16, 16, 1)))).astype(np.float32)
    depth_gt = r.uniform(0.5, 10.0, (b, 32, 32)).astype(np.float32)
    keys = ("fused_small", "fused_medium", "fused_large")
    jt = jlosses.build_targets(jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask),
                               grids, nc)
    from hvs_tpu_torch.training.losses import build_targets

    tt = build_targets(_t(boxes), _t(labels), _t(mask), grids, nc)

    def jax_loss(a):
        out = {"detection": {"raw": dict(zip(keys, a[:3]))}, "classification": a[3],
               "segmentation": a[4], "depth": a[5]}
        return jlosses.multi_task_loss(out, {
            "targets": jt, "class_labels": jnp.asarray(cls_labels),
            "seg_labels": jnp.asarray(seg_labels), "depth": jnp.asarray(depth_gt)}, nc)

    def torch_loss(a):
        out = {"detection": {"raw": dict(zip(keys, a[:3]))}, "classification": a[3],
               "segmentation": a[4], "depth": a[5]}
        return multi_task_loss(out, {
            "targets": tt, "class_labels": _t(cls_labels), "seg_labels": _t(seg_labels),
            "depth": _t(depth_gt)}, nc)

    (jv, jm, jg), (tv, tm, tg) = _grad_pair(jax_loss, torch_loss,
                                            raw + [cls_logits, seg, depth])
    assert set(tm) == set(jm)
    _close(tv, jv, rtol=1e-5, atol=1e-5)
    for key in jm:
        _close(float(tm[key]), float(jm[key]), rtol=1e-5, atol=1e-5, msg=key)
    for i, (got, want) in enumerate(zip(tg, jg)):
        _close(got.numpy(), want, rtol=1e-4, atol=1e-6, msg=f"gradient {i}")


# ---------------------------------------------------------------------------
# Parameter trees at full width (traced, not compiled)


def test_full_width_multi_task_parameters_match_jax():
    import chip_smoke

    jm = JaxHybridVisionSystem(num_classes=8, use_segmentation=True, use_depth=True)
    want = jax.eval_shape(functools.partial(jm.init, task="multi_task"), jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3)))["params"]
    want = {k.replace("/", "."): tuple(v.shape) for k, v in _leaves(want).items()}
    port = HybridVisionSystem(num_classes=8, use_segmentation=True, use_depth=True,
                              task="multi_task", device="cpu")
    got = {k: tuple(v.shape) for k, v in flatten(export_flax_params(port)).items()}
    assert got == want
    assert sum(int(np.prod(s)) for s in want.values()) == chip_smoke.MULTITASK_PARAMS


# ---------------------------------------------------------------------------
# The train step and evaluation of scripts/train_multitask.py

NC, S, N, NV, B, K = 8, 64, 6, 4, 2, 3


def _jax_tiny_config():
    """scripts/train_multitask.py --tiny's model config."""
    mcfg = JaxModelConfig()
    mcfg.detection.num_classes = NC
    mcfg.use_segmentation = mcfg.use_depth = True
    mcfg.backbone.base_channels = 8
    mcfg.backbone.stage_channels = (16, 24, 32, 40)
    mcfg.backbone.stage_blocks = (1, 1, 1, 1)
    mcfg.vit.dim, mcfg.vit.depth, mcfg.vit.num_heads = 16, 1, 2
    mcfg.fusion.fpn_channels = 16
    mcfg.fusion.out_channels = (16, 24, 32)
    mcfg.detection.head_channels = 16
    mcfg.mhc.sinkhorn_iterations = 3
    mcfg.precision = "fp32"
    return mcfg


@pytest.fixture(scope="module")
def jax_multitask_run():
    """K steps of the script's ``loss_fn`` + optimizer on given indices
    (deterministic forward), then its ``evaluate`` on the validation split."""
    jm = _jax_tiny_config().build_model(monitor=False)
    train = synthetic_dense_arrays(N, S, 4, NC, seed=0)
    val = synthetic_dense_arrays(NV, S, 4, NC, seed=1)
    params = jax.device_get(jax.jit(lambda k, x: jm.init(k, x, task="multi_task"))(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3), jnp.float32))["params"])
    tx = make_optimizer(cosine_annealing_with_warmup(1e-3, 2, 50))
    mean, std = jnp.asarray(IMAGENET_MEAN, jnp.float32), jnp.asarray(IMAGENET_STD, jnp.float32)

    def batch_from(data, idx):
        images, boxes, labels, bmask, seg, depth = data
        grids = [(S // 8, S // 8), (S // 16, S // 16), (S // 32, S // 32)]
        return {"images": (images[idx].astype(jnp.float32) / 255.0 - mean) / std,
                "targets": jlosses.build_targets(boxes[idx], labels[idx], bmask[idx], grids, NC),
                "seg_labels": seg[idx].astype(jnp.int32), "depth": depth[idx]}

    def loss_fn(p, data, idx):
        batch = batch_from(data, idx)
        outputs = jm.apply({"params": p}, batch["images"], task="multi_task")
        total, metrics = jlosses.multi_task_loss(outputs, batch, NC)
        reg, _ = jlosses.manifold_regularization_loss(p, sk_iters=20)
        return total + 0.01 * reg, metrics

    @jax.jit
    def step(p, opt_state, data, idx):
        (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, data, idx)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, {**metrics, "loss": loss}

    @jax.jit
    def evaluate(p, data):
        idx = jnp.arange((NV // B) * B).reshape(-1, B)

        def body(acc, ids):
            batch = batch_from(data, ids)
            out = jm.apply({"params": p}, batch["images"], task="multi_task")
            _, metrics = jlosses.multi_task_loss(out, batch, NC)
            logits = out["segmentation"].astype(jnp.float32)
            lab = batch["seg_labels"]
            fy = lab.shape[1] // logits.shape[1]
            lab = lab[:, ::fy, ::fy][:, : logits.shape[1], : logits.shape[2]]
            pred = jnp.argmax(logits, -1)
            acc_pix = jnp.mean((pred == lab).astype(jnp.float32))
            inter = jnp.stack([jnp.sum((pred == c) & (lab == c)) for c in range(NC + 1)])
            union = jnp.stack([jnp.sum((pred == c) | (lab == c)) for c in range(NC + 1)])
            dpred = out["depth"].astype(jnp.float32)[..., 0]
            dgt = batch["depth"][:, ::fy, ::fy][:, : dpred.shape[1], : dpred.shape[2]]
            absrel = jnp.mean(jnp.abs(dpred - dgt) / (dgt + 1e-3))
            return acc + jnp.stack([metrics["detection_loss"], metrics["segmentation_loss"],
                                    metrics["depth_loss"], acc_pix, absrel]), (inter, union)

        totals, (inters, unions) = jax.lax.scan(body, jnp.zeros(5), idx)
        return totals / idx.shape[0], jnp.sum(inters, 0) / jnp.maximum(jnp.sum(unions, 0), 1)

    jtrain = [jnp.asarray(a) for a in train]
    indices = [np.random.default_rng(10 + i).integers(0, N, B) for i in range(K)]
    p, opt_state, rows = params, tx.init(params), []
    for idx in indices:
        p, opt_state, metrics = step(p, opt_state, jtrain, jnp.asarray(idx))
        rows.append(jax.device_get(metrics))
    means, iou = evaluate(p, [jnp.asarray(a) for a in val])
    return dict(params=params, train=train, val=val, indices=indices, rows=rows,
                final=jax.device_get(p), means=np.asarray(means), iou=np.asarray(iou))


def test_multi_task_chunk_and_evaluation_match_the_jax_script(jax_multitask_run):
    want = jax_multitask_run
    cfg = model_config(True, torch.device("cpu"))
    cfg.precision = "fp32"
    model = cfg.build_model(task="multi_task")
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.rate = 0.0
    load_flax_params(model, want["params"])
    trainer = ManifoldConstrainedTrainer(
        model, TrainerConfig(num_classes=NC, warmup_steps=2, total_steps=50), device="cpu")
    trainer.init_state()
    chunk = MultiTaskChunk(trainer, put_dense_data(*want["train"], device="cpu"), B, K)
    assert chunk.graph is None and chunk.task == "multi_task"
    for idx in want["indices"]:
        chunk.step(_t(idx).long())
    host = chunk.pull()
    for i, row in enumerate(want["rows"]):
        for key, value in row.items():
            _close(host[key][i], float(value), msg=f"step {i}: {key}")
    for name, p in flatten(want["final"]).items():
        _close(to_flax_layout(name, trainer.params()[name].detach().numpy()), p, msg=name)

    evaluator = MultiTaskEval(trainer, put_dense_data(*want["val"], device="cpu"), B)
    means, iou = evaluator.run()
    assert evaluator.pulls == 1 and evaluator.n_batches == NV // B
    keys = ("detection_loss", "segmentation_loss", "depth_loss", "seg_pixel_acc",
            "depth_abs_rel")
    _close([means[k] for k in keys], want["means"], msg="evaluation means")
    _close(iou, want["iou"], msg="per-class IoU")
    _close(means["seg_miou"], float(np.mean(want["iou"])))


def test_synthetic_dense_arrays_follow_the_shapes_format():
    images, boxes, labels, mask, seg, depth = synthetic_dense_arrays(4, 64, 6, NC, seed=3)
    assert images.dtype == np.uint8 and seg.dtype == np.uint8 and depth.dtype == np.float32
    assert seg.shape == depth.shape == (4, 64, 64)
    assert seg.max() <= NC and (depth[seg == 0] == 10.0).all()
    assert ((depth[seg > 0] >= 0.5) & (depth[seg > 0] <= 9.5)).all()
    # The last real box of an image is on top at its centre.
    for i in range(4):
        j = int(np.flatnonzero(mask[i])[-1])
        cx, cy = (boxes[i, j, :2] * 64).astype(int)
        assert seg[i, cy, cx] == labels[i, j] + 1


def test_train_multitask_entry_point_on_cpu(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root)
    out_path = tmp_path / "report.json"
    subprocess.run(
        [sys.executable, "-m", "hvs_tpu_torch.train_multitask", "--synthetic", "4", "--tiny",
         "--device", "cpu", "--steps", "4", "--chunk-steps", "2", "--size", "64",
         "--num-val", "4", "--batch-size", "2", "--output", str(out_path)],
        capture_output=True, text=True, timeout=600, env=env, check=True, cwd=root)
    report = json.loads(out_path.read_text())
    assert {"before", "after", "steps_per_sec", "params"} <= set(report)
    for side in ("before", "after"):
        assert set(report[side]) >= {"detection_loss", "segmentation_loss", "depth_loss",
                                     "seg_pixel_acc", "depth_abs_rel", "seg_miou"}
        assert np.isfinite(list(v for v in report[side].values() if np.isscalar(v))).all()
    assert len(report["after"]["seg_iou_per_class"]) == NC + 1


def test_train_multitask_raises_for_what_is_not_ported(tmp_path):
    from hvs_tpu_torch.data import generate_shapes_dataset
    from hvs_tpu_torch.train_multitask import main

    # --data-root is read with its dense labels; a dataset without them raises
    generate_shapes_dataset(str(tmp_path), num_train=1, num_val=1, size=64)
    with pytest.raises(FileNotFoundError, match="masks"):
        main(["--data-root", str(tmp_path), "--device", "cpu", "--tiny"])
