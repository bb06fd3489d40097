"""The port's training path (hvs_tpu_torch.training) against the JAX package's,
on the CPU.

Losses, schedules and the optimizer are held against their JAX functions on
the same numpy inputs. The train step is held against a JAX loss composed as
``hvs_tpu/training/trainer.py`` composes it (model forward with the
``stability`` collection, ``build_targets``, ``mhc_yolo_loss``,
``manifold_regularization_loss``, ``jax.value_and_grad``, the optax chain of
``make_optimizer``) on the tiny model of ``scripts/train.py --tiny`` in fp32
at 64², batch 2, dropout off on both sides; ``validate`` against
``make_eval_step``. On the CPU every Sinkhorn and mHC block runs its plain
version; the kernels are held against those on the card.
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hvs_tpu.models import HybridVisionSystem as JaxHybridVisionSystem
from hvs_tpu.training import losses as jlosses
from hvs_tpu.training import schedule as jschedule
from hvs_tpu.training.optimizer import make_optimizer
from hvs_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from hvs_tpu.training.trainer import global_norm as jax_global_norm
from hvs_tpu.training.trainer import make_eval_step
from hvs_tpu_torch.convert import flatten, load_flax_params, nest, to_flax_layout
from hvs_tpu_torch.models import HybridVisionSystem
from hvs_tpu_torch.models.layers import Dropout, ManifoldHyperConnection
from hvs_tpu_torch.ops.sinkhorn import sinkhorn_log_plain as tsink_plain
from hvs_tpu_torch.train import TINY, make_synthetic_loader
from hvs_tpu_torch.training import losses as tlosses
from hvs_tpu_torch.training import schedule as tschedule
from hvs_tpu_torch.training.optimizer import ManifoldAwareOptimizer, partition_label
from hvs_tpu_torch.training.trainer import (ManifoldConstrainedTrainer, TrainerConfig,
                                            batch_to, train_step)

torch.set_num_threads(1)

# The serve path's end-to-end tolerance (tests/test_torch_serve.py): fp32
# through the whole model, with sums reassociated differently in XLA and
# PyTorch (convolutions, GroupNorm statistics, the exp of the box decode).
RTOL, ATOL = 2e-3, 5e-3
NUM_CLASSES = 8
IMAGE = 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# Losses


def _gt(batch, m, seed):
    r = np.random.default_rng(seed)
    boxes = np.clip(r.uniform(0.1, 0.9, (batch, m, 4)), 0.05, 0.95).astype(np.float32)
    labels = r.integers(0, NUM_CLASSES, (batch, m)).astype(np.int32)
    mask = (r.uniform(size=(batch, m)) > 0.4).astype(np.float32)
    return boxes, labels, mask


def _assigned_cells(targets):
    return sum(int(np.asarray(t["obj"]).sum()) for t in targets.values())


GRIDS = [(8, 8), (4, 4), (2, 2)]


def test_build_targets_matches_jax():
    boxes, labels, mask = _gt(2, 6, seed=3)
    want = jlosses.build_targets(jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask),
                                 GRIDS, NUM_CLASSES)
    got = tlosses.build_targets(_t(boxes), _t(labels), _t(mask), GRIDS, NUM_CLASSES)
    # No two real boxes share a (cell, anchor): the JAX winner is then defined.
    assert _assigned_cells(want) == int(mask.sum())
    for key, w in want.items():
        for field in ("box", "obj", "cls"):
            np.testing.assert_array_equal(got[key][field].numpy(), np.asarray(w[field]),
                                          err_msg=f"{key}/{field}")


def test_build_targets_highest_slot_wins_a_collision():
    boxes = np.array([[[0.30, 0.30, 0.20, 0.20], [0.31, 0.32, 0.21, 0.19],
                       [0.70, 0.70, 0.20, 0.20]]], np.float32)
    labels = np.array([[1, 2, 3]], np.int32)
    mask = np.ones((1, 3), np.float32)
    got = tlosses.build_targets(_t(boxes), _t(labels), _t(mask), GRIDS, NUM_CLASSES)
    assert sum(int(t["obj"].sum()) for t in got.values()) == 2
    cls = np.concatenate([t["cls"].numpy()[t["obj"].numpy() > 0] for t in got.values()])
    assert sorted(cls.tolist()) == [2, 3]  # slot 1 beat slot 0 in their shared cell


@pytest.mark.parametrize("cls_mode,pos_weight", [("bce", 1.0), ("bce", 7.0), ("softmax", 1.0)])
def test_mhc_yolo_loss_matches_jax(cls_mode, pos_weight):
    boxes, labels, mask = _gt(2, 6, seed=4)
    r = np.random.default_rng(5)
    raw = {k: (1.5 * r.standard_normal((2, h, w, 3, 5 + NUM_CLASSES))).astype(np.float32)
           for k, (h, w) in zip(("fused_small", "fused_medium", "fused_large"), GRIDS)}
    jt = jlosses.build_targets(jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask),
                               GRIDS, NUM_CLASSES)
    want, want_m = jax.jit(functools.partial(
        jlosses.mhc_yolo_loss, num_classes=NUM_CLASSES, cls_mode=cls_mode,
        cls_pos_weight=pos_weight))({k: jnp.asarray(v) for k, v in raw.items()}, jt)

    tt = tlosses.build_targets(_t(boxes), _t(labels), _t(mask), GRIDS, NUM_CLASSES)
    traw = {k: _t(v).requires_grad_() for k, v in raw.items()}
    got, got_m = tlosses.mhc_yolo_loss(traw, tt, NUM_CLASSES, cls_mode=cls_mode,
                                       cls_pos_weight=pos_weight)
    _close(got.item(), float(want), rtol=1e-5, atol=1e-6)
    for k, v in want_m.items():
        _close(got_m[k].item(), float(v), rtol=1e-5, atol=1e-6, msg=k)
    # Gradients of the loss with respect to the raw head outputs.
    grad_fn = jax.jit(jax.grad(lambda rw: jlosses.mhc_yolo_loss(
        rw, jt, NUM_CLASSES, cls_mode=cls_mode, cls_pos_weight=pos_weight)[0]))
    want_g = grad_fn({k: jnp.asarray(v) for k, v in raw.items()})
    got.backward()
    for k in raw:
        g = np.asarray(want_g[k])
        _close(traw[k].grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max(), msg=k)


def _reg_params(seed):
    """A nested parameter tree with H_res_raw leaves of three widths (at the
    mHC init scale plus noise) and leaves the regulariser must ignore."""
    r = np.random.default_rng(seed)

    def h(n):
        limit = math.sqrt(3.0 * 0.1 / n)
        return (r.uniform(-limit, limit, (n, n)) + 0.5 * r.standard_normal((n, n))
                ).astype(np.float32)

    return {"backbone": {"mhc": {"H_res_raw": h(16), "H_pre_raw": h(16)}},
            "fpn": {"mhc0": {"H_res_raw": h(32)}},
            "mhc_features": {"H_res_raw": h(24), "mlp_in_kernel": h(24)}}


def test_manifold_regularization_loss_and_gradient_match_jax():
    tree = _reg_params(6)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    want, want_m = jax.jit(functools.partial(jlosses.manifold_regularization_loss,
                                             sk_iters=20))(jtree)
    want_g = jax.jit(jax.grad(lambda p: jlosses.manifold_regularization_loss(p, sk_iters=20)[0]
                              ))(jtree)
    params = {k: _t(v).requires_grad_() for k, v in flatten(tree).items()}
    assert [n for n, _ in tlosses.iter_h_res_leaves(params)] == [
        "backbone.mhc.H_res_raw", "fpn.mhc0.H_res_raw", "mhc_features.H_res_raw"]
    got, got_m = tlosses.manifold_regularization_loss(params, sk_iters=20)
    _close(got.item(), float(want), rtol=1e-5, atol=1e-8)
    for k, v in want_m.items():
        _close(got_m[k].item(), float(v), rtol=1e-5, atol=1e-8, msg=k)
    got.backward()
    for name, g in flatten(jax.device_get(want_g)).items():
        p = params[name]
        if g.any():
            _close(p.grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max(), msg=name)
        else:
            assert p.grad is None or not p.grad.any(), name


# ---------------------------------------------------------------------------
# Schedules


def test_schedules_match_jax():
    steps = [0, 1, 3, 10, 11, 37, 99, 100, 250]
    for warmup in (0, 10):
        want = jschedule.cosine_annealing_with_warmup(1e-3, warmup, 100)
        got = tschedule.cosine_annealing_with_warmup(1e-3, warmup, 100)
        for s in steps:
            # JAX evaluates the schedule in fp32, the port in fp64.
            _close(got(s), float(want(s)), rtol=1e-5, atol=0, msg=f"warmup {warmup} step {s}")
    losses = [5.0, 4.0, 4.0, 4.0, 3.9995, 4.1, 4.2, 2.0, 2.5, 2.5, 2.5, 2.5]
    jp = jschedule.PlateauSchedulerWithReset(patience=2, reset_after=2)
    tp = tschedule.PlateauSchedulerWithReset(patience=2, reset_after=2)
    assert [tp.step(v) for v in losses] == [jp.step(v) for v in losses]
    metrics = [{"grad_norm": 20.0}, {"grad_norm": 1.0}, {"ds_error_max": 0.5},
               {"max_eigenvalue": 1.2}, {}, {"grad_norm": 2.0, "ds_error_max": 1e-4}]
    jm, tm = jschedule.ManifoldAwareScheduler(), tschedule.ManifoldAwareScheduler()
    assert [tm.step(m) for m in metrics] == [jm.step(m) for m in metrics]


# ---------------------------------------------------------------------------
# Optimizer


def _opt_tree(seed):
    """Parameters covering every partition: backbone and other mHC scopes
    (square H_res_raw with tangent preconditioning and projection, a
    non-square H_pre_raw, mHC MLP and norm leaves) and regular leaves."""
    r = np.random.default_rng(seed)
    f = lambda *s: (0.3 * r.standard_normal(s)).astype(np.float32)  # noqa: E731
    return {
        "backbone": {"stem1": {"kernel": f(4, 3, 3, 3)},
                     "stage1_block0": {"mhc": {"H_res_raw": f(8, 8), "mlp_in_kernel": f(8, 8),
                                               "norm_pre_scale": f(8)}}},
        "fpn": {"mhc0": {"H_res_raw": f(12, 12), "H_pre_raw": f(12, 24)},
                "lateral0": {"kernel": f(6, 5)}},
        "vit_encoder": {"block0": {"mhc_ffn": {"mlp_out_bias": f(16)}}},
        "detection_head": {"head_small": {"predict": {"bias": f(7)}}},
    }


def test_optimizer_matches_optax_chain_with_projection_and_lr_scale():
    """Three updates with project_every=2 (the second is a projection step)
    and lr_scale 0.5 on that step; per-partition clipping fires on some
    steps. Parameters agree to rtol 1e-5."""
    tree = _opt_tree(7)
    kw = dict(weight_decay=0.05, mhc_lr_factor=0.5, clip_regular=1.0, clip_mhc=0.5,
              project_every=2, sk_iters=20, backbone_lr_factor=0.1)
    tx = make_optimizer(jschedule.cosine_annealing_with_warmup(0.05, 0, 10), **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = tx.init(jparams)

    @jax.jit
    def jstep(params, state, grads, lr_scale):
        updates, state = tx.update(grads, state, params)
        updates = jax.tree_util.tree_map(lambda u: u * lr_scale, updates)
        return optax.apply_updates(params, updates), state

    params = {k: torch.nn.Parameter(_t(v)) for k, v in flatten(tree).items()}
    labels = {partition_label(n, 0.1) for n in params}
    assert labels == {"regular", "backbone", "mhc", "mhc_backbone"}
    ttx = ManifoldAwareOptimizer(params, tschedule.cosine_annealing_with_warmup(0.05, 0, 10),
                                 **kw)
    r = np.random.default_rng(8)
    for step, (scale, gscale) in enumerate([(1.0, 3.0), (0.5, 0.05), (1.0, 1.0)]):
        grads = {k: (gscale * r.standard_normal(v.shape)).astype(np.float32)
                 for k, v in flatten(tree).items()}
        jparams, jstate = jstep(jparams, jstate, jax.tree_util.tree_map(jnp.asarray,
                                                                        nest(grads)),
                                jnp.float32(scale))
        ttx.step({k: _t(v) for k, v in grads.items()}, lr_scale=scale)
        for name, want in flatten(jax.device_get(jparams)).items():
            _close(params[name].detach().numpy(), want, rtol=1e-5, atol=1e-7,
                   msg=f"update {step + 1}: {name}")
    assert ttx.count == 3


# ---------------------------------------------------------------------------
# Dropout


def test_dropout_keeps_its_share_and_scales_by_inverse_keep():
    drop = Dropout(0.3)
    drop.generator = torch.Generator().manual_seed(0)
    x = torch.ones(200_000, dtype=torch.bfloat16)
    y = drop(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    assert y.dtype == torch.bfloat16
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / 0.7))
    drop.eval()
    assert drop(x) is x
    assert Dropout(0.0)(x) is x


def test_flagship_dropout_rates_follow_jax():
    """Head towers keep the layer default 0.1, backbone and FPN 0, the ViT,
    its fusion mHC and the feature mHC take the model's rate."""
    model = HybridVisionSystem(dropout_rate=0.25, device="cpu", **TINY)
    rates = {}
    for name, m in model.named_modules():
        if isinstance(m, ManifoldHyperConnection):
            rates[name] = m.dropout.rate
    for name, rate in rates.items():
        if name.startswith("detection_head"):
            assert rate == 0.1, name
        elif name.startswith(("backbone", "fpn")):
            assert rate == 0.0, name
        else:
            assert rate == 0.25, name
    assert model.vit_encoder.encoder.block0.attn.dropout.rate == 0.25


# ---------------------------------------------------------------------------
# Train and eval step, end to end


@pytest.fixture(scope="module")
def tiny_jax_run():
    """The tiny JAX model, its initial weights, one synthetic batch, and the
    JAX train step's and eval step's results on them (one jit)."""
    widths = {k: v for k, v in TINY.items()}
    jm = JaxHybridVisionSystem(num_classes=NUM_CLASSES, dtype=jnp.float32, monitor=True,
                               **widths)
    batch = next(make_synthetic_loader(2, IMAGE, 1, NUM_CLASSES, 8, seed=3)())
    images = jnp.asarray(batch["images"])
    params = jax.device_get(jax.jit(functools.partial(jm.init, task="detection"))(
        jax.random.PRNGKey(0), images)["params"])
    cfg = JaxTrainerConfig(num_classes=NUM_CLASSES, warmup_steps=0, total_steps=100,
                           backbone_lr_factor=0.1, sk_iters=20)
    tx = make_optimizer(jschedule.cosine_annealing_with_warmup(cfg.learning_rate, 0, 100),
                        weight_decay=cfg.weight_decay, mhc_lr_factor=cfg.mhc_lr_factor,
                        clip_regular=cfg.clip_regular, clip_mhc=cfg.clip_mhc,
                        project_every=cfg.project_every, sk_iters=cfg.sk_iters,
                        backbone_lr_factor=cfg.backbone_lr_factor)
    eval_step = make_eval_step(jm, cfg)

    @jax.jit
    def run(params, batch):
        targets = jlosses.build_targets(batch["boxes"], batch["labels"], batch["box_mask"],
                                        [(IMAGE // s, IMAGE // s) for s in (8, 16, 32)],
                                        NUM_CLASSES)

        def loss_fn(p):
            out, coll = jm.apply({"params": p}, batch["images"], task="detection",
                                 deterministic=True, mutable=["stability"])
            det_loss, det_m = jlosses.mhc_yolo_loss(out["detection"]["raw"], targets,
                                                    NUM_CLASSES)
            reg_loss, reg_m = jlosses.manifold_regularization_loss(p, sk_iters=cfg.sk_iters)
            loss = det_loss + cfg.manifold_reg_alpha * reg_loss
            return loss, ({**det_m, **reg_m, "detection_loss": det_loss}, coll["stability"])

        (loss, (metrics, stab)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        layers = jax.tree_util.tree_leaves(
            stab, is_leaf=lambda x: isinstance(x, dict) and "ds_error" in x)
        metrics = {**metrics, "loss": loss, "grad_norm": jax_global_norm(grads),
                   "ds_error_max": jnp.max(jnp.stack([m["ds_error"] for m in layers])),
                   "signal_ratio_mean": jnp.mean(jnp.stack([m["signal_ratio"]
                                                            for m in layers]))}
        updates, _ = tx.update(grads, tx.init(params), params)
        return metrics, grads, optax.apply_updates(params, updates), targets, \
            eval_step(params, batch), len(layers)

    out = jax.device_get(run(params, {k: jnp.asarray(v) for k, v in batch.items()}))
    metrics, grads, new_params, targets, val, n_layers = out
    assert _assigned_cells(targets) == int(batch["box_mask"].sum())  # no collisions
    return dict(params=params, batch=batch, metrics=metrics, grads=grads,
                new_params=new_params, val=val, n_layers=int(n_layers))


def _tiny_trainer(params):
    model = HybridVisionSystem(num_classes=NUM_CLASSES, dtype=torch.float32, monitor=True,
                               device="cpu", **TINY)
    load_flax_params(model, params)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    cfg = TrainerConfig(num_classes=NUM_CLASSES, warmup_steps=0, total_steps=100,
                        backbone_lr_factor=0.1, sk_iters=20)
    trainer = ManifoldConstrainedTrainer(model, cfg, device="cpu")
    trainer.init_state()
    return trainer


def test_train_step_matches_jax(tiny_jax_run):
    want = tiny_jax_run
    trainer = _tiny_trainer(want["params"])
    metrics, grads = train_step(trainer.model, trainer.tx, trainer.config, trainer.state,
                                batch_to(want["batch"], torch.device("cpu")))
    assert want["n_layers"] == len(trainer.model._monitored) == 13  # every mHC of the tiny model
    for k, v in want["metrics"].items():
        _close(float(metrics[k]), float(v), msg=k)
    assert float(metrics["ds_error_max"]) > 0
    # Every gradient leaf, in flax layout (conv kernels OIHW -> HWIO).
    want_g = flatten(want["grads"])
    assert set(want_g) == set(grads)
    for name, g in want_g.items():
        _close(to_flax_layout(name, grads[name].numpy()), g, msg=name)
    for name, p in flatten(want["new_params"]).items():
        _close(to_flax_layout(name, trainer.params()[name].detach().numpy()), p, msg=name)
    assert trainer.state.step == 1 and trainer.tx.count == 1


def test_model_projects_every_h_res_in_one_grouped_call(monkeypatch):
    """The model forward projects all 13 mHC layers' H_res_raw in one grouped
    call and hands each layer its projection for that forward; the outputs
    and the telemetry equal those of each layer projecting its own (the JAX
    arrangement), and a layer called on its own still projects its own."""
    from hvs_tpu_torch.models import hybrid as hybrid_mod
    from hvs_tpu_torch.models import layers as layers_mod

    model = HybridVisionSystem(num_classes=NUM_CLASSES, dtype=torch.float32, monitor=True,
                               device="cpu", seed=3, **TINY)
    model.eval()
    images = torch.from_numpy(
        np.random.default_rng(4).uniform(size=(1, IMAGE, IMAGE, 3)).astype(np.float32))
    calls = {"grouped": 0, "matrices": 0, "single": 0}
    grouped_fn, single_fn = hybrid_mod.sinkhorn_log_many, layers_mod.sinkhorn_log

    def grouped(mats, *args):
        calls["grouped"] += 1
        calls["matrices"] += len(mats)
        return grouped_fn(mats, *args)

    def single(*args):
        calls["single"] += 1
        return single_fn(*args)

    monkeypatch.setattr(hybrid_mod, "sinkhorn_log_many", grouped)
    monkeypatch.setattr(layers_mod, "sinkhorn_log", single)
    layers = [m for m in model.modules() if isinstance(m, ManifoldHyperConnection)]
    with torch.no_grad():
        out = model(images)
        assert calls == {"grouped": 1, "matrices": len(layers), "single": 0}
        assert len(layers) == 13 and all(m.h_res_given is None for m in layers)
        monkeypatch.setattr(model, "_projecting", {})
        own = model(images)
        assert calls["single"] == len(layers)
    raw, raw_own = out["detection"]["raw"], own["detection"]["raw"]
    for k in raw:
        torch.testing.assert_close(raw[k], raw_own[k], rtol=1e-5, atol=1e-6, msg=k)
    for name in out["stability"]:
        for k, v in out["stability"][name].items():
            torch.testing.assert_close(v, own["stability"][name][k], rtol=1e-5, atol=1e-7)

    layer = model.mhc_features
    x = torch.from_numpy(
        np.random.default_rng(5).standard_normal((2, layer.dim)).astype(np.float32))
    with torch.no_grad():
        y = layer(x)
    assert calls["single"] == len(layers) + 1
    h_res = tsink_plain(layer.H_res_raw.detach(), layer.sk_iters)
    torch.testing.assert_close(layer.metrics["col_sum_error"],
                               (h_res.sum(dim=-2) - 1.0).abs().amax(), rtol=0, atol=0)
    assert y.shape == x.shape and torch.isfinite(y).all()


def test_validate_matches_jax_eval_step(tiny_jax_run):
    want = tiny_jax_run
    trainer = _tiny_trainer(want["params"])
    got = trainer.validate([want["batch"]])
    assert set(got) == set(want["val"])
    for k, v in want["val"].items():
        _close(got[k], float(v), msg=k)
    assert not trainer.model.training


# ---------------------------------------------------------------------------
# Entry point, checkpoints, device default


def test_entry_point_trains_tiny_model_on_cpu(tmp_path):
    from hvs_tpu_torch.train import main

    summary = main(["--synthetic", "--tiny", "--steps", "2", "--epochs", "1", "--device", "cpu",
                    "--checkpoint-dir", str(tmp_path / "ckpt"), "--log-dir",
                    str(tmp_path / "logs")])
    assert summary["device"] == "cpu" and summary["steps"] == 2
    assert np.isfinite(summary["train_loss"]).all() and np.isfinite(summary["best_val_loss"])
    assert (tmp_path / "ckpt" / "best.pt").exists()
    assert (tmp_path / "logs" / "stability_report.json").exists()


def test_checkpoint_round_trip_restores_the_train_state(tiny_jax_run, tmp_path):
    trainer = _tiny_trainer(tiny_jax_run["params"])
    trainer.config.checkpoint_dir = str(tmp_path)
    trainer.train_step(tiny_jax_run["batch"])
    trainer.state.lr_scale = 0.5
    trainer.save_checkpoint("ck")
    other = _tiny_trainer(tiny_jax_run["params"])
    other.config.checkpoint_dir = str(tmp_path)
    other.load_checkpoint("ck")
    assert other.state.step == 1 and other.state.lr_scale == 0.5 and other.tx.count == 1
    for name, p in trainer.params().items():
        assert torch.equal(other.params()[name], p), name
    for name, m in trainer.tx.mu.items():
        assert torch.equal(other.tx.mu[name], m), name


def test_metrics_log_has_a_row_per_step_and_closes(tiny_jax_run, tmp_path):
    trainer = _tiny_trainer(tiny_jax_run["params"])
    trainer.config.metrics_log = str(tmp_path / "metrics.jsonl")
    trainer.train_epoch([tiny_jax_run["batch"]] * 2, epoch=0)
    fh = trainer._metrics_fh
    trainer.close()
    assert fh.closed and trainer._metrics_fh is None
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    for r in rows:
        assert np.isfinite([r[k] for k in ("loss", "grad_norm", "ds_error_max",
                                           "signal_ratio_mean")]).all()


def test_training_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid")
    from hvs_tpu_torch.train import main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        HybridVisionSystem(**TINY)
    model = HybridVisionSystem(device="cpu", **TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ManifoldConstrainedTrainer(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--synthetic", "--tiny", "--steps", "1", "--epochs", "1"])
    with pytest.raises(FileNotFoundError, match="instances_train2017.json"):
        # without --synthetic it reads the COCO dataset at --data-root
        main(["--tiny", "--device", "cpu", "--data-root", str(tmp_path / "absent")])
