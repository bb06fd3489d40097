"""The port's on-device training loop (``train_chunked``, ``training/chunk.py``,
the device-count optimizer, the fixed-shape ``build_targets``) against the
JAX package's, on the CPU.

The chunk of K = 3 steps is held against the scan body of
``hvs_tpu/training/trainer.py::make_train_chunk`` applied K times: JAX's
``sample_batch`` on ``fold_in(rng, step)`` feeds the train step as
``make_train_step`` composes it (dropout off on both sides, as
``tests/test_torch_train.py`` does), and the port's chunk is fed the same
draws. The tiny model of ``scripts/train.py --tiny`` in fp32.
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

from hvs_tpu.data import device_pipeline as jdp
from hvs_tpu.models import HybridVisionSystem as JaxHybridVisionSystem
from hvs_tpu.training import losses as jlosses
from hvs_tpu.training import schedule as jschedule
from hvs_tpu.training.optimizer import make_optimizer
from hvs_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from hvs_tpu.training.trainer import global_norm as jax_global_norm
from hvs_tpu.training.trainer import make_val_chunk
from hvs_tpu_torch.convert import flatten, load_flax_params, nest, to_flax_layout
from hvs_tpu_torch.data import device_pipeline as tdp
from hvs_tpu_torch.models import HybridVisionSystem
from hvs_tpu_torch.models.layers import Dropout
from hvs_tpu_torch.train import TINY
from hvs_tpu_torch.training import losses as tlosses
from hvs_tpu_torch.training import schedule as tschedule
from hvs_tpu_torch.training.chunk import TrainChunk, ValChunk
from hvs_tpu_torch.training.optimizer import ManifoldAwareOptimizer
from hvs_tpu_torch.training.trainer import ManifoldConstrainedTrainer, TrainerConfig

torch.set_num_threads(1)

# tests/test_torch_train.py's end-to-end tolerance (fp32 through the model,
# sums in other orders in XLA and PyTorch).
RTOL, ATOL = 2e-3, 5e-3
NUM_CLASSES, N, S, M, B, OUT, K = 8, 8, 80, 8, 2, 64, 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


def _dataset(seed=0, n=N):
    r = np.random.default_rng(seed)
    images = r.integers(0, 256, (n, S, S, 3), dtype=np.uint8)
    wh = r.uniform(0.1, 0.5, (n, M, 2))
    boxes = np.concatenate([r.uniform(wh / 2, 1 - wh / 2), wh], -1).astype(np.float32)
    labels = r.integers(0, NUM_CLASSES, (n, M)).astype(np.int32)
    mask = (r.uniform(size=(n, M)) > 0.4).astype(np.float32)
    return images, boxes, labels, mask


def _jax_draws(rng, batch, n, aug):
    """``sample_batch``'s draws on ``rng`` as the port's ``AugmentDraws``."""
    k_idx, k_flip, k_bright, k_con, k_gain, k_zoom, k_tx, k_ty = jax.random.split(rng, 8)
    u = jax.random.uniform
    draws = dict(
        idx=jax.random.randint(k_idx, (batch,), 0, n),
        flip=jax.random.bernoulli(k_flip, aug.flip_prob, (batch,)),
        brightness=u(k_bright, (batch, 1, 1, 1), minval=-aug.brightness,
                     maxval=aug.brightness),
        contrast=u(k_con, (batch, 1, 1, 1), minval=1 - aug.contrast, maxval=1 + aug.contrast),
        gain=u(k_gain, (batch, 1, 1, 3), minval=1 - aug.channel_gain,
               maxval=1 + aug.channel_gain),
        zoom=u(k_zoom, (batch,), minval=aug.zoom_min, maxval=aug.zoom_max),
        tx=u(k_tx, (batch,)), ty=u(k_ty, (batch,)))
    return tdp.AugmentDraws(**{k: _t(v).to(torch.long if k == "idx" else None)
                               for k, v in draws.items()})


# ---------------------------------------------------------------------------
# Optimizer with its count on the device


def _opt_tree(seed):
    r = np.random.default_rng(seed)
    f = lambda *s: (0.3 * r.standard_normal(s)).astype(np.float32)  # noqa: E731
    return {
        "backbone": {"stem1": {"kernel": f(4, 3, 3, 3)},
                     "stage1_block0": {"mhc": {"H_res_raw": f(8, 8), "norm_pre_scale": f(8)}}},
        "fpn": {"mhc0": {"H_res_raw": f(12, 12), "H_pre_raw": f(12, 24)},
                "lateral0": {"kernel": f(6, 5)}},
        "detection_head": {"head_small": {"predict": {"bias": f(7)}}},
    }


def test_device_count_optimizer_matches_optax_across_warmup_projection_and_lr_scale():
    """Seven updates: warm-up over the first three, projections at counts 3
    and 6 (project_every 3), lr_scale 1, then 0.5 from the fourth update
    (a 0-dim tensor, as train_chunked hands it). The count, the learning rate
    and the bias corrections come from the device count."""
    tree = _opt_tree(11)
    sched_args = (0.05, 3, 20)
    kw = dict(weight_decay=0.05, mhc_lr_factor=0.5, clip_regular=1.0, clip_mhc=0.5,
              project_every=3, sk_iters=20, backbone_lr_factor=0.1)
    tx = make_optimizer(jschedule.cosine_annealing_with_warmup(*sched_args), **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = tx.init(jparams)

    @jax.jit
    def jstep(params, state, grads, lr_scale):
        updates, state = tx.update(grads, state, params)
        updates = jax.tree_util.tree_map(lambda u: u * lr_scale, updates)
        return optax.apply_updates(params, updates), state

    params = {k: torch.nn.Parameter(_t(v)) for k, v in flatten(tree).items()}
    schedule = tschedule.cosine_annealing_with_warmup(*sched_args)
    ttx = ManifoldAwareOptimizer(params, schedule, **kw)
    assert ttx.count.dtype == torch.int32 and ttx.count.dim() == 0
    lr_scale = torch.ones(())
    r = np.random.default_rng(12)
    for step in range(7):
        if step == 3:
            lr_scale.fill_(0.5)
        _close(float(ttx.lr(ttx.count)), schedule(step), rtol=1e-6, atol=1e-12,
               msg=f"lr at count {step}")
        grads = {k: ((3.0 if step % 2 else 0.05) * r.standard_normal(v.shape)).astype(np.float32)
                 for k, v in flatten(tree).items()}
        jparams, jstate = jstep(jparams, jstate, jax.tree_util.tree_map(jnp.asarray, nest(grads)),
                                jnp.float32(float(lr_scale)))
        ttx.step({k: _t(v) for k, v in grads.items()}, lr_scale=lr_scale)
        for name, want in flatten(jax.device_get(jparams)).items():
            _close(params[name].detach().numpy(), want, rtol=1e-5, atol=1e-7,
                   msg=f"update {step + 1}: {name}")
    assert int(ttx.count) == 7


def test_schedule_on_a_device_count_matches_the_host_schedule():
    host = tschedule.cosine_annealing_with_warmup(1e-3, 10, 100)
    want = jschedule.cosine_annealing_with_warmup(1e-3, 10, 100)
    for step in (0, 1, 9, 10, 11, 55, 99, 100, 150):
        got = float(host(torch.tensor(step, dtype=torch.int32)))
        _close(got, float(want(step)), rtol=1e-6, atol=0, msg=f"step {step}")
        _close(got, host(step), rtol=1e-6, atol=0, msg=f"step {step}")


# ---------------------------------------------------------------------------
# build_targets at fixed shape

GRIDS = [(12, 12), (6, 6), (3, 3)]


def _boolean_index_build_targets(gt_boxes, gt_labels, gt_mask, grid_sizes, num_classes,
                                 anchors=tlosses.COCO_ANCHORS_416):
    """The port's earlier build_targets (boolean-mask indexing), kept as the
    reference for the fixed-shape one."""
    from hvs_tpu_torch.models.yolo_head import SCALE_ORDER, effective_anchors

    b, m, _ = gt_boxes.shape
    a_per_scale = len(anchors[0])
    flat = torch.tensor([wh for s in range(len(grid_sizes))
                         for wh in effective_anchors(s, grid_sizes[s][0], anchors)])
    gw, gh = gt_boxes[..., 2:3], gt_boxes[..., 3:4]
    aw, ah = flat[None, None, :, 0], flat[None, None, :, 1]
    inter = torch.minimum(gw, aw) * torch.minimum(gh, ah)
    best = torch.argmax(inter / (gw * gh + aw * ah - inter + 1e-9), dim=-1)
    best_scale, best_anchor = best // a_per_scale, best % a_per_scale
    batch_idx = torch.arange(b)[:, None].expand(b, m)
    slot = torch.arange(m)[None, :].expand(b, m)
    out = {}
    for s, (gh_s, gw_s) in enumerate(grid_sizes):
        valid = (best_scale == s) & (gt_mask > 0.5)
        gx = torch.clamp(torch.floor(gt_boxes[..., 0] * gw_s), 0, gw_s - 1).long()
        gy = torch.clamp(torch.floor(gt_boxes[..., 1] * gh_s), 0, gh_s - 1).long()
        cell = ((batch_idx * gh_s + gy) * gw_s + gx) * a_per_scale + best_anchor
        n_cells = b * gh_s * gw_s * a_per_scale
        cell = torch.where(valid, cell, torch.zeros_like(cell))
        winner = torch.full((n_cells,), -1, dtype=torch.long).scatter_reduce(
            0, cell[valid], slot[valid], reduce="amax")
        win = valid & (winner[cell] == slot)
        idx = cell[win]
        box_t, obj_t = torch.zeros(n_cells, 4), torch.zeros(n_cells)
        cls_t = torch.zeros(n_cells, dtype=torch.long)
        box_t[idx] = gt_boxes[win].float()
        obj_t[idx] = 1.0
        cls_t[idx] = gt_labels[win].long()
        shape = (b, gh_s, gw_s, a_per_scale)
        out[SCALE_ORDER[s]] = {"box": box_t.reshape(shape + (4,)), "obj": obj_t.reshape(shape),
                               "cls": cls_t.reshape(shape)}
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_targets_equals_the_boolean_index_version_on_collisions(seed):
    """Many boxes crowded into a few cells at a few sizes: most slots collide
    with another on their (cell, anchor)."""
    r = np.random.default_rng(seed)
    b, m = 3, 40
    centre = r.uniform(0.3, 0.45, (b, m, 2))
    wh = r.choice([0.05, 0.12, 0.3, 0.6], (b, m, 1)).repeat(2, -1) * r.uniform(0.9, 1.1,
                                                                               (b, m, 2))
    boxes = _t(np.concatenate([centre, wh], -1).astype(np.float32))
    labels = _t(r.integers(0, NUM_CLASSES, (b, m)).astype(np.int32))
    mask = _t((r.uniform(size=(b, m)) > 0.2).astype(np.float32))
    got = tlosses.build_targets(boxes, labels, mask, GRIDS, NUM_CLASSES)
    want = _boolean_index_build_targets(boxes, labels, mask, GRIDS, NUM_CLASSES)
    assert sum(int(t["obj"].sum()) for t in want.values()) < int(mask.sum())  # collisions
    for key in want:
        for field in ("box", "obj", "cls"):
            assert got[key][field].dtype == want[key][field].dtype
            assert torch.equal(got[key][field], want[key][field]), f"{key}/{field}"


def test_build_targets_fixed_shape_matches_jax():
    r = np.random.default_rng(9)
    b, m = 3, 10
    wh = r.uniform(0.03, 0.7, (b, m, 2))
    boxes = np.concatenate([r.uniform(wh / 2, 1 - wh / 2), wh], -1).astype(np.float32)
    labels = r.integers(0, NUM_CLASSES, (b, m)).astype(np.int32)
    mask = (r.uniform(size=(b, m)) > 0.3).astype(np.float32)
    want = jlosses.build_targets(jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask),
                                 GRIDS, NUM_CLASSES)
    assert sum(int(np.asarray(t["obj"]).sum()) for t in want.values()) == int(mask.sum())
    got = tlosses.build_targets(_t(boxes), _t(labels), _t(mask), GRIDS, NUM_CLASSES)
    for key, w in want.items():
        for field in ("box", "obj", "cls"):
            np.testing.assert_array_equal(got[key][field].numpy(), np.asarray(w[field]),
                                          err_msg=f"{key}/{field}")


# ---------------------------------------------------------------------------
# A chunk of K steps and the validation chunk, end to end against JAX


def _jax_config():
    return JaxTrainerConfig(num_classes=NUM_CLASSES, warmup_steps=2, total_steps=50,
                            backbone_lr_factor=0.1, project_every=2, ema_decay=0.9, sk_iters=5)


@pytest.fixture(scope="module")
def jax_chunk_reference():
    """K steps of the JAX scan body on the tiny model: ``sample_batch`` on
    ``fold_in(rng, step)``, then the train step with dropout off, the optax
    chain, lr_scale 1 and the EMA; then ``make_val_chunk`` on the EMA."""
    jm = JaxHybridVisionSystem(num_classes=NUM_CLASSES, dtype=jnp.float32, monitor=True, **TINY)
    arrays = _dataset()
    jdata = jdp.DeviceData(*(jnp.asarray(a) for a in arrays))
    params = jax.device_get(jax.jit(functools.partial(jm.init, task="detection"))(
        jax.random.PRNGKey(0), jnp.zeros((1, OUT, OUT, 3), jnp.float32))["params"])
    cfg = _jax_config()
    tx = make_optimizer(jschedule.cosine_annealing_with_warmup(cfg.learning_rate,
                                                               cfg.warmup_steps,
                                                               cfg.total_steps),
                        weight_decay=cfg.weight_decay, mhc_lr_factor=cfg.mhc_lr_factor,
                        clip_regular=cfg.clip_regular, clip_mhc=cfg.clip_mhc,
                        project_every=cfg.project_every, sk_iters=cfg.sk_iters,
                        backbone_lr_factor=cfg.backbone_lr_factor)
    grids = [(OUT // s, OUT // s) for s in (8, 16, 32)]

    @jax.jit
    def step(params, opt_state, ema, batch):
        targets = jlosses.build_targets(batch["boxes"], batch["labels"], batch["box_mask"],
                                        grids, NUM_CLASSES)

        def loss_fn(p):
            out, coll = jm.apply({"params": p}, batch["images"], task="detection",
                                 deterministic=True, mutable=["stability"])
            det_loss, det_m = jlosses.mhc_yolo_loss(out["detection"]["raw"], targets,
                                                    NUM_CLASSES)
            reg_loss, reg_m = jlosses.manifold_regularization_loss(p, sk_iters=cfg.sk_iters)
            return det_loss + cfg.manifold_reg_alpha * reg_loss, (
                {**det_m, **reg_m, "detection_loss": det_loss}, coll["stability"])

        (loss, (metrics, stab)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        layers = jax.tree_util.tree_leaves(
            stab, is_leaf=lambda x: isinstance(x, dict) and "ds_error" in x)
        metrics = {**metrics, "loss": loss, "grad_norm": jax_global_norm(grads),
                   "ds_error_max": jnp.max(jnp.stack([x["ds_error"] for x in layers])),
                   "signal_ratio_mean": jnp.mean(jnp.stack([x["signal_ratio"]
                                                            for x in layers]))}
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        d = cfg.ema_decay
        ema = jax.tree_util.tree_map(lambda e, q: d * e + (1.0 - d) * q, ema, params)
        return params, opt_state, ema, metrics

    sample = jax.jit(jdp.sample_batch, static_argnums=(2, 3, 4, 5))
    aug = jdp.AugmentConfig()
    rng = jax.random.PRNGKey(7)
    p, opt_state, ema = params, tx.init(params), params
    draws, rows = [], []
    for i in range(K):
        step_rng = jax.random.fold_in(rng, i)  # state.step before the step
        draws.append(_jax_draws(step_rng, B, N, aug))
        p, opt_state, ema, metrics = step(p, opt_state, ema,
                                          sample(jdata, step_rng, B, OUT, aug, True))
        rows.append(jax.device_get(metrics))
    val = make_val_chunk(jm, cfg, 4, OUT, N // 4)
    val_loss = float(jax.jit(val)(ema, jdata))
    return dict(arrays=arrays, params=params, draws=draws, rows=rows,
                final=jax.device_get(p), ema=jax.device_get(ema), val_loss=val_loss)


def _tiny_trainer(params, **config):
    model = HybridVisionSystem(num_classes=NUM_CLASSES, dtype=torch.float32, monitor=True,
                               device="cpu", **TINY)
    load_flax_params(model, params)
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.rate = 0.0
    cfg = TrainerConfig(num_classes=NUM_CLASSES, warmup_steps=2, total_steps=50,
                        backbone_lr_factor=0.1, project_every=2, ema_decay=0.9,
                        sk_iters=TINY["sk_iters"], **config)
    trainer = ManifoldConstrainedTrainer(model, cfg, device="cpu")
    trainer.init_state()
    return trainer


def test_chunk_of_steps_matches_jax_scan_body(jax_chunk_reference):
    want = jax_chunk_reference
    trainer = _tiny_trainer(want["params"])
    data = tdp.put_device_data(*want["arrays"], device="cpu")
    chunk = TrainChunk(trainer, data, OUT, B, K, tdp.AugmentConfig())
    assert chunk.graph is None  # the CPU runs the step eagerly
    for draws in want["draws"]:
        chunk.step(draws)
    assert int(chunk.pos) == K and int(trainer.tx.count) == K
    host = chunk.pull()
    for i, row in enumerate(want["rows"]):
        for k, v in row.items():
            _close(host[k][i], float(v), msg=f"step {i}: {k}")
    schedule = tschedule.cosine_annealing_with_warmup(1e-3, 2, 50)
    _close(host["lr"], [schedule(i) for i in range(K)], rtol=1e-6, atol=0)
    for name, p in flatten(want["final"]).items():
        _close(to_flax_layout(name, trainer.params()[name].detach().numpy()), p, msg=name)
    for name, e in flatten(want["ema"]).items():
        _close(to_flax_layout(name, trainer.state.ema_params[name].numpy()), e,
               msg=f"ema {name}")

    val = ValChunk(trainer, data, 4, OUT, N // 4)
    _close(val.run(), want["val_loss"], msg="val loss on the EMA")
    assert val.pulls == 1 and val.graph is None


# ---------------------------------------------------------------------------
# The host loop


def test_train_chunked_host_loop(tmp_path, monkeypatch):
    """Four chunks of 2 steps over two sizes: one metrics pull per chunk,
    a JSONL row per step with the schedule's lr, every check unstable (a
    tiny explosion threshold), so each chunk halves lr_scale and the next
    chunk's steps get it through lr_scale_t; validation every second chunk
    with a best checkpoint, step checkpoints every 4 steps."""
    model = HybridVisionSystem(num_classes=NUM_CLASSES, dtype=torch.float32, monitor=True,
                               device="cpu", seed=3, **TINY)
    cfg = TrainerConfig(num_classes=NUM_CLASSES, warmup_steps=3, total_steps=20,
                        checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every_steps=4,
                        metrics_log=str(tmp_path / "steps.jsonl"), grad_explosion_threshold=1e-3,
                        sk_iters=TINY["sk_iters"])
    trainer = ManifoldConstrainedTrainer(model, cfg, device="cpu", seed=1)
    trainer.init_state()
    data = tdp.put_device_data(*_dataset(seed=4), device="cpu")
    progress = []
    lr_scales_seen = []
    real_run = TrainChunk.run

    def run(chunk):
        lr_scales_seen.append(float(trainer.lr_scale_t))
        return real_run(chunk)

    monkeypatch.setattr(TrainChunk, "run", run)
    result = trainer.train_chunked(data, total_steps=8, out_sizes=(64, 96),
                                   batch_sizes={64: 2, 96: 1}, chunk_steps=2, val_data=data,
                                   val_batch_size=4, val_every_chunks=2, eig_every_chunks=2,
                                   progress_fn=progress.append)
    trainer.close()
    assert trainer.state.step == 8 and int(trainer.tx.count) == 8
    assert {o: c.pulls for o, c in trainer.chunks.items()} == {64: 2, 96: 2}
    assert trainer.val_chunk.pulls == 2 and len(result["history"]["val_loss"]) == 2
    assert [r["out_size"] for r in progress] == [64, 96, 64, 96]
    assert lr_scales_seen == [1.0, 0.5, 0.25, 0.125]
    assert [r["lr_scale"] for r in progress] == [0.5, 0.25, 0.125, 0.0625]
    assert len(trainer.monitor.corrections) == 4
    assert all(r["eig_ds_error_max_proj"] < 1e-3 for r in progress)
    assert progress[0]["val_loss"] is None and np.isfinite(progress[1]["val_loss"])
    rows = [json.loads(line) for line in (tmp_path / "steps.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == list(range(1, 9))
    assert [r["lr_scale"] for r in rows] == [1.0] * 2 + [0.5] * 2 + [0.25] * 2 + [0.125] * 2
    for r in rows:
        _close(r["lr"], trainer.schedule(r["step"] - 1), rtol=1e-6, atol=1e-12)
        assert np.isfinite([r[k] for k in ("loss", "grad_norm", "ds_error_max")]).all()
    names = sorted(os.listdir(tmp_path / "ckpt"))
    assert "best.pt" in names and "step_4.pt" in names and "step_8.pt" in names
    assert np.isfinite(result["best_val_loss"]) and result["steps_per_sec"] > 0


def test_train_device_entry_point_on_cpu(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root)
    out = subprocess.run(
        [sys.executable, "-m", "hvs_tpu_torch.train_device", "--synthetic", "8", "--tiny",
         "--device", "cpu", "--total-steps", "4", "--chunk-steps", "2", "--val-every-chunks",
         "2", "--run-dir", str(tmp_path / "run")],
        capture_output=True, text=True, timeout=600, env=env, check=True, cwd=root)
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["steps"] == 4 and np.isfinite(summary["best_val_loss"])
    assert set(summary) == {"steps", "steps_per_sec", "best_val_loss", "wall_hours"}
    for name in ("steps.jsonl", "chunks.jsonl", "stability_report.json",
                 "checkpoints/final.pt", "checkpoints/best.pt"):
        assert (tmp_path / "run" / name).exists(), name


def test_train_device_raises_for_what_is_not_ported(tmp_path):
    from hvs_tpu_torch.train_device import main

    with pytest.raises(FileNotFoundError, match="instances_train.json"):
        # --data-root is read (load_coco_arrays); an absent dataset raises
        main(["--data-root", str(tmp_path / "absent"), "--device", "cpu"])
    # --use-rag (ported): the retrieval model trains, its knowledge base the
    # benchmark's classes (8 + 5 facts).
    summary = main(["--synthetic", "8", "--use-rag", "--num-classes", "8", "--tiny", "--device",
                    "cpu", "--total-steps", "2", "--chunk-steps", "2", "--val-every-chunks",
                    "1", "--run-dir", str(tmp_path / "rag")])
    assert summary["steps"] == 2 and np.isfinite(summary["best_val_loss"])
    ckpt = torch.load(tmp_path / "rag" / "checkpoints" / "final.pt", map_location="cpu")
    assert "rag_gate" in ckpt["params"] and "rag.mhc_fuse.H_res_raw" in ckpt["params"]
