"""Parity of the port's ops (hvs_tpu_torch.ops) with the JAX package's.

Inputs come from seeded numpy and go through both; JAX runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvs_tpu.ops import boxes as jboxes
from hvs_tpu.ops import nms as jnms
from hvs_tpu.ops import sinkhorn as jsink
from hvs_tpu_torch.ops import boxes as tboxes
from hvs_tpu_torch.ops import nms as tnms
from hvs_tpu_torch.ops import sinkhorn as tsink

torch.set_num_threads(1)


@pytest.mark.parametrize("n,batch", [(8, ()), (77, ()), (128, ()), (32, (3,))])
def test_sinkhorn_log_matches_jax(n, batch):
    logits = np.random.default_rng(n).standard_normal(batch + (n, n)).astype(np.float32) * 2
    want = np.asarray(jsink.sinkhorn_log(jnp.asarray(logits), n_iters=20))
    got = tsink.sinkhorn_log(torch.from_numpy(logits), n_iters=20).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    err_j = np.asarray(jsink.doubly_stochastic_error(jnp.asarray(want)))
    err_t = tsink.doubly_stochastic_error(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(err_t, err_j, atol=1e-6)
    assert float(np.max(err_t)) < 1e-3


def test_sinkhorn_keeps_input_dtype_and_tau():
    logits = np.random.default_rng(1).standard_normal((16, 16)).astype(np.float32)
    want = np.asarray(jsink.sinkhorn_log(jnp.asarray(logits, jnp.bfloat16), 10, tau=0.5)
                      .astype(jnp.float32))
    got = tsink.sinkhorn_log(torch.from_numpy(logits).to(torch.bfloat16), 10, tau=0.5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2)


def _random_boxes(rng, n, grid=None):
    xy = rng.uniform(0, 0.8, (n, 2))
    wh = rng.uniform(0.02, 0.3, (n, 2))
    b = np.concatenate([xy, xy + wh], axis=-1)
    if grid:
        b = np.round(b * grid) / grid
    return b.astype(np.float32)


def test_pairwise_iou_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _random_boxes(rng, 37), _random_boxes(rng, 23)
    b[0] = [0.5, 0.5, 0.5, 0.7]  # degenerate (zero width)
    want = np.asarray(jboxes.pairwise_iou(jnp.asarray(a), jnp.asarray(b)))
    got = tboxes.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def _compare(res_t, res_j):
    np.testing.assert_allclose(res_t.boxes.numpy(), np.asarray(res_j.boxes), atol=1e-6)
    np.testing.assert_array_equal(res_t.scores.numpy(), np.asarray(res_j.scores))
    np.testing.assert_array_equal(res_t.classes.numpy(), np.asarray(res_j.classes))
    np.testing.assert_array_equal(res_t.valid.numpy(), np.asarray(res_j.valid))
    np.testing.assert_array_equal(res_t.num_valid.numpy(), np.asarray(res_j.num_valid))
    assert res_t.classes.dtype == torch.int32 and res_t.num_valid.dtype == torch.int32


def _nms_case(name):
    """(boxes, scores, classes, kwargs). Boxes sit on a 1/64 grid and classes
    stay below 8, where the reference's class-offset arithmetic is exact."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n = 300
    boxes = _random_boxes(rng, n, grid=64)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    classes = rng.integers(0, 4, n).astype(np.int32)
    kw = dict(iou_threshold=0.45, score_threshold=0.25, max_detections=100, pre_nms_top_k=128)
    if name == "zero_survivors":
        scores *= 0.2
    elif name == "all_suppressed":
        boxes[:] = boxes[0]
        classes[:] = 0
    elif name == "score_ties":
        scores = np.round(scores * 8) / 8  # many exact ties
    elif name == "class0":
        classes[:] = 0
    elif name == "few_candidates":  # fewer candidates than max_detections
        boxes, scores, classes = boxes[:40], scores[:40], classes[:40]
    return boxes, scores, classes, kw


@pytest.mark.parametrize(
    "case", ["random", "zero_survivors", "all_suppressed", "score_ties", "class0",
             "few_candidates"])
def test_nms_fixed_matches_jax(case):
    boxes, scores, classes, kw = _nms_case(case)
    res_j = jnms.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), **kw)
    res_t = tnms.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores),
                           torch.from_numpy(classes), **kw)
    _compare(res_t, res_j)
    if case == "zero_survivors":
        assert int(res_t.num_valid) == 0
    if case == "all_suppressed":
        assert int(res_t.num_valid) == 1


def test_batched_nms_matches_jax():
    cases = [_nms_case(c) for c in ("random", "score_ties", "zero_survivors")]
    boxes = np.stack([c[0] for c in cases])
    scores = np.stack([c[1] for c in cases])
    classes = np.stack([c[2] for c in cases])
    kw = cases[0][3]
    res_j = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
                             **kw)
    res_t = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                             torch.from_numpy(classes), **kw)
    _compare(res_t, res_j)
    with pytest.raises(ValueError):  # no batch axis
        tnms.batched_nms(torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]),
                         torch.from_numpy(classes[0]), **kw)


def test_top_k_ties_put_lower_index_first():
    vals = np.array([0.5, 0.9, 0.5, 0.9, 0.1, 0.5], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(vals), 4)
    got_v, got_i = tnms.top_k_stable(torch.from_numpy(vals), 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_class_aware_nms_is_exact_at_high_class_ids():
    """Two 16-px boxes at 640 with IoU ~0.42: kept apart in every class by the
    same-class mask, where the reference's class*4096 offset rounds the IoU
    (reads 1.0 at class 40 and suppresses one box)."""
    px = 1.0 / 640
    a = [100 * px, 100 * px, 116 * px, 116 * px]
    b = [106.5 * px, 100 * px, 122.5 * px, 116 * px]
    boxes = np.array([a, b], np.float32)
    scores = np.array([0.9, 0.8], np.float32)
    kw = dict(iou_threshold=0.45, score_threshold=0.25, max_detections=4, pre_nms_top_k=4)
    kept = []
    for cls in (0, 8, 40, 79):
        classes = np.full(2, cls, np.int32)
        res = tnms.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores),
                             torch.from_numpy(classes), **kw)
        kept.append(int(res.num_valid))
    assert kept == [2, 2, 2, 2]
    ref = jnms.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores),
                         jnp.full(2, 40, jnp.int32), **kw)
    assert int(ref.num_valid) == 1  # the reference's defect, recorded in ROADMAP.md
