"""Soft NMS, matrix NMS, ``batched_nms``'s methods, ``NMSFilter`` and
``postprocess_detections(nms_method=...)``, the rest of the box ops, and
hard NMS against the native greedy oracle: the port against the JAX
package on the CPU.

Inputs come from seeded numpy. Boxes sit on a 1/64 grid and class ids stay
below 8, where the reference's class offset (class * 4096 added to the
boxes before the IoU) is exact in fp32, so both sides see the same IoUs.
Tolerances: boxes, classes, ``valid`` and counts exact; scores within
rtol 1e-5 (soft NMS multiplies up to M decay factors in the reference's
order; the two libraries' ``exp`` may differ in the last bit, so a few ulp
per factor; matrix NMS is exact here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvs_tpu.inference import postprocessing as jax_post
from hvs_tpu.models.yolo_head import postprocess_detections as jax_postprocess
from hvs_tpu.native import greedy_nms_native
from hvs_tpu.ops import boxes as jboxes
from hvs_tpu.ops import nms as jnms
from hvs_tpu_torch.inference import postprocessing as port_post
from hvs_tpu_torch.models.yolo_head import postprocess_detections
from hvs_tpu_torch.ops import boxes as tboxes
from hvs_tpu_torch.ops import nms as tnms
from tests.test_torch_ops import _random_boxes

torch.set_num_threads(1)

SCORE_RTOL = 1e-5
METHODS = {"soft": ("soft_nms_fixed", 0.001), "matrix": ("matrix_nms", 0.05)}


def _case(name, n=300):
    """(boxes, scores, classes) of one named case, classes below 8."""
    rng = np.random.default_rng(sum(map(ord, name)))
    boxes = _random_boxes(rng, n, grid=64)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    classes = rng.integers(0, 8, n).astype(np.int32)
    if name == "zero_survivors":
        scores *= 0.2
    elif name == "stacked":  # every box the same, one class: the deepest decay
        boxes[:] = boxes[0]
        classes[:] = 0
    elif name == "score_ties":
        scores = np.round(scores * 8) / 8
    elif name == "class0":
        classes[:] = 0
    elif name == "few_candidates":
        boxes, scores, classes = boxes[:40], scores[:40], classes[:40]
    return boxes, scores, classes


CASES = ["random", "zero_survivors", "stacked", "score_ties", "class0", "few_candidates"]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _compare(got, want):
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.num_valid.numpy(), np.asarray(want.num_valid))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=SCORE_RTOL,
                               atol=0)
    assert got.classes.dtype == torch.int32 and got.num_valid.dtype == torch.int32


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("method", ["soft", "matrix"])
def test_soft_and_matrix_nms_match_jax(method, case):
    name, _ = METHODS[method]
    boxes, scores, classes = _case(case)
    kw = dict(score_threshold=0.25, max_detections=100, pre_nms_top_k=128)
    want = getattr(jnms, name)(*_j(boxes, scores, classes), **kw)
    got = getattr(tnms, name)(*_t(boxes, scores, classes), **kw)
    _compare(got, want)
    if case == "zero_survivors":
        assert int(got.num_valid) == 0


@pytest.mark.parametrize("method", ["soft", "matrix"])
def test_soft_and_matrix_nms_options_match_jax(method):
    """sigma, final_threshold and class_aware=False (no offset in either)."""
    name, _ = METHODS[method]
    boxes, scores, classes = _case("options")
    for kw in (dict(sigma=0.2, final_threshold=0.3), dict(class_aware=False),
               dict(max_detections=300, pre_nms_top_k=512, score_threshold=0.05)):
        want = getattr(jnms, name)(*_j(boxes, scores, classes), **kw)
        got = getattr(tnms, name)(*_t(boxes, scores, classes), **kw)
        _compare(got, want)


@pytest.mark.parametrize("method", ["hard", "soft", "matrix"])
def test_batched_nms_methods_match_jax(method):
    cases = [_case(c) for c in ("random", "score_ties", "zero_survivors")]
    arrays = [np.stack([c[i] for c in cases]) for i in range(3)]
    kw = dict(score_threshold=0.25, max_detections=50, pre_nms_top_k=128)
    want = jnms.batched_nms(*_j(*arrays), method=method, **kw)
    got = tnms.batched_nms(*_t(*arrays), method=method, **kw)
    _compare(got, want)
    with pytest.raises(ValueError, match="unknown NMS method"):
        tnms.batched_nms(*_t(*arrays), method="greedy")


def test_soft_nms_full_trip_count_equals_the_early_stop():
    """The pass a CUDA graph or an export runs (all M trips) keeps what the
    eager pass (stopped after the last valid candidate) keeps, bitwise."""
    boxes, scores, classes = _case("stacked", n=200)
    scores[:60] = np.linspace(0.9, 0.3, 60, dtype=np.float32)
    scores[60:] = 0.1  # a valid prefix of 60 of the 128 candidates
    args = _t(boxes, scores, classes)
    kw = dict(score_threshold=0.25, pre_nms_top_k=128)
    eager = tnms.soft_nms_fixed(*args, **kw)
    real = tnms._full_trips
    tnms._full_trips = lambda t: True
    try:
        full = tnms.soft_nms_fixed(*args, **kw)
    finally:
        tnms._full_trips = real
    for a, b in zip(eager, full):
        assert torch.equal(a, b)


def _pair(cls):
    """Two 16-px boxes at 640 with a true IoU of ~0.42, both of ``cls``, and
    a third box of another class lying on the second."""
    px = 1.0 / 640
    a = [100 * px, 100 * px, 116 * px, 116 * px]
    b = [106.5 * px, 100 * px, 122.5 * px, 116 * px]
    boxes = np.array([a, b, b], np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    classes = np.array([cls, cls, (cls + 1) % 80], np.int32)
    return boxes, scores, classes


def test_soft_nms_is_exact_at_high_class_ids():
    """The port's decay is the same at every class id (the same-class mask
    leaves the IoU exact); the reference's offset rounds it from class 8 on.
    The box of the other class is never decayed (a factor of exactly 1)."""
    kw = dict(score_threshold=0.25, max_detections=4, pre_nms_top_k=4)
    got = {cls: tnms.soft_nms_fixed(*_t(*_pair(cls)), **kw) for cls in (0, 8, 40, 79)}
    for cls, r in got.items():
        assert torch.equal(r.scores, got[0].scores), cls
    iou = tboxes.box_iou(*_t(*_pair(0)[0][:2])).item()
    np.testing.assert_allclose(got[0].scores[:3].numpy(),
                               sorted([0.9, 0.8 * np.exp(-iou ** 2 / 0.5), 0.7], reverse=True),
                               rtol=1e-6)
    want0 = jnms.soft_nms_fixed(*_j(*_pair(0)), **kw)
    np.testing.assert_allclose(got[0].scores.numpy(), np.asarray(want0.scores), rtol=SCORE_RTOL)
    want40 = jnms.soft_nms_fixed(*_j(*_pair(40)), **kw)
    # The reference's defect: its rounded IoU decays the second box to 0.485
    # where the exact IoU gives 0.560.
    assert abs(float(np.asarray(want40.scores)[2]) - float(got[0].scores[2])) > 0.05


def test_matrix_nms_is_exact_at_high_class_ids():
    """Matrix NMS at class ids 0, 8, 40 and 79: the port's result does not
    depend on the class id; the reference's does from class 8 on."""
    px = 1.0 / 640
    boxes = np.array([[100, 100, 116, 116], [106.5, 100, 122.5, 116],
                      [103, 100, 119, 116], [108, 103, 124, 119]], np.float32) * px
    scores = np.array([0.9, 0.8, 0.7, 0.6], np.float32)
    kw = dict(score_threshold=0.25, max_detections=4, pre_nms_top_k=4)
    got = {}
    for cls in (0, 8, 40, 79):
        classes = np.full(4, cls, np.int32)
        got[cls] = tnms.matrix_nms(*_t(boxes, scores, classes), **kw)
        assert torch.equal(got[cls].scores, got[0].scores), cls
    want0 = jnms.matrix_nms(*_j(boxes, scores, np.zeros(4, np.int32)), **kw)
    np.testing.assert_allclose(got[0].scores.numpy(), np.asarray(want0.scores), rtol=SCORE_RTOL)
    want40 = jnms.matrix_nms(*_j(boxes, scores, np.full(4, 40, np.int32)), **kw)
    assert not np.allclose(np.asarray(want40.scores), got[0].scores.numpy(), rtol=1e-3)


def _oracle(boxes, scores, classes, iou_threshold, score_threshold, max_out):
    """The native greedy NMS (``hvs_tpu.native``), or the same loop in numpy
    where the library cannot be built."""
    keep = greedy_nms_native(boxes, scores, classes, iou_threshold, score_threshold, max_out)
    if keep is not None:
        return keep
    kept = []
    for i in np.argsort(-scores, kind="stable"):
        if scores[i] < score_threshold or len(kept) == max_out:
            break
        same = [j for j in kept if classes[j] == classes[i]]
        if not same or port_post._np_iou(boxes[i:i + 1], boxes[same]).max() <= iou_threshold:
            kept.append(i)
    return np.asarray(kept, np.int64)


@pytest.mark.parametrize("seed", range(6))
def test_hard_nms_matches_the_native_greedy_oracle(seed):
    """The port's fixed-point hard NMS keeps exactly what the reference's
    native greedy loop keeps, in the same order (distinct scores: the oracle's
    sort is not stable). The oracle's IoU has no eps where the port's adds
    1e-7 to the union; no pair of these inputs lies within 1e-4 of the
    threshold, where the two definitions could disagree (off the 1/64 grid:
    on it, IoUs are simple fractions that a threshold can hit)."""
    rng = np.random.default_rng(100 + seed)
    n = 64 + 48 * seed
    boxes = _random_boxes(rng, n)
    scores = rng.permutation(np.linspace(0.05, 0.99, n)).astype(np.float32)
    classes = rng.integers(0, 1 + 2 * seed, n).astype(np.int32)
    iou_threshold, score_threshold, max_out = 0.3 + 0.047 * seed, 0.2, 40
    iou = tboxes.pairwise_iou(*_t(boxes, boxes)).numpy()
    assert not (np.abs(iou - iou_threshold) < 1e-4).any()
    keep = _oracle(boxes, scores, classes, iou_threshold, score_threshold, max_out)
    got = tnms.nms_fixed(*_t(boxes, scores, classes), iou_threshold=iou_threshold,
                         score_threshold=score_threshold, max_detections=max_out,
                         pre_nms_top_k=n)
    k = int(got.num_valid)
    assert k == len(keep) > 0
    np.testing.assert_array_equal(got.boxes[:k].numpy(), boxes[keep])
    np.testing.assert_array_equal(got.scores[:k].numpy(), scores[keep])
    np.testing.assert_array_equal(got.classes[:k].numpy(), classes[keep])


@pytest.mark.parametrize("method", ["hard", "soft", "matrix"])
def test_nms_filter_matches_jax(method):
    boxes, scores, classes = _case("filter", n=120)
    got = port_post.NMSFilter(method, 0.45, 0.3, 20).apply(boxes, scores, classes)
    want = jax_post.NMSFilter(method, 0.45, 0.3, 20).apply(boxes, scores, classes)
    assert len(got[0]) == len(want[0]) > 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=SCORE_RTOL, atol=0)
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("method", ["hard", "soft", "matrix"])
def test_postprocess_detections_methods_match_jax(method):
    """``iou_threshold`` reaches hard NMS only, as in the reference: a
    threshold of 0 changes the hard result and no other."""
    cases = [_case(c, n=200) for c in ("post_a", "post_b")]
    boxes, scores, classes = (np.stack([c[i] for c in cases]) for i in range(3))
    outputs = {"boxes": boxes, "class_scores": scores, "class_indices": classes}
    for iou_threshold in (0.45, 0.0):
        kw = dict(score_threshold=0.3, iou_threshold=iou_threshold, max_detections=30,
                  pre_nms_top_k=64, nms_method=method)
        want = jax_postprocess({k: jnp.asarray(v) for k, v in outputs.items()}, **kw)
        got = postprocess_detections({k: torch.from_numpy(v) for k, v in outputs.items()}, **kw)
        _compare(got, want)
        if iou_threshold == 0.45:
            first = got
    assert torch.equal(first.scores, got.scores) == (method != "hard")


def test_box_ops_match_jax():
    rng = np.random.default_rng(7)
    a, b = _random_boxes(rng, 50), _random_boxes(rng, 50)
    b[0] = a[0]  # identical
    b[1] = [a[1, 0] + 0.01, a[1, 1] + 0.01, a[1, 2] - 0.01, a[1, 3] - 0.01]  # nested
    b[2] = [0.9, 0.9, 0.95, 0.95]  # disjoint
    b[3] = [0.5, 0.5, 0.5, 0.7]  # degenerate
    np.testing.assert_allclose(tboxes.xyxy_to_cxcywh(torch.from_numpy(a)).numpy(),
                               np.asarray(jboxes.xyxy_to_cxcywh(jnp.asarray(a))), atol=1e-7)
    round_trip = tboxes.cxcywh_to_xyxy(tboxes.xyxy_to_cxcywh(torch.from_numpy(a))).numpy()
    np.testing.assert_allclose(round_trip, a, atol=1e-6)
    giou = tboxes.box_giou(*_t(a, b)).numpy()
    np.testing.assert_allclose(giou, np.asarray(jboxes.box_giou(*_j(a, b))), atol=1e-6)
    assert giou[0] == pytest.approx(1.0, abs=1e-5) and giou[2] < 0  # eps 1e-7 / area
    pairwise = tboxes.box_giou(torch.from_numpy(a)[:, None], torch.from_numpy(b)[None]).numpy()
    np.testing.assert_allclose(
        pairwise, np.asarray(jboxes.box_giou(jnp.asarray(a)[:, None], jnp.asarray(b)[None])),
        atol=1e-6)
    pixels = (np.concatenate([a, b]) * 900 - 150).astype(np.float32)
    for h, w in ((480, 640), (720.5, 300.0)):
        np.testing.assert_array_equal(tboxes.clip_boxes(torch.from_numpy(pixels), h, w).numpy(),
                                      np.asarray(jboxes.clip_boxes(jnp.asarray(pixels), h, w)))
