"""The port's serving engine against the JAX engine, path by path, on the CPU.

A tiny JAX ``InferenceEngine`` (``tests/test_inference.py``'s configs, fp32)
and the port's engine from the same configs and the same converted weights
serve the same uint8 images, first through the registered raw-frame path
(letterbox inside the serve function), then through the letterboxed path
(host letterbox in JAX, the port's eager letterbox on its device). The head
is conditioned as in ``tests/test_torch_serve.py`` so that scores spread
across the 0.25 threshold and the NMS is well conditioned. Also: the
letterbox, the raw resize, ROI pooling, ``InferenceMetrics``, the trackers,
hard ``NMSFilter`` and the robot wire format, each against JAX.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvs_tpu.constants import IMAGENET_MEAN, IMAGENET_STD
from hvs_tpu.data.dataset import letterbox as jax_letterbox
from hvs_tpu.inference import InferenceEngine as JaxEngine
from hvs_tpu.inference import postprocessing as jax_post
from hvs_tpu.inference import robot_interface as jax_robot
from hvs_tpu.inference import transports as jax_transports
from hvs_tpu.models.rag import roi_pool_bilinear as jax_roi_pool
from hvs_tpu.utils.metrics import InferenceMetrics as JaxInferenceMetrics
from hvs_tpu_torch.config import InferenceConfig, ModelConfig, from_dict
from hvs_tpu_torch.data import letterbox, letterbox_raw_batch
from hvs_tpu_torch.inference import Detections, InferenceEngine
from hvs_tpu_torch.inference import postprocessing as port_post
from hvs_tpu_torch.inference import robot_interface as port_robot
from hvs_tpu_torch.inference import transports as port_transports
from hvs_tpu_torch.models.rag import roi_pool_bilinear
from hvs_tpu_torch.utils.metrics import InferenceMetrics
from tests.test_inference import tiny_inference_config, tiny_model_config

torch.set_num_threads(1)

# As tests/test_torch_serve.py: floats within rtol 2e-3 / atol 5e-3, classes
# and counts exact where the top-2 class margin exceeds 5e-3.
RTOL, ATOL, MARGIN = 2e-3, 5e-3, 5e-3
RAW_HW = (48, 80)


def _configs():
    """The JAX engine tests' tiny configs in fp32, at the 0.25 threshold,
    and the port's configs with the same fields on the CPU."""
    jm = tiny_model_config()
    jm.precision = "fp32"
    ji = tiny_inference_config()
    ji.postprocessing.score_threshold = 0.25
    pm = from_dict(ModelConfig, {**json.loads(json.dumps(jm.to_dict())), "device": "cpu"})
    pi = from_dict(InferenceConfig, {**json.loads(json.dumps(ji.to_dict())), "device": "cpu"})
    pi.performance.batch_buckets = tuple(ji.performance.batch_buckets)
    return jm, ji, pm, pi


@pytest.fixture(scope="module")
def engine_pair():
    """(JAX engine, port engine) on the same conditioned weights, with RAW_HW
    registered at bucket 2 in both."""
    jm, ji, pm, pi = _configs()
    jax_model = jm.build_model(production=True)
    v = jax.jit(functools.partial(jax_model.init, task="detection"))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    params = jax.device_get(v["params"])
    r = np.random.default_rng(1)
    for head in params["detection_head"].values():
        pred = head["predict"]
        pred["kernel"] = (pred["kernel"] * 4.0).astype(np.float32)
        bias = np.array(pred["bias"]).reshape(3, -1)
        bias[:, 4] = 1.0
        bias[:, 5:] = r.standard_normal(bias[:, 5:].shape)
        pred["bias"] = bias.reshape(-1).astype(np.float32)
    j = JaxEngine(jm, ji, variables={"params": params})
    j.register_raw_shape(RAW_HW, buckets=(2,))
    p = InferenceEngine(pm, pi, variables={"params": params})
    p.register_raw_shape(RAW_HW, buckets=(2,))
    return j, p


def _images(seed, shapes):
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, (*hw, 3), dtype=np.uint8) for hw in shapes]


def _serve_both(pair, images):
    j, p = pair
    jh, ph = j.dispatch_batch(images), p.dispatch_batch(images)
    want, got = np.asarray(jh["device"]), ph["out"].numpy().copy()
    return want, got, j.finalize_batch(jh), p.finalize_batch(ph)


def _check_packed(want, got):
    """Boxes and scores within tolerance; classes and counts exact."""
    assert want.shape == got.shape
    np.testing.assert_array_equal(got[:, 0, 6], want[:, 0, 6])  # num_valid
    assert want[:, 0, 6].sum() >= 4  # real detections survive the NMS
    np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_allclose(got[..., :5], want[..., :5], rtol=RTOL, atol=ATOL)


def _check_detections(want, got):
    for w, g in zip(want, got):
        assert g.image_size == w.image_size and len(g) == len(w)
        np.testing.assert_array_equal(g.classes, w.classes)
        assert g.class_names == w.class_names
        np.testing.assert_allclose(g.scores, w.scores, rtol=RTOL, atol=ATOL)
        # Pixel boxes: the normalized tolerance scaled by the un-letterbox.
        scale = max(w.image_size) / 64
        np.testing.assert_allclose(g.boxes, w.boxes, rtol=RTOL, atol=ATOL * 64 * scale)


def test_raw_path_matches_jax(engine_pair):
    images = _images(0, [RAW_HW, RAW_HW])
    want, got, want_det, got_det = _serve_both(engine_pair, images)
    _check_packed(want, got)
    _check_detections(want_det, got_det)
    assert engine_pair[1].replays[(2, RAW_HW)] >= 1


def test_letterboxed_path_matches_jax(engine_pair):
    """Mixed shapes take the letterboxed path: the reference's host
    letterbox (native, rounded to uint8) against the port's on its device
    (rounded half up); the two may differ by one grey level."""
    images = _images(1, [(60, 50), (64, 64)])
    want, got, want_det, got_det = _serve_both(engine_pair, images)
    _check_packed(want, got)
    _check_detections(want_det, got_det)


def test_letterbox_matches_jax():
    for i, (h, w, size) in enumerate([(480, 640, 64), (720, 1280, 416), (37, 53, 64),
                                      (101, 67, 96), (50, 100, 64)]):
        img = _images(10 + i, [(h, w)])[0]
        got, scale, pad = letterbox(img, size)
        want, want_scale, want_pad = jax_letterbox(img, size)
        assert (scale, pad) == (want_scale, want_pad)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, (h, w, size)


@functools.lru_cache(maxsize=None)
def _jax_raw_preprocess(h, w, size, pad_color=114):
    """A jitted copy of the raw serve program's preprocessing
    (``hvs_tpu/inference/engine.py:483-505``)."""
    scale = size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    pad_x, pad_y = (size - nw) // 2, (size - nh) // 2
    mean = jnp.asarray(IMAGENET_MEAN, jnp.float32)
    std = jnp.asarray(IMAGENET_STD, jnp.float32)

    @jax.jit
    def pre(images_u8):
        x = images_u8[..., ::-1]
        x = x.astype(jnp.float32) / 255.0
        if (nh, nw) != (h, w):
            x = jax.image.resize(x, (x.shape[0], nh, nw, 3), method="bilinear", antialias=False)
        if (nh, nw) != (size, size):
            canvas = jnp.full((x.shape[0], size, size, 3), pad_color / 255.0, jnp.float32)
            x = jax.lax.dynamic_update_slice(canvas, x, (0, pad_y, pad_x, 0))
        return (x - mean) / std

    return pre


@pytest.mark.parametrize("h,w,size", [(720, 1280, 640), (37, 53, 64), (101, 67, 96),
                                      (48, 80, 64), (64, 64, 64)])
def test_raw_resize_matches_jax(h, w, size):
    """Downscale, upscale, odd sizes, pad only, and no change at all."""
    images = np.stack(_images(h * w, [(h, w), (h, w)]))
    want = np.asarray(_jax_raw_preprocess(h, w, size)(jnp.asarray(images)))
    x = letterbox_raw_batch(torch.from_numpy(images), size)
    mean, std = torch.tensor(IMAGENET_MEAN), torch.tensor(IMAGENET_STD)
    got = ((x - mean) / std).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_roi_pool_matches_jax():
    r = np.random.default_rng(3)
    fmap = r.standard_normal((2, 9, 11, 5)).astype(np.float32)
    xy = r.uniform(0, 0.7, (2, 6, 2))
    boxes = np.concatenate([xy, xy + r.uniform(0.05, 0.3, (2, 6, 2))], -1).astype(np.float32)
    boxes[0, 0] = [0.0, 0.0, 1.0, 1.0]  # samples at the clamped edges
    want = np.asarray(jax_roi_pool(jnp.asarray(fmap), jnp.asarray(boxes)))
    got = roi_pool_bilinear(torch.from_numpy(fmap), torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_inference_metrics_match_jax():
    a, b = InferenceMetrics(latency_target_ms=20.0), JaxInferenceMetrics(latency_target_ms=20.0)
    lat = np.random.default_rng(4).uniform(0.005, 0.05, 50)
    for i, t in enumerate(lat):
        a.record(t, batch_size=1 + i % 4)
        b.record(t, batch_size=1 + i % 4)
    a.record_error()
    b.record_error()
    got, want = a.summary(), b.summary()
    got.pop("throughput_rps"), want.pop("throughput_rps")  # wall-clock based
    assert got == want


def _frames(seed, n=6):
    """Detections over a few frames: boxes drifting, one class flip, one
    detection vanishing and returning."""
    r = np.random.default_rng(seed)
    base = r.uniform(0, 300, (5, 2))
    out = []
    for t in range(n):
        xy = base + t * 4.0 + r.normal(0, 1.0, base.shape)
        boxes = np.concatenate([xy, xy + 40.0], -1).astype(np.float32)
        scores = r.uniform(0.3, 1.0, 5).astype(np.float32)
        classes = np.array([0, 1, 2, 1, 0 if t < 3 else 3], np.int32)
        keep = np.arange(5) != (2 if t == 2 else -1)
        emb = r.standard_normal((5, 8)).astype(np.float32)
        out.append((boxes[keep], scores[keep], classes[keep], emb[keep]))
    return out


def _tracks(tracks):
    return [(t.track_id, t.class_id, t.hits, t.age, np.round(t.smoothed_box(), 4).tolist())
            for t in tracks]


@pytest.mark.parametrize("kind", ["iou", "appearance", "appearance_without_embeddings"])
def test_trackers_match_jax(kind):
    if kind == "iou":
        mine, ref = port_post.DetectionTracker(), jax_post.DetectionTracker()
    else:
        mine, ref = port_post.AppearanceTracker(), jax_post.AppearanceTracker()
    for boxes, scores, classes, emb in _frames(5):
        args = (boxes, scores, classes)
        if kind == "appearance":
            args += (emb,)
        assert _tracks(mine.update(*args)) == _tracks(ref.update(*args))
    assert _tracks(mine.tracks) == _tracks(ref.tracks)


def test_hard_nms_filter_and_postprocessor_match_jax():
    r = np.random.default_rng(6)
    xy = r.uniform(0, 0.8, (60, 2))
    boxes = np.concatenate([xy, xy + r.uniform(0.05, 0.2, (60, 2))], -1).astype(np.float32)
    scores = r.uniform(0, 1, 60).astype(np.float32)
    classes = r.integers(0, 4, 60).astype(np.int32)
    got = port_post.NMSFilter("hard", 0.45, 0.3, 20).apply(boxes, scores, classes)
    want = jax_post.NMSFilter("hard", 0.45, 0.3, 20).apply(boxes, scores, classes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 5
    class_scores = r.uniform(0, 1, (60, 4)).astype(np.float32)
    outputs = {"detection": {"boxes": boxes[None], "scores": class_scores[None]}}
    kwargs = dict(score_threshold=0.3, tracking="iou", calibration_temperature=0.8)
    mine, ref = port_post.DetectionPostprocessor(**kwargs), jax_post.DetectionPostprocessor(**kwargs)
    for _ in range(2):
        g, w = mine.process(outputs, (480, 640)), ref.process(outputs, (480, 640))
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-6, atol=1e-4, err_msg=key)


class _Recorder:
    """A socket that records every byte it sends."""

    def __init__(self, sock):
        self.sock, self.sent = sock, b""

    def sendall(self, data):
        self.sent += data
        self.sock.sendall(data)

    def __getattr__(self, name):
        return getattr(self.sock, name)


def test_robot_wire_format_matches_jax():
    """The bytes on the wire: length-prefixed JSON messages and the ZMTP 3.0
    greeting, READY handshake and frames, the port's socket against the
    reference's over a local socket pair."""
    import socket
    import threading

    msg = {"type": "command", "action": "follow", "bearing_rad": 0.25, "seq": 7}
    assert port_robot.encode_message(msg) == jax_robot.encode_message(msg)
    a, b = socket.socketpair()
    ra, rb = _Recorder(a), _Recorder(b)
    mine, ref = port_transports.ZMTPPairSocket(ra), jax_transports.ZMTPPairSocket(rb)
    t = threading.Thread(target=ref._handshake)
    t.start()
    mine._handshake()
    t.join(5)
    assert ra.sent == rb.sent and len(ra.sent) > 64  # greeting + READY
    assert ra.sent[:64] == jax_transports.ZMTP_SIGNATURE + b"\x03\x00NULL" + b"\x00" * 48
    assert mine.peer_metadata == ref.peer_metadata == {"Socket-Type": b"PAIR"}
    for payload in (b"x" * 10, b"y" * 300):
        ra.sent = rb.sent = b""
        mine.send(payload)
        assert ref.recv() == payload
        ref.send(payload)
        assert mine.recv() == payload
        assert ra.sent == rb.sent
    a.close()
    b.close()
    dets = Detections(boxes=np.array([[10, 20, 110, 220], [300, 40, 420, 300]], np.float32),
                      scores=np.array([0.9, 0.7], np.float32), classes=np.array([0, 2]),
                      class_names=["person", "car"], latency_ms=1.0, image_size=(480, 640))
    got, want = port_robot.commands_from_detections(dets), jax_robot.commands_from_detections(dets)
    assert [vars(c) for c in got] == [vars(c) for c in want] and got
