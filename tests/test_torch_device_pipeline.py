"""The port's device-resident data pipeline (hvs_tpu_torch.data.device_pipeline)
against the JAX package's (hvs_tpu/data/device_pipeline.py), on the CPU.

The same numpy dataset goes through both. The JAX ``sample_batch`` draws its
random numbers inside; the tests make the same draws with the same
``jax.random`` calls on the same key and hand them to the port's
``apply_augment``, so the two compute the same batch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvs_tpu.data import device_pipeline as jdp
from hvs_tpu_torch.data import device_pipeline as tdp

torch.set_num_threads(1)

N, S, M, B = 8, 64, 6, 4


def _arrays(seed=0):
    r = np.random.default_rng(seed)
    images = r.integers(0, 256, (N, S, S, 3), dtype=np.uint8)
    wh = r.uniform(0.02, 0.6, (N, M, 2))
    wh[:, 0] = 0.02  # under 3 px at every zoom and output size of the tests
    boxes = np.concatenate([r.uniform(wh / 2, 1 - wh / 2), wh], -1).astype(np.float32)
    labels = r.integers(0, 5, (N, M)).astype(np.int32)
    mask = (r.uniform(size=(N, M)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    return images, boxes, labels, mask


def _jax_draws(rng, batch, n, aug, augment):
    """The draws of ``hvs_tpu.data.device_pipeline.sample_batch`` on ``rng``,
    as the port's ``AugmentDraws`` (torch, CPU)."""
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
        tx=u(k_tx, (batch,)),
        ty=u(k_ty, (batch,)),
    )
    return tdp.AugmentDraws(**{k: torch.from_numpy(np.array(v)).to(
        torch.long if k == "idx" else None) for k, v in draws.items()})


def test_augment_config_defaults_match_jax():
    assert dataclasses.asdict(tdp.AugmentConfig()) == dataclasses.asdict(jdp.AugmentConfig())


@pytest.mark.parametrize("scale,tx,ty,out", [(0.6, 7.3, -3.1, 48), (1.0, -5.5, 4.25, 64),
                                             (1.5, -20.0, 11.5, 96), (0.6, 0.0, 0.0, 96)])
def test_warp_images_matches_scale_and_translate(scale, tx, ty, out):
    r = np.random.default_rng(1)
    imgs = r.uniform(size=(2, S, S, 3)).astype(np.float32)
    sc = np.array([scale, scale * 0.9], np.float32)
    txs = np.array([tx, -tx / 2], np.float32)
    tys = np.array([ty, ty / 3], np.float32)
    fill = 114.0 / 255.0
    want = jax.jit(jdp._warp_images, static_argnums=(4, 5))(
        jnp.asarray(imgs), jnp.asarray(sc), jnp.asarray(txs), jnp.asarray(tys), out, fill)
    got = tdp.warp_images(torch.from_numpy(imgs), torch.from_numpy(sc), torch.from_numpy(txs),
                          torch.from_numpy(tys), out, fill)
    assert got.shape == (2, out, out, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("augment,out", [(True, 48), (True, 64), (True, 96), (False, 48),
                                         (False, 64)])
def test_apply_augment_matches_sample_batch(augment, out):
    arrays = _arrays()
    aug = jdp.AugmentConfig()
    jdata = jdp.DeviceData(*(jnp.asarray(a) for a in arrays))
    rng = jax.random.fold_in(jax.random.PRNGKey(3), out + augment)
    want = jax.jit(jdp.sample_batch, static_argnums=(2, 3, 4, 5))(jdata, rng, B, out, aug,
                                                                   augment)
    draws = _jax_draws(rng, B, N, aug, augment)
    got = tdp.apply_augment(tdp.put_device_data(*arrays, device="cpu"), draws, out,
                            tdp.AugmentConfig(), augment)
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    np.testing.assert_array_equal(got["box_mask"].numpy(), np.asarray(want["box_mask"]))
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0,
                               atol=1e-6)
    assert got["images"].shape == (B, out, out, 3) and got["images"].dtype == torch.float32
    np.testing.assert_allclose(got["images"].numpy(), np.asarray(want["images"]), rtol=0,
                               atol=1e-5)
    if augment:
        # The draws take both sides of the flip, and the small boxes of slot
        # 0 are masked out.
        assert draws.flip.any() and not draws.flip.all()
        assert not np.asarray(want["box_mask"])[:, 0].any()


@pytest.mark.parametrize("out", [48, 64])
@pytest.mark.parametrize("start", [0, 4])
def test_eval_batch_matches_jax(start, out):
    arrays = _arrays(seed=2)
    jdata = jdp.DeviceData(*(jnp.asarray(a) for a in arrays))
    want = jax.jit(jdp.eval_batch, static_argnums=(2, 3))(jdata, jnp.int32(start), B, out)
    data = tdp.put_device_data(*arrays, device="cpu")
    for s in (start, torch.tensor(start)):  # a Python or a device start index
        got = tdp.eval_batch(data, s, B, out)
        for k in ("boxes", "labels", "box_mask"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        np.testing.assert_allclose(got["images"].numpy(), np.asarray(want["images"]), rtol=0,
                                   atol=1e-5)


def test_draw_augment_ranges_and_generator_order():
    aug = tdp.AugmentConfig()
    draws = tdp.draw_augment(torch.Generator().manual_seed(5), 256, N, aug)
    assert draws.idx.dtype == torch.long and 0 <= int(draws.idx.min()) \
        and int(draws.idx.max()) < N
    assert draws.flip.dtype == torch.bool and 0.35 < float(draws.flip.float().mean()) < 0.65
    for name, lo, hi in (("brightness", -aug.brightness, aug.brightness),
                         ("contrast", 1 - aug.contrast, 1 + aug.contrast),
                         ("gain", 1 - aug.channel_gain, 1 + aug.channel_gain),
                         ("zoom", aug.zoom_min, aug.zoom_max), ("tx", 0, 1), ("ty", 0, 1)):
        v = getattr(draws, name)
        assert lo <= float(v.min()) and float(v.max()) <= hi, name
    assert draws.gain.shape == (256, 1, 1, 3) and draws.contrast.shape == (256, 1, 1, 1)
    again = tdp.draw_augment(torch.Generator().manual_seed(5), 256, N, aug)
    assert all(torch.equal(a, b) for a, b in zip(draws, again))


def test_put_device_data_dtypes_and_unported_loader(tmp_path):
    data = tdp.put_device_data(*_arrays(), device="cpu")
    assert [t.dtype for t in data] == [torch.uint8, torch.float32, torch.int32, torch.float32]
    # load_coco_arrays is ported (tests/test_torch_data.py); an absent split raises
    with pytest.raises(FileNotFoundError, match="instances_train.json"):
        tdp.load_coco_arrays(str(tmp_path / "absent"), "train")
