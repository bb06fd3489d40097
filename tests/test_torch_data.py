"""The port's data layer (hvs_tpu_torch.data: the shapes generator, the host
dataset, COCO reader, transforms and loaders, ``load_coco_arrays``; and
``config.training``) against the JAX package's, on the CPU.

The same seeds and files go through both packages. The host modules are
copies in numpy and cv2, so their results are held exactly: arrays equal,
files byte for byte, evaluator-free. ``batch_augment_device`` is held
against JAX's with JAX's own draws fed to the port's deterministic half,
within 1e-6 (fp32, the same operations in the same order).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvs_tpu.config import TrainingConfig as JaxTrainingConfig
from hvs_tpu.config import load_config as jax_load_config
from hvs_tpu.data import coco as jcoco
from hvs_tpu.data import dataset as jdataset
from hvs_tpu.data import device_pipeline as jdp
from hvs_tpu.data import loader as jloader
from hvs_tpu.data import shapes as jshapes
from hvs_tpu.data import transforms as jtf
from hvs_tpu_torch.config import TrainingConfig, create_default_configs, load_config
from hvs_tpu_torch.data import coco as tcoco
from hvs_tpu_torch.data import dataset as tdataset
from hvs_tpu_torch.data import device_pipeline as tdp
from hvs_tpu_torch.data import loader as tloader
from hvs_tpu_torch.data import shapes as tshapes
from hvs_tpu_torch.data import transforms as ttf
from hvs_tpu_torch.training import TrainerConfig

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _equal_samples(a, b, where=""):
    assert set(a) == set(b), where
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (where, k)
        assert np.array_equal(x, y), (where, k)


def _tree_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """cv2-written JPEGs of varied sizes + a standardized JSON, as
    tests/test_data.py's ``synthetic_dataset_dir``."""
    root = tmp_path_factory.mktemp("torch_synth")
    rng = np.random.default_rng(0)
    images, annotations = [], []
    for i in range(6):
        h, w = int(rng.integers(60, 120)), int(rng.integers(60, 120))
        cv2.imwrite(str(root / f"img_{i}.jpg"), rng.integers(0, 255, (h, w, 3), np.uint8))
        images.append({"id": i, "file_name": f"img_{i}.jpg", "width": w, "height": h})
        for _ in range(int(rng.integers(1, 4))):
            bw, bh = int(rng.integers(10, 30)), int(rng.integers(10, 30))
            x, y = int(rng.integers(0, max(w - bw, 1))), int(rng.integers(0, max(h - bh, 1)))
            annotations.append({"image_id": i, "bbox": [x, y, bw, bh],
                                "category_id": int(rng.integers(0, 4))})
    ann = root / "annotations.json"
    ann.write_text(json.dumps({"images": images, "annotations": annotations}))
    return str(root), str(ann)


@pytest.fixture(scope="module")
def shapes_root(tmp_path_factory):
    """A tiny shapes benchmark (8 classes, 96², 8 train / 4 val) written by
    the JAX generator, read by both packages."""
    root = str(tmp_path_factory.mktemp("torch_shapes"))
    jshapes.generate_dataset(root, num_train=8, num_val=4, size=96, seed=3)
    return root


@pytest.fixture(scope="module")
def dense_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_shapes_dense"))
    jshapes.generate_dataset(root, num_train=4, num_val=2, size=64, seed=4, with_dense=True)
    return root


# ---------------------------------------------------------------------------
# The shapes generator


def test_shapes_taxonomies_match_jax():
    assert tshapes.SHAPE_CLASSES == jshapes.SHAPE_CLASSES
    assert tshapes.SHAPE80_CLASSES == jshapes.SHAPE80_CLASSES
    assert tshapes.COLOR_FAMILIES == jshapes.COLOR_FAMILIES
    assert tshapes.SIZE_BUCKETS == jshapes.SIZE_BUCKETS
    assert np.array_equal(tshapes._PALETTE, jshapes._PALETTE)
    for n in (8, 80):
        assert tshapes.class_names_for(n) == jshapes.class_names_for(n)
    with pytest.raises(ValueError, match="8 or 80"):
        tshapes.class_names_for(10)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("num_classes", [8, 80])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_image_matches_jax(seed, num_classes, dense):
    def gen(mod):
        rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
        out = mod.generate_image(rng, size=96, with_dense=dense, num_classes=num_classes)
        return out, rng.integers(0, 2**31)  # the stream's state after the image

    (want, want_next), (got, got_next) = gen(jshapes), gen(tshapes)
    assert len(got) == len(want) == (5 if dense else 3) and got_next == want_next
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("dense,num_classes", [(False, 8), (True, 8), (False, 80)])
def test_generate_dataset_files_match_jax(tmp_path, dense, num_classes):
    kw = dict(num_train=3, num_val=2, size=64, seed=11, with_dense=dense,
              num_classes=num_classes)
    want = jshapes.generate_dataset(str(tmp_path / "jax"), **kw)
    got = tshapes.generate_dataset(str(tmp_path / "port"), **kw)
    assert {k: os.path.relpath(v, tmp_path / "port") for k, v in got.items()} == \
        {k: os.path.relpath(v, tmp_path / "jax") for k, v in want.items()}
    jf, tf = _tree_files(tmp_path / "jax"), _tree_files(tmp_path / "port")
    assert sorted(tf) == sorted(jf) and len(tf) == 2 + 5 * (3 if dense else 1)
    for name in jf:
        assert tf[name] == jf[name], name


def test_make_shapes_dataset_entry_point(tmp_path):
    from hvs_tpu_torch.make_shapes_dataset import main, parse_args

    assert vars(parse_args([])) == {"root": "data/shapes", "train": 4000, "val": 500,
                                    "size": 416, "seed": 0, "num_classes": 8}
    paths = main(["--root", str(tmp_path / "d"), "--train", "2", "--val", "1", "--size", "64",
                  "--num-classes", "80"])
    ann = json.loads(open(paths["val"]).read())
    assert len(ann["images"]) == 1 and len(ann["categories"]) == 80
    want = jshapes.generate_dataset(str(tmp_path / "j"), num_train=2, num_val=1, size=64,
                                    num_classes=80)
    assert open(paths["train"], "rb").read() == open(want["train"], "rb").read()


# ---------------------------------------------------------------------------
# The host dataset and the COCO reader


def test_letterbox_cv2_matches_jax(image_dir):
    root, _ = image_dir
    for i in range(6):
        img = tdataset.load_image(os.path.join(root, f"img_{i}.jpg"))
        assert np.array_equal(img, jdataset.load_image(os.path.join(root, f"img_{i}.jpg")))
        for size in (64, 100):
            got, want = tdataset.letterbox_cv2(img, size), jdataset.letterbox(img, size)
            assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    with pytest.raises(FileNotFoundError):
        tdataset.load_image(os.path.join(root, "absent.jpg"))


@pytest.mark.parametrize("mode", ["float", "normalized", "uint8", "multi_task"])
def test_base_dataset_samples_match_jax(image_dir, mode):
    root, ann = image_dir
    kw = dict(image_size=64, max_boxes=3, normalize=mode != "float", as_uint8=mode == "uint8",
              task="multi_task" if mode == "multi_task" else "detection")
    jd, td = jdataset.BaseVisionDataset(root, ann, **kw), tdataset.BaseVisionDataset(root, ann, **kw)
    assert len(td) == len(jd) == 6
    for i in range(6):
        _equal_samples(td[i], jd[i], i)
    assert td.class_distribution() == jd.class_distribution()


def test_base_dataset_cache_skip_and_limit_match_jax(image_dir, tmp_path):
    root, ann = image_dir
    data = json.loads(open(ann).read())
    data["images"].append({"id": 99, "file_name": "img_0.jpg", "width": 1, "height": 1})
    path = tmp_path / "with_empty.json"
    path.write_text(json.dumps(data))
    for kw in (dict(skip_empty=True), dict(max_samples=4, cache_images=True), {}):
        jd = jdataset.BaseVisionDataset(root, str(path), image_size=48, **kw)
        td = tdataset.BaseVisionDataset(root, str(path), image_size=48, **kw)
        assert [im["id"] for im in td.images] == [im["id"] for im in jd.images], kw
        for i in range(len(td)):
            _equal_samples(td[i], jd[i], (kw, i))
            _equal_samples(td[i], jd[i], (kw, i, "again"))
        assert len(td._image_cache) == (len(td) if kw.get("cache_images") else 0)
    out = td.visualize_sample(0, str(tmp_path / "vis.jpg"))
    assert out and cv2.imread(out) is not None


def _coco_file(tmp_path, root):
    """A COCO instances file over ``root``'s images: sparse 1-based category
    ids in shuffled order, a crowd box, a box of an unknown category, an
    image without boxes."""
    data = json.loads(open(os.path.join(root, "annotations.json")).read())
    cats = [{"id": 17, "name": "cat"}, {"id": 3, "name": "car"}, {"id": 5, "name": "dog"},
            {"id": 9, "name": "bus"}]
    ids = [3, 5, 9, 17]
    anns = []
    for k, a in enumerate(data["annotations"]):
        if a["image_id"] == 5:
            continue
        anns.append({"id": k + 1, "image_id": a["image_id"], "bbox": a["bbox"],
                     "category_id": ids[a["category_id"]], "iscrowd": int(k % 7 == 3)})
    anns.append({"id": 999, "image_id": 0, "bbox": [1, 1, 5, 5], "category_id": 42,
                 "iscrowd": 0})
    path = tmp_path / "instances.json"
    path.write_text(json.dumps({"images": data["images"], "annotations": anns,
                                "categories": cats}))
    return str(path)


@pytest.mark.parametrize("class_filter", [None, ("dog", "cat")])
@pytest.mark.parametrize("skip_empty", [True, False])
def test_coco_dataset_matches_jax(image_dir, tmp_path, class_filter, skip_empty):
    root, _ = image_dir
    ann = _coco_file(tmp_path, root)
    kw = dict(image_size=64, max_boxes=4, class_filter=class_filter, skip_empty=skip_empty)
    td = tcoco.COCODataset(root, ann, **kw)
    assert sorted(os.listdir(tmp_path)) == ["instances.json"]  # the port writes nothing
    jd = jcoco.COCODataset(root, ann, **kw)
    assert td.class_names == jd.class_names == ["car", "dog", "bus", "cat"]
    assert td.cat_id_to_contiguous == jd.cat_id_to_contiguous
    assert [im["id"] for im in td.images] == [im["id"] for im in jd.images]
    assert td.annotations == jd.annotations
    for i in range(len(td)):
        _equal_samples(td[i], jd[i], i)


def test_coco_dataset_reads_the_shapes_benchmark(shapes_root):
    for split in ("train", "val"):
        kw = dict(root=os.path.join(shapes_root, split),
                  annotation_file=os.path.join(shapes_root, "annotations",
                                               f"instances_{split}.json"),
                  image_size=64, max_boxes=16, as_uint8=True)
        td, jd = tcoco.COCODataset(**kw), jcoco.COCODataset(**kw)
        assert td.class_names == list(tshapes.SHAPE_CLASSES) and len(td) == len(jd)
        for i in range(len(td)):
            _equal_samples(td[i], jd[i], (split, i))


# ---------------------------------------------------------------------------
# Host transforms


def _sample(seed, h=70, w=90, n=4):
    r = np.random.default_rng(seed)
    img = r.integers(0, 256, (h, w, 3), np.uint8)
    wh = r.uniform(8, 30, (n, 2))
    xy = r.uniform(0, 1, (n, 2)) * (np.asarray([w, h]) - wh)
    return img, np.concatenate([xy, wh], 1).astype(np.float32), r.integers(0, 5, n).astype(np.int32)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("name", ["hflip", "color_jitter", "random_resized_crop", "rotate_small",
                                  "random_erasing"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transform_matches_jax(name, seed):
    img, boxes, labels = _sample(seed)
    rj, rt = np.random.default_rng(seed + 10), np.random.default_rng(seed + 10)
    want = getattr(jtf, name)(img, boxes, labels, rj)
    got = getattr(ttf, name)(img, boxes, labels, rt)
    _same(got, want)
    assert rt.integers(0, 2**31) == rj.integers(0, 2**31)  # the same draws were made


@pytest.mark.parametrize("seed", [0, 1])
def test_mosaic_and_mixup_match_jax(seed):
    samples = [_sample(seed * 4 + k, h=50 + 10 * k, w=60 + 5 * k, n=k) for k in range(4)]
    _same(ttf.mosaic(samples, np.random.default_rng(seed), out_size=64),
          jtf.mosaic(samples, np.random.default_rng(seed), out_size=64))
    _same(ttf.mosaic(samples, np.random.default_rng(seed)),
          jtf.mosaic(samples, np.random.default_rng(seed)))
    _same(ttf.mixup(samples[1], samples[2], np.random.default_rng(seed)),
          jtf.mixup(samples[1], samples[2], np.random.default_rng(seed)))
    _same(ttf.mixup(samples[0], samples[0], np.random.default_rng(seed)),
          jtf.mixup(samples[0], samples[0], np.random.default_rng(seed)))


@pytest.mark.parametrize("adaptive", [False, True])
def test_composer_matches_jax(adaptive):
    aug = TrainingConfig(device="cpu").augmentation
    aug.adaptive_decay_epochs = 4 if adaptive else 0
    jc = jtf.MHCTransformComposer.train_default(64, aug)
    tc = ttf.MHCTransformComposer.train_default(64, aug)
    assert vars(tc).keys() == vars(jc).keys()
    for epoch in range(3):
        if adaptive:
            assert tc.adaptive.step_epoch() == jc.adaptive.step_epoch()
        for seed in range(8):
            _same(tc(*_sample(seed)), jc(*_sample(seed)))
    assert dataclasses.asdict(ttf.AdaptiveAugmentation(epoch=7)) == \
        dataclasses.asdict(jtf.AdaptiveAugmentation(epoch=7))
    assert ttf.AdaptiveAugmentation(epoch=7).strength == jtf.AdaptiveAugmentation(epoch=7).strength


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_augment_matches_jax_on_its_draws(seed):
    images = np.random.default_rng(seed).uniform(-2, 2, (5, 8, 12, 3)).astype(np.float32)
    key, flip_p, jitter = jax.random.PRNGKey(seed), 0.5, 0.2
    want, want_flip = jtf.batch_augment_device(jnp.asarray(images), key, flip_p, jitter)
    k1, k2, k3 = jax.random.split(key, 3)
    u = jax.random.uniform
    draws = ttf.BatchAugmentDraws(*[torch.from_numpy(np.array(x)) for x in (
        u(k1, (5, 1, 1, 1)), u(k2, (5, 1, 1, 1), minval=1 - jitter, maxval=1 + jitter),
        u(k3, (5, 1, 1, 1), minval=1 - jitter, maxval=1 + jitter))])
    got, got_flip = ttf.apply_batch_augment(torch.from_numpy(images), draws, flip_p)
    assert np.array_equal(got_flip.numpy(), np.asarray(want_flip))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_batch_augment_draws_from_its_generator():
    images = torch.rand(6, 4, 5, 3, generator=torch.Generator().manual_seed(0))
    a = ttf.batch_augment_device(images, torch.Generator().manual_seed(3))
    b = ttf.batch_augment_device(images, torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    draws = ttf.draw_batch_augment(6, torch.Generator().manual_seed(3))
    assert all(d.shape == (6, 1, 1, 1) for d in draws)
    assert ((draws.brightness >= 0.8) & (draws.brightness < 1.2)).all()
    out, flipped = a
    for i in range(6):
        src = images[i].flip(1) if flipped[i] else images[i]
        assert torch.allclose(out[i], (src * draws.brightness[i] - src.mean())
                              * draws.contrast[i] + src.mean(), atol=1e-6)


# ---------------------------------------------------------------------------
# Host loaders


@pytest.mark.parametrize("shuffle,accum,workers,drop_last", [
    (False, 1, 1, True), (True, 1, 2, True), (True, 2, 3, True), (False, 1, 2, False)])
def test_loader_batches_match_jax(image_dir, shuffle, accum, workers, drop_last):
    root, ann = image_dir
    ds = tdataset.BaseVisionDataset(root, ann, image_size=48, max_boxes=4)
    jds = jdataset.BaseVisionDataset(root, ann, image_size=48, max_boxes=4)
    kw = dict(batch_size=2 if drop_last else 4, shuffle=shuffle, num_workers=workers,
              drop_last=drop_last, seed=5, gradient_accumulation_steps=accum)
    tl, jl = tloader.MHCDataLoader(ds, **kw), jloader.MHCDataLoader(jds, **kw)
    assert len(tl) == len(jl)
    for epoch in range(2):
        got, want = list(tl), list(jl)
        assert len(got) == len(want) > 0 and tl.epoch == jl.epoch == epoch + 1
        for g, w in zip(got, want):
            _equal_samples(g, w, epoch)


def test_loader_surfaces_worker_errors(image_dir):
    root, ann = image_dir

    class Broken(tdataset.BaseVisionDataset):
        def __getitem__(self, idx):
            if idx == 3:
                raise KeyError("broken sample")
            return super().__getitem__(idx)

    loader = tloader.MHCDataLoader(Broken(root, ann, image_size=32), batch_size=2,
                                   num_workers=2)
    with pytest.raises(KeyError, match="broken sample"):
        list(loader)
    assert tloader.default_collate([{"a": np.zeros(2)}, {"a": np.ones(2)}])["a"].shape == (2, 2)


def test_loader_abandoned_iterator_exits_cleanly(image_dir):
    """Breaking out of a loader loop joins its workers: a thread still inside
    cv2 at interpreter teardown would abort the process (SIGABRT)."""
    root, ann = image_dir
    code = textwrap.dedent(f"""
        import threading
        from hvs_tpu_torch.data import BaseVisionDataset, MHCDataLoader
        ds = BaseVisionDataset({root!r}, {ann!r}, image_size=64, max_boxes=8)
        loader = MHCDataLoader(ds, batch_size=2, num_workers=2, prefetch=4)
        it = iter(loader)
        batch = next(it)   # abandon the iterator mid-epoch
        it.close()
        print("got", batch["images"].shape, threading.active_count())
    """)
    for _ in range(3):  # teardown race: give it several chances to fail
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=120, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
        assert proc.returncode == 0, proc.stderr[-800:]
        assert proc.stdout.split() == ["got", "(2,", "64,", "64,", "3)", "1"]


def test_streaming_loader_reads_a_video(tmp_path):
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (32, 24))
    for i in range(6):
        writer.write(np.full((24, 32, 3), 40 * i, np.uint8))
    writer.release()
    loader = tloader.StreamingDataLoader(path, target_fps=0, buffer_size=8,
                                         preprocess=lambda f: f.shape).start()
    frames = list(loader)
    loader.stop()
    assert frames == [(24, 32, 3)] * 6
    assert loader.stats() == {"frames_captured": 6, "frames_dropped": 0, "buffer_fill": 0}
    with pytest.raises(RuntimeError, match="cannot open"):
        tloader.StreamingDataLoader(str(tmp_path / "absent.avi")).start()


@pytest.mark.parametrize("split", ["train", "val"])
def test_coco_data_module_batches_match_jax(shapes_root, split):
    """Augmented train batches (the composer's draws in sample order, one
    worker) and plain val batches, both uint8, equal to JAX's."""
    kw = dict(root=shapes_root, image_size=64, batch_size=2, max_boxes=8, num_workers=1,
              train_split="train", val_split="val",
              augmentation_config=TrainingConfig(device="cpu").augmentation)
    tdm, jdm = tcoco.COCODataModule(**kw), jcoco.COCODataModule(**kw)
    tdm.setup()
    jdm.setup()
    make = "train_dataloader" if split == "train" else "val_dataloader"
    for _ in range(2):  # two epochs: the composer's stream runs on
        got, want = list(getattr(tdm, make)()), list(getattr(jdm, make)())
        assert len(got) == len(want) == (4 if split == "train" else 2)
        for g, w in zip(got, want):
            assert g["images"].dtype == np.uint8
            _equal_samples(g, w)


# ---------------------------------------------------------------------------
# load_coco_arrays


@pytest.mark.parametrize("limit,max_boxes", [(None, 16), (3, 4)])
def test_load_coco_arrays_matches_jax(shapes_root, limit, max_boxes):
    for split in ("train", "val"):
        got = tdp.load_coco_arrays(shapes_root, split, max_boxes=max_boxes, limit=limit)
        want = jdp.load_coco_arrays(shapes_root, split, max_boxes=max_boxes, limit=limit)
        _same(got, want)
    data = tdp.put_device_data(*got, device="cpu")
    assert all(np.array_equal(t.numpy(), a) for t, a in zip(data, got))


def test_load_coco_arrays_dense_matches_jax(dense_root):
    got = tdp.load_coco_arrays(dense_root, "train", max_boxes=8, dense=True)
    _same(got, jdp.load_coco_arrays(dense_root, "train", max_boxes=8, dense=True))
    assert len(got) == 6 and got[4].dtype == np.uint8 and got[5].dtype == np.float32
    data = tdp.put_dense_data(*got, device="cpu")
    assert all(np.array_equal(t.numpy(), a) for t, a in zip(data, got))


def test_load_coco_arrays_refuses_mixed_sizes(image_dir, tmp_path):
    root, ann = image_dir
    os.makedirs(tmp_path / "annotations")
    data = json.loads(open(ann).read())
    data["images"] = [dict(im, height=64, width=64 + (i == 0)) for i, im in
                      enumerate(data["images"])]
    (tmp_path / "annotations" / "instances_x.json").write_text(json.dumps(data))
    os.symlink(root, tmp_path / "x")
    with pytest.raises(ValueError, match="uniform square"):
        tdp.load_coco_arrays(str(tmp_path), "x")


# ---------------------------------------------------------------------------
# Training config


def test_training_config_defaults_match_jax():
    port, jaxc = TrainingConfig(device="cpu"), JaxTrainingConfig(device="cpu")
    assert port.to_dict() == jaxc.to_dict()
    for nc in (8, 80):
        got = dataclasses.asdict(port.trainer_config(num_classes=nc))
        want = dataclasses.asdict(jaxc.trainer_config(num_classes=nc))
        assert isinstance(port.trainer_config(), TrainerConfig)
        assert set(got) == set(want)
        assert {k: got[k] for k in want} == want


def test_training_config_file_round_trip_matches_jax(tmp_path):
    """configs/shapes_training.yaml read by both, field by field (its
    device is the JAX package's, so the port's is overridden to the CPU),
    then the port's YAML and JSON round trips."""
    import yaml

    src = os.path.join(REPO, "configs", "shapes_training.yaml")
    data = yaml.safe_load(open(src))
    (tmp_path / "shapes_training.yaml").write_text(yaml.safe_dump(dict(data, device="cpu")))
    port = load_config(str(tmp_path / "shapes_training.yaml"))
    jaxc = jax_load_config(src)
    assert isinstance(port, TrainingConfig)
    assert {k: v for k, v in port.to_dict().items() if k != "device"} == \
        {k: v for k, v in jaxc.to_dict().items() if k != "device"}
    want = dataclasses.asdict(jaxc.trainer_config(num_classes=8))
    got = dataclasses.asdict(port.trainer_config(num_classes=8))
    assert {k: got[k] for k in want} == want
    for suffix in ("yaml", "json"):
        path = str(tmp_path / f"training.{suffix}")
        port.save(path)
        back = load_config(path, "training")
        assert isinstance(back, TrainingConfig) and back.to_dict() == port.to_dict()
    with pytest.raises(RuntimeError, match="tpu"):
        load_config(src)  # a device the port does not run on


def test_create_default_configs_writes_training_yaml(tmp_path, monkeypatch):
    """The port writes JAX's three default files; the defaults resolve to
    the card, so on a host without one the device is taken as the CPU."""
    import hvs_tpu_torch.config.base as base

    if not torch.cuda.is_available():
        monkeypatch.setattr(base, "_resolve_device", lambda device: "cpu")
    create_default_configs(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["inference.yaml", "model.yaml", "training.yaml"]
    back = load_config(str(tmp_path / "training.yaml"))
    assert isinstance(back, TrainingConfig)
    assert {k: v for k, v in back.to_dict().items() if k != "device"} == \
        {k: v for k, v in JaxTrainingConfig(device="cpu").to_dict().items() if k != "device"}


def test_data_package_imports_without_cv2():
    code = ("import sys\nsys.modules['cv2'] = None\n"
            "import hvs_tpu_torch.data, hvs_tpu_torch.evaluate, hvs_tpu_torch.config\n"
            "from hvs_tpu_torch.data import transforms\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-800:]
