# %% [markdown]
# # 01 — Data exploration (PyTorch/CUDA port)
#
# The port's counterpart of `examples/nb_01_data_exploration.py`: generate the
# synthetic-shapes detection benchmark, load it through the COCO adapter,
# inspect class balance and box statistics, draw ground truth, and run the
# transforms and the batched loader. Everything here is host-side numpy; the
# device flag only says where a caller would train on these batches.
#
#     python examples/torch_nb_01_data_exploration.py [--device cpu]
#
# `HVS_NB_TINY=1` runs a small dataset; files go to `$HVS_NB_OUT` (default
# `outputs/torch_nb01`). The last line of standard output is one JSON object
# with the tour's numbers; the kernels' launch counters go to standard error
# as one `{"kernel_launches": ...}` line.

# %%
import argparse
import json
import os
import sys

# Works as a script (repo/examples/) AND inside a notebook kernel
# (cwd = repo root, no __file__).
sys.path.insert(
    0,
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if "__file__" in globals() else os.getcwd(),
)

import numpy as np

from hvs_tpu_torch import resolve_device
from hvs_tpu_torch.training.chunk import kernel_counts

_parser = argparse.ArgumentParser()
_parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
DEVICE = resolve_device(_parser.parse_known_args()[0].device)
TINY = bool(int(os.environ.get("HVS_NB_TINY", "0")))
OUT = os.environ.get("HVS_NB_OUT", "outputs/torch_nb01")
os.makedirs(OUT, exist_ok=True)
print("device:", DEVICE)

# %% [markdown]
# ## Generate the benchmark
#
# 8 classes whose identity is *geometry only* (color is randomized per
# instance), cluttered backgrounds with unlabeled distractors, COCO layout.

# %%
from hvs_tpu_torch.data import SHAPE_CLASSES, generate_shapes_dataset

root = os.path.join(OUT, "shapes")
n_train, n_val = (24, 8) if TINY else (200, 50)
paths = generate_shapes_dataset(root, num_train=n_train, num_val=n_val,
                                size=256, seed=0)
print("splits:", paths)
print("classes:", SHAPE_CLASSES)

# %% [markdown]
# ## Load through the COCO adapter
#
# `COCODataset` parses the instances JSON directly (no pycocotools), remaps
# category ids to contiguous `[0, C)`, and emits static-shape samples:
# letterboxed image, `max_boxes`-padded normalized cxcywh boxes + mask.

# %%
from hvs_tpu_torch.data import COCODataset

counts = {}
for split in paths:
    counts[split] = len(COCODataset(root=os.path.join(root, split),
                                    annotation_file=paths[split], image_size=256))
ds = COCODataset(root=os.path.join(root, "train"),
                 annotation_file=paths["train"],
                 image_size=256, max_boxes=16)
print(f"{len(ds)} images, {len(ds.class_names)} classes")
sample = ds[0]
for k, v in sample.items():
    print(f"  {k}: shape={getattr(v, 'shape', v)} dtype={getattr(v, 'dtype', '')}")

# %% [markdown]
# ## Class balance and box statistics

# %%
dist = ds.class_distribution()
for cid, count in sorted(dist.items()):
    bar = "#" * max(1, count // 2)
    print(f"{ds.class_names[cid]:>10}: {count:4d} {bar}")

areas, aspects = [], []
for anns in ds.annotations.values():
    for a in anns:
        _, _, w, h = a["bbox"]
        areas.append(w * h)
        aspects.append(w / max(h, 1e-6))
areas, aspects = np.asarray(areas), np.asarray(aspects)
print(f"\nbox area   p10/p50/p90: {np.percentile(areas, [10, 50, 90]).round(0)}")
print(f"box aspect p10/p50/p90: {np.percentile(aspects, [10, 50, 90]).round(2)}")

# %% [markdown]
# ## Visualize ground truth

# %%
drawn = []
for i in range(min(3, len(ds))):
    path = ds.visualize_sample(i, os.path.join(OUT, f"gt_{i}.png"))
    drawn.append(path)
    print("wrote", path)

# %% [markdown]
# ## Augmentation pipeline
#
# The train transform composes flip / color jitter / crop / erasing (plus
# mosaic & mixup at the loader level). Box coordinates ride along through
# every op.

# %%
from hvs_tpu_torch.data import MHCTransformComposer
from hvs_tpu_torch.data.dataset import load_image

tf = MHCTransformComposer.train_default(256)
info = ds.images[0]
img = load_image(ds._resolve_path(info["file_name"]))
anns = ds.annotations[info["id"]]
boxes = np.asarray([a["bbox"] for a in anns], np.float32)
labels = np.asarray([a["category_id"] for a in anns], np.int32)
aug_img, aug_boxes, aug_labels = tf(img, boxes.copy(), labels.copy())
print("before:", img.shape, len(boxes), "boxes")
print("after: ", aug_img.shape, len(aug_boxes), "boxes")

# %% [markdown]
# ## Batched loading
#
# `MHCDataLoader` is a thread-pool loader producing stacked numpy batches with
# static shapes, so a captured train step takes every batch unchanged.

# %%
from hvs_tpu_torch.data import MHCDataLoader

loader = MHCDataLoader(ds, batch_size=4, shuffle=True, num_workers=2,
                       drop_last=True)
batch = next(iter(loader))
print({k: v.shape for k, v in batch.items()})
print("boxes per image in batch:", batch["box_mask"].sum(-1))

# %%
print(json.dumps({"kernel_launches": kernel_counts()}), file=sys.stderr, flush=True)
print(json.dumps({
    "tour": "nb_01", "device": str(DEVICE), "root": root, "annotations": paths,
    "images": counts,
    "class_names": list(ds.class_names),
    "class_histogram": {ds.class_names[c]: int(n) for c, n in sorted(dist.items())},
    "sample0_boxes": int(np.asarray(sample["box_mask"]).sum()),
    "ground_truth_drawn": len([p for p in drawn if p]),
    "augmented_boxes": int(len(aug_boxes)),
    "batch_shapes": {k: list(v.shape) for k, v in batch.items()},
}), flush=True)
