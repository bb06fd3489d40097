"""Generate the synthetic-shapes COCO-format detection benchmark.

Counterpart of ``scripts/make_shapes_dataset.py``, with its flags and
defaults, through the port's generator (``data/shapes.py``). Host only
(numpy and cv2); no device is used:

    python -m hvs_tpu_torch.make_shapes_dataset --root data/shapes --train 4000 --val 500

The dense form of the multi-task model (masks and depth maps beside the
images) is generated by ``python -m hvs_tpu_torch.train_multitask`` when its
``--data-root`` is absent, as the reference's scripts do.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Generate shapes detection dataset")
    p.add_argument("--root", default="data/shapes")
    p.add_argument("--train", type=int, default=4000)
    p.add_argument("--val", type=int, default=500)
    p.add_argument("--size", type=int, default=416)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-classes", type=int, default=8, choices=(8, 80),
                   help="taxonomy: 8 geometry classes, or the 80-class "
                        "shape x color-family x fill grid")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, str]:
    args = parse_args(argv)
    from .data.shapes import generate_dataset

    t0 = time.time()
    paths = generate_dataset(args.root, num_train=args.train, num_val=args.val,
                             size=args.size, seed=args.seed, num_classes=args.num_classes)
    print(f"generated {args.train}+{args.val} images at {args.size}^2 "
          f"({args.num_classes} classes) in {time.time() - t0:.1f}s")
    for split, path in paths.items():
        print(f"  {split}: {path}")
    return paths


if __name__ == "__main__":
    main()
