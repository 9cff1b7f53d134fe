"""Render original vs two-view augmented samples for eyeballing.

The port's copy of the JAX package's scripts/visualize_augmented_samples.py
(reference tests/visualize_augmented_datasamples.py): a grid of
(original, view 1, view 2) rows through the port's ``data/registry.py:
get_data`` and its host augmentation (``data/augment.py``). Pillow only;
it runs on the host.

    python -m count_pipnet_tpu_torch.scripts.visualize_augmented_samples \
        --dataset geometric_shapes --image_size 64 --out aug_samples.png \
        [--n 4] [--basepath ./] [--seed 0]
"""

import argparse
import random
import sys
from types import SimpleNamespace

import numpy as np
from PIL import Image

from ..data.augment import IMAGENET_MEAN, IMAGENET_STD
from ..data.registry import get_data

CELL = 128


def denormalize(arr):
    arr = arr * np.asarray(IMAGENET_STD) + np.asarray(IMAGENET_MEAN)
    return Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8))


def render_sheet(dataset, image_size, basepath="./", n=4, seed=0):
    """The (original | view 1 | view 2) grid of ``n`` seeded training
    samples as a PIL image, ``CELL`` pixels a cell."""
    args = SimpleNamespace(dataset=dataset, image_size=image_size,
                           validation_size=0.0, seed=seed)
    trainset, _pre, _normal, _aug, projectset, *_rest = get_data(
        args, basepath)
    rng = random.Random(seed)
    grid = Image.new("RGB", (3 * CELL, n * CELL), "white")
    for i in range(n):
        idx = rng.randrange(len(trainset))
        v1, v2, _y = trainset[(idx, random.Random(seed * 1000 + i))]
        orig, _ = projectset[(idx if len(projectset) > idx else 0,
                              random.Random(0))]
        for col, arr in enumerate((orig, v1, v2)):
            grid.paste(denormalize(arr).resize((CELL, CELL)),
                       (col * CELL, i * CELL))
    return grid


def main(argv=None):
    ap = argparse.ArgumentParser("Visualize augmented data samples")
    ap.add_argument("--dataset", default="geometric_shapes")
    ap.add_argument("--image_size", type=int, default=192)
    ap.add_argument("--basepath", default="./")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="aug_samples.png")
    args = ap.parse_args(argv)
    render_sheet(args.dataset, args.image_size, args.basepath, args.n,
                 args.seed).save(args.out)
    print(f"original | view1 | view2 grid -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
