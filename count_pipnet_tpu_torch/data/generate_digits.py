"""MNIST-counting synthetic dataset generator.

The port's copy of count_pipnet_tpu/data/generate_digits.py (numpy and
Pillow only): for the same flags and seed it writes the same PNG files,
byte for byte. Run it as ``python -m
count_pipnet_tpu_torch.data.generate_digits --output_dir ...``.

Capability parity with the reference (util/generate_digits_data.py):
classes are (digit, count) pairs — default {(1,1), (9,1), (1,3), (9,3)}
(reference :46-54) — written in ImageFolder layout, digits placed on a
noisy background (noise level 50, reference :25-55), with overlap-controlled
placement like the shapes generator.

Digit sprites come from a local torchvision MNIST copy when one exists
(nothing is downloaded); otherwise they are rasterized from PIL's
built-in font — same generator contract, synthetic glyphs.
"""

import argparse

import os
import random
from typing import Dict, List, Optional

import numpy as np
from PIL import Image, ImageDraw, ImageFont

__all__ = ["MNISTCountingGenerator", "DEFAULT_DIGITS_CONFIG"]

DEFAULT_DIGITS_CONFIG = {
    "output_dir": "./data/mnist_counting/dataset",
    "img_size": 192,
    "train_samples_per_class": 100,
    "test_samples_per_class": 20,
    "seed": 42,
    "digit_size": 28,
    "scale_range": (0.8, 1.2),
    "max_overlap": 0.15,
    "noise_level": 50,
    "mnist_root": "./data",   # searched for a local MNIST copy
    "class_definitions": [(1, 1), (9, 1), (1, 3), (9, 3)],
}


def _load_mnist_sprites(root) -> Optional[Dict[int, List[np.ndarray]]]:
    """Try loading digit sprites from a local torchvision MNIST copy."""
    try:
        from torchvision.datasets import MNIST
        ds = MNIST(root=str(root), train=True, download=False)
    except Exception:
        return None
    sprites: Dict[int, List[np.ndarray]] = {d: [] for d in range(10)}
    data = ds.data.numpy()
    targets = ds.targets.numpy()
    for img, t in zip(data, targets):
        if len(sprites[int(t)]) < 500:
            sprites[int(t)].append(img)
    return sprites


def _font_sprites(digit_size: int) -> Dict[int, List[np.ndarray]]:
    """Fallback sprites rendered from PIL's built-in font."""
    try:
        font = ImageFont.load_default(size=digit_size - 4)
    except TypeError:  # older PIL
        font = ImageFont.load_default()
    sprites = {}
    for d in range(10):
        img = Image.new("L", (digit_size, digit_size), 0)
        draw = ImageDraw.Draw(img)
        bbox = draw.textbbox((0, 0), str(d), font=font)
        w, h = bbox[2] - bbox[0], bbox[3] - bbox[1]
        draw.text(((digit_size - w) / 2 - bbox[0],
                   (digit_size - h) / 2 - bbox[1]),
                  str(d), fill=255, font=font)
        sprites[d] = [np.asarray(img)]
    return sprites


def _box_overlap_frac(a, b):
    ix = max(0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    denom = min((a[2] - a[0]) * (a[3] - a[1]),
                (b[2] - b[0]) * (b[3] - b[1]))
    return inter / denom if denom > 0 else 1.0


class MNISTCountingGenerator:
    def __init__(self, config: Optional[Dict] = None):
        self.config = dict(DEFAULT_DIGITS_CONFIG)
        if config:
            self.config.update(config)
        c = self.config
        self.img_size = c["img_size"]
        self.rng = random.Random(c["seed"])
        self.np_rng = np.random.default_rng(c["seed"])
        self.sprites = _load_mnist_sprites(c["mnist_root"])
        if self.sprites is None:
            print("No local MNIST copy found; using PIL font digit sprites.")
            self.sprites = _font_sprites(c["digit_size"])

    def _place(self, count, size):
        boxes, placed = [], []
        margin = size
        for _ in range(count):
            for _attempt in range(50):
                x = self.rng.uniform(margin, self.img_size - margin)
                y = self.rng.uniform(margin, self.img_size - margin)
                box = (x - size / 2, y - size / 2, x + size / 2, y + size / 2)
                if all(_box_overlap_frac(box, b) <= self.config["max_overlap"]
                       for b in boxes):
                    break
            placed.append((x, y))
            boxes.append(box)
        return placed

    def generate_image(self, digit: int, count: int) -> Image.Image:
        c = self.config
        noise = c["noise_level"]
        bg = self.np_rng.integers(
            0, max(noise, 1), size=(self.img_size, self.img_size),
            dtype=np.uint8) if noise > 0 else np.zeros(
                (self.img_size, self.img_size), np.uint8)
        canvas = bg.astype(np.int32)
        scale = self.rng.uniform(*c["scale_range"])
        size = int(round(c["digit_size"] * scale))
        for (x, y) in self._place(count, size):
            sprite = self.sprites[digit][
                self.rng.randrange(len(self.sprites[digit]))]
            sp = Image.fromarray(sprite).resize((size, size), Image.BILINEAR)
            sp = np.asarray(sp, dtype=np.int32)
            x0 = int(round(x - size / 2))
            y0 = int(round(y - size / 2))
            x0 = max(0, min(x0, self.img_size - size))
            y0 = max(0, min(y0, self.img_size - size))
            region = canvas[y0:y0 + size, x0:x0 + size]
            canvas[y0:y0 + size, x0:x0 + size] = np.maximum(region, sp)
        arr = np.clip(canvas, 0, 255).astype(np.uint8)
        return Image.fromarray(arr, "L").convert("RGB")

    def generate_dataset(self, train_samples_per_class=None,
                         test_samples_per_class=None):
        c = self.config
        n_train = (train_samples_per_class
                   if train_samples_per_class is not None
                   else c["train_samples_per_class"])
        n_test = (test_samples_per_class
                  if test_samples_per_class is not None
                  else c["test_samples_per_class"])
        for i, (digit, count) in enumerate(c["class_definitions"], start=1):
            for split, n in (("train", n_train), ("test", n_test)):
                cdir = os.path.join(c["output_dir"], split, f"class_{i}")
                os.makedirs(cdir, exist_ok=True)
                for j in range(n):
                    img = self.generate_image(digit, count)
                    img.save(os.path.join(cdir, f"d{digit}_c{count}_{j}.png"))
        print(f"Dataset written to {c['output_dir']}")


def main(argv=None):
    p = argparse.ArgumentParser("Generate MNIST-counting dataset")
    p.add_argument("--output_dir",
                   default=DEFAULT_DIGITS_CONFIG["output_dir"])
    p.add_argument("--img_size", type=int,
                   default=DEFAULT_DIGITS_CONFIG["img_size"])
    p.add_argument("--train_samples_per_class", type=int,
                   default=DEFAULT_DIGITS_CONFIG["train_samples_per_class"])
    p.add_argument("--test_samples_per_class", type=int,
                   default=DEFAULT_DIGITS_CONFIG["test_samples_per_class"])
    p.add_argument("--seed", type=int, default=DEFAULT_DIGITS_CONFIG["seed"])
    args = p.parse_args(argv)
    gen = MNISTCountingGenerator({
        "output_dir": args.output_dir, "img_size": args.img_size,
        "train_samples_per_class": args.train_samples_per_class,
        "test_samples_per_class": args.test_samples_per_class,
        "seed": args.seed,
    })
    gen.generate_dataset()


if __name__ == "__main__":
    main()
