"""Geometric-shapes synthetic dataset generator.

The port's copy of count_pipnet_tpu/data/generate_shapes.py (numpy and
Pillow only): for the same flags and seed it writes the same PNG files,
byte for byte. Run it as ``python -m
count_pipnet_tpu_torch.data.generate_shapes --output_dir ... [--flagship200]``.

Capability parity with the reference generator
(util/generate_shapes_data.py): classes are (shape_type, count) pairs —
default 9 classes {circle, triangle, hexagon} x {1,2,3} (reference
:519-525) — written in ImageFolder layout ``<out>/train/class_{i}`` and
``<out>/test/class_{i}``. Object sizes ~ N(16, 4) clipped to [12, 20] to
match the backbone's effective receptive field (reference :34-38); placement
rejects overlaps above ``max_overlap`` with up to 50 attempts (:235-302);
per-shape base colors with jitter (:129-137); rotation <= 15 degrees;
optional uniform background noise.
"""

import argparse
import math
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image, ImageDraw

__all__ = ["GeometricShapesGenerator", "DEFAULT_CONFIG"]

DEFAULT_CONFIG = {
    "output_dir": "./data/geometric_shapes/dataset",
    "img_size": 192,
    "train_samples_per_class": 100,
    "test_samples_per_class": 0,
    "seed": 42,
    "min_object_size": 12,
    "max_object_size": 20,
    "size_mean": 16,
    "size_std": 4,
    "max_rotation": 15,
    "max_overlap": 0.15,
    "noise_level": 0,
    "outline_width": 2,
    "shape_types": ["circle", "square", "triangle", "hexagon"],
    "class_definitions": [
        ("circle", 1), ("triangle", 1), ("hexagon", 1),
        ("circle", 2), ("triangle", 2), ("hexagon", 2),
        ("circle", 3), ("triangle", 3), ("hexagon", 3),
    ],
}

BASE_COLORS = {
    "circle": (50, 50, 200),
    "square": (200, 50, 50),
    "triangle": (50, 200, 50),
    "hexagon": (200, 150, 50),
    "star": (150, 50, 200),
    "cross": (50, 200, 200),
}

# Named palette for the flagship 200-class variant: class identity is a
# (shape, color, count) triple — prototypes should learn the 40
# (shape, color) pairs, classes are discriminated by COUNT, exercising
# the Count-PIPNet mechanism at CUB-200 scale (224^2, 200 classes).
COLOR_PALETTE = {
    "red": (200, 40, 40), "green": (40, 170, 40), "blue": (40, 60, 200),
    "yellow": (210, 200, 40), "purple": (140, 40, 180),
    "orange": (230, 130, 30), "cyan": (40, 190, 190),
    "magenta": (200, 40, 160), "brown": (130, 90, 40),
    "gray": (120, 120, 120),
}


def build_flagship_classes():
    """4 shapes x 10 colors x counts 1..5 = 200 (shape, count, color)."""
    out = []
    for shape in ("circle", "square", "triangle", "hexagon"):
        for color in COLOR_PALETTE:
            for count in range(1, 6):
                out.append((shape, count, color))
    return out


def _regular_polygon(cx, cy, radius, n_sides, rotation_deg):
    pts = []
    rot = math.radians(rotation_deg)
    for k in range(n_sides):
        theta = rot + 2 * math.pi * k / n_sides - math.pi / 2
        pts.append((cx + radius * math.cos(theta),
                    cy + radius * math.sin(theta)))
    return pts


def _box_overlap_frac(a, b):
    """Intersection area / min box area."""
    ix = max(0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    denom = min(area_a, area_b)
    return inter / denom if denom > 0 else 1.0


class GeometricShapesGenerator:
    def __init__(self, config: Optional[Dict] = None):
        self.config = dict(DEFAULT_CONFIG)
        if config:
            self.config.update(config)
        c = self.config
        self.output_dir = c["output_dir"]
        self.img_size = c["img_size"]
        self.rng = random.Random(c["seed"])
        self.np_rng = np.random.default_rng(c["seed"])

    # -- drawing ------------------------------------------------------------
    def _jitter_color(self, base):
        return tuple(
            int(np.clip(v + self.rng.randint(-30, 30), 0, 255))
            for v in base)

    def _darker(self, color, factor=0.6):
        return tuple(int(v * factor) for v in color)

    def _draw_shape(self, draw: ImageDraw.ImageDraw, shape: str,
                    cx: float, cy: float, size: float, rotation: float,
                    base_color=None):
        color = self._jitter_color(base_color or BASE_COLORS[shape])
        outline = self._darker(color)
        w = self.config["outline_width"]
        r = size / 2.0
        if shape == "circle":
            draw.ellipse([cx - r, cy - r, cx + r, cy + r], fill=color,
                         outline=outline, width=w)
        elif shape == "square":
            pts = _regular_polygon(cx, cy, r * math.sqrt(2) / 1.0, 4,
                                   rotation + 45)
            draw.polygon(pts, fill=color, outline=outline, width=w)
        elif shape == "triangle":
            pts = _regular_polygon(cx, cy, r * 1.15, 3, rotation)
            draw.polygon(pts, fill=color, outline=outline, width=w)
        elif shape == "hexagon":
            pts = _regular_polygon(cx, cy, r * 1.05, 6, rotation)
            draw.polygon(pts, fill=color, outline=outline, width=w)
        else:
            raise ValueError(f"unknown shape {shape}")

    def _sample_size(self) -> float:
        c = self.config
        s = self.np_rng.normal(c["size_mean"], c["size_std"])
        return float(np.clip(s, c["min_object_size"], c["max_object_size"]))

    def _place_objects(self, count: int) -> List[Tuple[float, float, float]]:
        """Sample non-overlapping (cx, cy, size) placements."""
        c = self.config
        placed = []
        boxes = []
        margin = c["max_object_size"]
        for _ in range(count):
            size = self._sample_size()
            for _attempt in range(50):
                cx = self.rng.uniform(margin, self.img_size - margin)
                cy = self.rng.uniform(margin, self.img_size - margin)
                box = (cx - size / 2, cy - size / 2,
                       cx + size / 2, cy + size / 2)
                if all(_box_overlap_frac(box, b) <= c["max_overlap"]
                       for b in boxes):
                    break
            placed.append((cx, cy, size))
            boxes.append(box)
        return placed

    def generate_image(self, shape: str, count: int,
                       color_name=None) -> Image.Image:
        c = self.config
        base_color = COLOR_PALETTE[color_name] if color_name else None
        if c["noise_level"] > 0:
            bg = self.np_rng.integers(
                255 - c["noise_level"], 256,
                size=(self.img_size, self.img_size, 3), dtype=np.uint8)
            img = Image.fromarray(bg, "RGB")
        else:
            img = Image.new("RGB", (self.img_size, self.img_size),
                            (255, 255, 255))
        draw = ImageDraw.Draw(img)
        for cx, cy, size in self._place_objects(count):
            rotation = self.rng.uniform(-c["max_rotation"],
                                        c["max_rotation"])
            self._draw_shape(draw, shape, cx, cy, size, rotation,
                             base_color=base_color)
        return img

    # -- dataset ------------------------------------------------------------
    def generate_dataset(self, train_samples_per_class=None,
                         test_samples_per_class=None):
        c = self.config
        n_train = (train_samples_per_class
                   if train_samples_per_class is not None
                   else c["train_samples_per_class"])
        n_test = (test_samples_per_class
                  if test_samples_per_class is not None
                  else c["test_samples_per_class"])
        class_defs = c["class_definitions"]
        print(f"Generating dataset with {len(class_defs)} classes...")
        for i, cdef in enumerate(class_defs, start=1):
            shape, count = cdef[0], cdef[1]
            color = cdef[2] if len(cdef) > 2 else None
            tag = (f"{shape}_{color}_{count}" if color
                   else f"{shape}_{count}")
            for split, n in (("train", n_train), ("test", n_test)):
                cdir = os.path.join(self.output_dir, split, f"class_{i}")
                os.makedirs(cdir, exist_ok=True)
                for j in range(n):
                    img = self.generate_image(shape, count, color)
                    img.save(os.path.join(cdir, f"{tag}_{j}.png"))
        print(f"Dataset written to {self.output_dir}")

    def visualize_grid(self, path: str, per_class: int = 3):
        """Class x sample grid image for eyeballing (reference :431-503)."""
        class_defs = self.config["class_definitions"]
        cell = 96
        grid = Image.new(
            "RGB", (cell * per_class, cell * len(class_defs)), "white")
        for row, cdef in enumerate(class_defs):
            shape, count = cdef[0], cdef[1]
            color = cdef[2] if len(cdef) > 2 else None
            for col in range(per_class):
                img = self.generate_image(shape, count, color) \
                    .resize((cell, cell))
                grid.paste(img, (col * cell, row * cell))
        grid.save(path)


def main(argv=None):
    p = argparse.ArgumentParser("Generate geometric shapes dataset")
    p.add_argument("--output_dir",
                   default=DEFAULT_CONFIG["output_dir"])
    p.add_argument("--img_size", type=int,
                   default=DEFAULT_CONFIG["img_size"])
    p.add_argument("--train_samples_per_class", type=int,
                   default=DEFAULT_CONFIG["train_samples_per_class"])
    p.add_argument("--test_samples_per_class", type=int,
                   default=DEFAULT_CONFIG["test_samples_per_class"])
    p.add_argument("--noise_level", type=int,
                   default=DEFAULT_CONFIG["noise_level"])
    p.add_argument("--seed", type=int, default=DEFAULT_CONFIG["seed"])
    p.add_argument("--viz_only", action="store_true")
    p.add_argument("--flagship200", action="store_true",
                   help="200-class (shape x color x count<=5) variant "
                        "for CUB-200-scale runs")
    args = p.parse_args(argv)

    cfg = {
        "output_dir": args.output_dir, "img_size": args.img_size,
        "train_samples_per_class": args.train_samples_per_class,
        "test_samples_per_class": args.test_samples_per_class,
        "noise_level": args.noise_level, "seed": args.seed,
    }
    if args.flagship200:
        cfg["class_definitions"] = build_flagship_classes()
        # counts up to 5 need room: slightly smaller objects
        cfg["size_mean"], cfg["size_std"] = 15, 3
    gen = GeometricShapesGenerator(cfg)
    if args.viz_only:
        gen.visualize_grid(os.path.join(
            os.path.dirname(args.output_dir) or ".", "shapes_grid.png"))
    else:
        gen.generate_dataset()


if __name__ == "__main__":
    main()
