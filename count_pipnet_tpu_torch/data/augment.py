"""Host-side image transforms (PIL + numpy), deterministic and seedable.

The port's copy of count_pipnet_tpu/data/augment.py (framework-free host
code). Pillow is imported where an image is touched, so the package
imports without it.

Functional parity with the reference's torchvision transform recipes
(util/data.py:261-657) without torch: every transform takes an explicit
``random.Random`` via the call, fixing the reference's broken
``worker_init_fn=np.random.seed(seed)`` (evaluated once, passes None —
util/data.py:147) with a properly keyed per-item stream.

Includes a TrivialAugmentWide engine with the reference's three restricted
augmentation spaces (util/data.py:620-657): NoColor (geometry only),
NoShapeWithColor, NoShape.

Output contract: ``to_array`` + ``Normalize`` produce float32 HWC arrays
(NHWC batches on device) normalized with ImageNet statistics.
"""

import math
import random
from typing import Callable, Sequence

import numpy as np

__all__ = [
    "Compose", "Resize", "RandomHorizontalFlip", "RandomCrop",
    "RandomResizedCrop", "RandomRotation", "RandomAffine", "ColorJitter",
    "Grayscale3", "ToArray", "ToUint8Array", "Normalize", "GaussianNoise",
    "TrivialAugmentWide", "TrivialAugmentWideNoColor",
    "TrivialAugmentWideNoShape", "TrivialAugmentWideNoShapeWithColor",
    "IMAGENET_MEAN", "IMAGENET_STD",
]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _pil():
    """(Image, ImageEnhance, ImageOps) of Pillow."""
    from PIL import Image, ImageEnhance, ImageOps
    return Image, ImageEnhance, ImageOps


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, img, rng: random.Random):
        for t in self.transforms:
            img = t(img, rng)
        return img


class Resize:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img, rng=None):
        return img.resize((self.size[1], self.size[0]), _pil()[0].BILINEAR)


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, rng: random.Random):
        if rng.random() < self.p:
            return img.transpose(_pil()[0].FLIP_LEFT_RIGHT)
        return img


class RandomCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img, rng: random.Random):
        w, h = img.size
        th, tw = self.size
        if w == tw and h == th:
            return img
        if w < tw or h < th:
            img = img.resize((max(w, tw), max(h, th)), _pil()[0].BILINEAR)
            w, h = img.size
        x = rng.randint(0, w - tw)
        y = rng.randint(0, h - th)
        return img.crop((x, y, x + tw, y + th))


class RandomResizedCrop:
    """torchvision semantics: sample area in ``scale`` * original area with
    aspect ratio in (3/4, 4/3); 10 attempts then center fallback."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def __call__(self, img, rng: random.Random):
        w, h = img.size
        area = w * h
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            target_area = area * rng.uniform(*self.scale)
            aspect = math.exp(rng.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                x = rng.randint(0, w - cw)
                y = rng.randint(0, h - ch)
                crop = img.crop((x, y, x + cw, y + ch))
                return crop.resize((self.size[1], self.size[0]),
                                   _pil()[0].BILINEAR)
        # Fallback: center crop to in-range aspect
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            cw, ch = w, int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            cw, ch = int(round(h * self.ratio[1])), h
        else:
            cw, ch = w, h
        x, y = (w - cw) // 2, (h - ch) // 2
        crop = img.crop((x, y, x + cw, y + ch))
        return crop.resize((self.size[1], self.size[0]), _pil()[0].BILINEAR)


def _affine(img, angle=0.0, translate=(0, 0), scale=1.0, shear=(0.0, 0.0),
            fill=0, resample=None):
    """PIL inverse-affine transform around the image center (torchvision
    convention)."""
    Image = _pil()[0]
    if resample is None:
        resample = Image.NEAREST
    w, h = img.size
    cx, cy = w * 0.5, h * 0.5
    rot = math.radians(angle)
    sx, sy = (math.radians(s) for s in shear)
    # torchvision RSS matrix
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
    m = [x / scale for x in (a, b, c, d)]
    # inverse mapping with center + translate
    tx, ty = translate
    matrix = [
        m[0], m[1], cx - (cx + tx) * m[0] - (cy + ty) * m[1],
        m[2], m[3], cy - (cx + tx) * m[2] - (cy + ty) * m[3],
    ]
    if isinstance(fill, (int, float)):
        fill = tuple([int(fill)] * len(img.getbands()))
    return img.transform((w, h), Image.AFFINE, matrix, resample,
                         fillcolor=fill)


class RandomRotation:
    def __init__(self, degrees: float, fill=0):
        self.degrees = degrees
        self.fill = fill

    def __call__(self, img, rng: random.Random):
        angle = rng.uniform(-self.degrees, self.degrees)
        fill = self.fill
        if isinstance(fill, (int, float)):
            fill = tuple([int(fill)] * len(img.getbands()))
        return img.rotate(angle, _pil()[0].NEAREST, expand=False,
                          fillcolor=fill)


class RandomAffine:
    def __init__(self, degrees: float, translate=None, scale=None, fill=0):
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.fill = fill

    def __call__(self, img, rng: random.Random):
        angle = rng.uniform(-self.degrees, self.degrees)
        w, h = img.size
        tx = ty = 0
        if self.translate is not None:
            tx = int(round(rng.uniform(-self.translate[0], self.translate[0])
                           * w))
            ty = int(round(rng.uniform(-self.translate[1], self.translate[1])
                           * h))
        scale = 1.0
        if self.scale is not None:
            scale = rng.uniform(self.scale[0], self.scale[1])
        return _affine(img, angle=angle, translate=(tx, ty), scale=scale,
                       fill=self.fill)


class ColorJitter:
    """brightness/contrast jitter with torchvision factor sampling
    (uniform in [max(0, 1-v), 1+v])."""

    def __init__(self, brightness: float = 0.0, contrast: float = 0.0):
        self.brightness = brightness
        self.contrast = contrast

    def __call__(self, img, rng: random.Random):
        ImageEnhance = _pil()[1]
        if self.brightness > 0:
            f = rng.uniform(max(0.0, 1 - self.brightness),
                            1 + self.brightness)
            img = ImageEnhance.Brightness(img).enhance(f)
        if self.contrast > 0:
            f = rng.uniform(max(0.0, 1 - self.contrast), 1 + self.contrast)
            img = ImageEnhance.Contrast(img).enhance(f)
        return img


class Grayscale3:
    """Grayscale with 3 output channels (util/data.py:571)."""

    def __call__(self, img, rng=None):
        return img.convert("L").convert("RGB")


class ToArray:
    """PIL -> float32 HWC in [0, 1] (replaces ToTensor; stays channels-last
    for TPU)."""

    def __call__(self, img, rng=None):
        arr = np.asarray(img, dtype=np.float32) / 255.0
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        return arr


class ToUint8Array:
    """PIL -> uint8 HWC (no host float conversion). The device-augment
    transport format: 4x fewer bytes over the host->device link than
    ToArray's float32, and bit-identical once the device divides by 255
    (ToArray is exactly uint8/255)."""

    def __call__(self, img, rng=None):
        arr = np.asarray(img, dtype=np.uint8)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        return arr


class Normalize:
    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, arr, rng=None):
        return (arr - self.mean) / self.std


class GaussianNoise:
    """Additive gaussian noise applied with probability p on the [0,1]
    float array (replaces the reference's Kornia RandomGaussianNoise,
    util/data.py:346-410)."""

    def __init__(self, mean: float = 0.0, std: float = 0.1, p: float = 0.5):
        self.mean = mean
        self.std = std
        self.p = p

    def __call__(self, arr, rng: random.Random):
        if rng.random() < self.p:
            np_rng = np.random.default_rng(rng.getrandbits(63))
            noise = np_rng.normal(self.mean, self.std,
                                  size=arr.shape).astype(np.float32)
            return arr + noise
        return arr


# ---------------------------------------------------------------------------
# TrivialAugmentWide
# ---------------------------------------------------------------------------
_NUM_BINS = 31


def _full_space(num_bins):
    return {
        "Identity": (np.array([0.0]), False),
        "ShearX": (np.linspace(0.0, 0.99, num_bins), True),
        "ShearY": (np.linspace(0.0, 0.99, num_bins), True),
        "TranslateX": (np.linspace(0.0, 32.0, num_bins), True),
        "TranslateY": (np.linspace(0.0, 32.0, num_bins), True),
        "Rotate": (np.linspace(0.0, 135.0, num_bins), True),
        "Brightness": (np.linspace(0.0, 0.99, num_bins), True),
        "Color": (np.linspace(0.0, 0.99, num_bins), True),
        "Contrast": (np.linspace(0.0, 0.99, num_bins), True),
        "Sharpness": (np.linspace(0.0, 0.99, num_bins), True),
        "Posterize": (
            8 - np.round(np.arange(num_bins) / ((num_bins - 1) / 6)), False),
        "Solarize": (np.linspace(255.0, 0.0, num_bins), False),
        "AutoContrast": (np.array([0.0]), False),
        "Equalize": (np.array([0.0]), False),
    }


def _nocolor_space(num_bins):
    # Geometry-only ops with tightened ranges (util/data.py:620-629).
    return {
        "Identity": (np.array([0.0]), False),
        "ShearX": (np.linspace(0.0, 0.5, num_bins), True),
        "ShearY": (np.linspace(0.0, 0.5, num_bins), True),
        "TranslateX": (np.linspace(0.0, 16.0, num_bins), True),
        "TranslateY": (np.linspace(0.0, 16.0, num_bins), True),
        "Rotate": (np.linspace(0.0, 60.0, num_bins), True),
    }


def _noshape_with_color_space(num_bins):
    # Photometric ops incl. solarize (util/data.py:631-643).
    return {
        "Identity": (np.array([0.0]), False),
        "Brightness": (np.linspace(0.0, 0.5, num_bins), True),
        "Color": (np.linspace(0.0, 0.5, num_bins), True),
        "Contrast": (np.linspace(0.0, 0.5, num_bins), True),
        "Sharpness": (np.linspace(0.0, 0.5, num_bins), True),
        "Posterize": (
            8 - np.round(np.arange(num_bins) / ((num_bins - 1) / 6)), False),
        "Solarize": (np.linspace(255.0, 0.0, num_bins), False),
        "AutoContrast": (np.array([0.0]), False),
        "Equalize": (np.array([0.0]), False),
    }


def _noshape_space(num_bins):
    # Photometric with near-zero Color range (util/data.py:645-657).
    space = _noshape_with_color_space(num_bins)
    space["Color"] = (np.linspace(0.0, 0.02, num_bins), True)
    del space["Solarize"]
    return space


def _apply_op(img, op: str, magnitude: float):
    Image, ImageEnhance, ImageOps = _pil()
    if op == "Identity":
        return img
    if op == "ShearX":
        return _affine(img, shear=(math.degrees(math.atan(magnitude)), 0.0))
    if op == "ShearY":
        return _affine(img, shear=(0.0, math.degrees(math.atan(magnitude))))
    if op == "TranslateX":
        return _affine(img, translate=(int(round(magnitude)), 0))
    if op == "TranslateY":
        return _affine(img, translate=(0, int(round(magnitude))))
    if op == "Rotate":
        return img.rotate(magnitude, Image.NEAREST, expand=False)
    if op == "Brightness":
        return ImageEnhance.Brightness(img).enhance(1.0 + magnitude)
    if op == "Color":
        return ImageEnhance.Color(img).enhance(1.0 + magnitude)
    if op == "Contrast":
        return ImageEnhance.Contrast(img).enhance(1.0 + magnitude)
    if op == "Sharpness":
        return ImageEnhance.Sharpness(img).enhance(1.0 + magnitude)
    if op == "Posterize":
        return ImageOps.posterize(img, int(magnitude))
    if op == "Solarize":
        return ImageOps.solarize(img, int(magnitude))
    if op == "AutoContrast":
        return ImageOps.autocontrast(img)
    if op == "Equalize":
        return ImageOps.equalize(img)
    raise ValueError(f"unknown op {op}")


class TrivialAugmentWide:
    """One uniformly-chosen op at a uniformly-chosen strength per call."""

    space_fn = staticmethod(_full_space)

    def __init__(self, num_bins: int = _NUM_BINS):
        self.space = self.space_fn(num_bins)
        self.ops = list(self.space.keys())

    def __call__(self, img, rng: random.Random):
        op = self.ops[rng.randrange(len(self.ops))]
        magnitudes, signed = self.space[op]
        mag = float(magnitudes[rng.randrange(len(magnitudes))]) \
            if len(magnitudes) > 1 else 0.0
        if signed and rng.random() < 0.5:
            mag = -mag
        return _apply_op(img, op, mag)


class TrivialAugmentWideNoColor(TrivialAugmentWide):
    space_fn = staticmethod(_nocolor_space)


class TrivialAugmentWideNoShapeWithColor(TrivialAugmentWide):
    space_fn = staticmethod(_noshape_with_color_space)


class TrivialAugmentWideNoShape(TrivialAugmentWide):
    space_fn = staticmethod(_noshape_space)
