"""Two-view augmentation on the device (photometric, optionally geometric).

Port of count_pipnet_tpu/data/device_augment.py in PyTorch ops, for
``--device_augment`` (and ``--device_geometric``). The host loader performs
only the decode (and, without ``geo``, the shared geometric transform1) and
ships one uint8 image per sample; both views come out of one call on the
card.

Per view (the reference's transform2, util/data.py:596-617):
  brightness: img * f,   f ~ U[1-b, 1+b]        (PIL Brightness)
  contrast:   (img - gray_mean) * f + gray_mean (PIL Contrast)
  random crop to img_size
  gaussian noise with probability p (kornia RandomGaussianNoise,
    util/data.py:346-410)
  ImageNet normalization

``geo=True`` also runs the shared transform1 of the synthetic shapes
recipes on the card: RandomRotation (fill white) and torchvision-sampling
RandomResizedCrop, with the host's Resize(img + 32) folded in, composed
into one bilinear resample per image, drawn once and applied to both views
(the two-view contract keeps transform1 shared). Distributional parity
with the host chain, not pixel parity: the host resamples twice (NEAREST
rotation, then the bilinear crop-resize).

The random draws are split from the arithmetic: ``draw_view`` /
``draw_geo`` take an explicit ``torch.Generator`` and return the random
variates of a batch; ``apply_view`` / ``apply_geo`` are deterministic
functions of an image batch and those draws (the JAX package's
``_one_view`` and ``_shared_geo`` once their keys are drawn). In a
data-parallel world the draws are made for the world batch and each rank
applies its rows of them to its own images (``shard``), so the views equal
the one-process views of the joined batch.
"""

import math
from typing import NamedTuple, Tuple

import torch

from .augment import IMAGENET_MEAN, IMAGENET_STD

__all__ = ["DeviceAugmentConfig", "make_device_twoview_augment",
           "draw_view", "apply_view", "draw_geo", "apply_geo"]

_GRAY = (0.299, 0.587, 0.114)
_CANDIDATES = 10  # RandomResizedCrop's (area, aspect) tries


class DeviceAugmentConfig(NamedTuple):
    img_size: int
    brightness: float = 0.1
    contrast: float = 0.1
    noise_std: float = 0.0       # 0 disables (shapes-GN recipes use 0.1)
    noise_p: float = 0.5
    # -- the shared transform1 on the card (--device_geometric) ----------
    geo: bool = False
    geo_rot: float = 0.0         # RandomRotation(degrees)
    geo_out: int = 0             # RandomResizedCrop output side (img+8)
    geo_scale: Tuple[float, float] = (1.0, 1.0)   # RRC area fraction
    geo_ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
    geo_fill: float = 1.0        # rotation fill, [0,1] (white = 255/255)
    geo_canvas: int = 0          # Resize(img+32) side; 0 = the input IS
    #                              the canvas. When set, the host ships the
    #                              raw decoded image and the Resize is
    #                              folded into the same (plain bilinear)
    #                              resample.


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def draw_view(generator, batch_shape, cfg: DeviceAugmentConfig):
    """The random variates of one view of a [B, H, W, 3] batch:
    ``brightness``, ``contrast`` [B] factors (when enabled), crop offsets
    ``ox``, ``oy`` [B] (int64), and with noise a standard normal ``noise``
    [B, s, s, 3] and the bool ``apply`` [B]."""
    b, h, w = batch_shape[:3]
    s, dev = cfg.img_size, generator.device
    d = {}
    if cfg.brightness > 0:
        d["brightness"] = _uniform(generator, (b,),
                                   max(0.0, 1 - cfg.brightness),
                                   1 + cfg.brightness, dev)
    if cfg.contrast > 0:
        d["contrast"] = _uniform(generator, (b,), max(0.0, 1 - cfg.contrast),
                                 1 + cfg.contrast, dev)
    d["ox"] = torch.randint(0, max(w - s, 0) + 1, (b,), generator=generator,
                            device=dev)
    d["oy"] = torch.randint(0, max(h - s, 0) + 1, (b,), generator=generator,
                            device=dev)
    if cfg.noise_std > 0:
        d["noise"] = torch.randn((b, s, s, 3), generator=generator,
                                 device=dev)
        d["apply"] = torch.rand((b,), generator=generator,
                                device=dev) < cfg.noise_p
    return d


def apply_view(img, draws, cfg: DeviceAugmentConfig):
    """One view: ``img`` [B, H, W, 3] float in [0, 1] (the transform1
    output) -> [B, s, s, 3] normalized, under ``draws``."""
    b, dev, s = img.shape[0], img.device, cfg.img_size
    per_image = lambda t: t.to(img.dtype).view(b, 1, 1, 1)  # noqa: E731
    if "brightness" in draws:
        img = img * per_image(draws["brightness"])
    if "contrast" in draws:
        gray = torch.tensor(_GRAY, dtype=img.dtype, device=dev)
        mean = (img @ gray).mean(dim=(1, 2)).view(b, 1, 1, 1)
        img = (img - mean) * per_image(draws["contrast"]) + mean
    img = img.clamp(0.0, 1.0)
    ar = torch.arange(s, device=dev)
    rows = draws["oy"].to(dev)[:, None] + ar
    cols = draws["ox"].to(dev)[:, None] + ar
    bi = torch.arange(b, device=dev)[:, None, None]
    img = img[bi, rows[:, :, None], cols[:, None, :]]
    if "noise" in draws:
        img = img + per_image(draws["apply"]) * (cfg.noise_std
                                                 * draws["noise"])
    mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=dev)
    std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=dev)
    return (img - mean) / std


def draw_geo(generator, b, cfg: DeviceAugmentConfig):
    """The random variates of the shared transform1 of ``b`` images: the
    rotation ``theta`` [B] (radians), the RandomResizedCrop candidates
    ``scales`` and ``aspects`` [B, 10], and the uniforms ``ux``, ``uy`` [B]
    that place the crop."""
    dev = generator.device
    la0, la1 = math.log(cfg.geo_ratio[0]), math.log(cfg.geo_ratio[1])
    return {
        "theta": _uniform(generator, (b,), -cfg.geo_rot, cfg.geo_rot, dev)
        * (math.pi / 180.0),
        "scales": _uniform(generator, (b, _CANDIDATES), cfg.geo_scale[0],
                           cfg.geo_scale[1], dev),
        "aspects": torch.exp(_uniform(generator, (b, _CANDIDATES), la0, la1,
                                      dev)),
        "ux": torch.rand((b,), generator=generator, device=dev),
        "uy": torch.rand((b,), generator=generator, device=dev),
    }


def _bilinear_fill(img, ys, xs, fill):
    """Bilinear sample of ``img`` [B, H, W, 3] at float coordinates
    ``ys``, ``xs`` [B, h, w]; taps out of bounds contribute ``fill``."""
    b, h, w = img.shape[:3]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy, fx = (ys - y0)[..., None], (xs - x0)[..., None]
    y0, x0 = y0.long(), x0.long()
    bi = torch.arange(b, device=img.device)[:, None, None]

    def tap(yi, xi):
        inb = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
        v = img[bi, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(inb, v, fill)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def apply_geo(img, draws, cfg: DeviceAugmentConfig):
    """The shared transform1 of the shapes recipes under ``draws``:
    RandomRotation(geo_rot, fill) then RandomResizedCrop(geo_out,
    geo_scale, geo_ratio) as one bilinear resample of ``img`` [B, H, W, 3]
    (the canvas, or the raw image when ``geo_canvas`` folds the Resize in).

    The crop follows torchvision's sampling: the first of the 10
    (area, aspect) candidates that fits wins, else the full frame; the
    rotation is about the canvas centre, the uncovered area filled."""
    b, h0, w0 = img.shape[:3]
    dev = img.device
    s1 = cfg.geo_canvas if cfg.geo_canvas else h0
    out = cfg.geo_out
    scales, aspects = draws["scales"].to(dev), draws["aspects"].to(dev)
    cw = torch.round(s1 * torch.sqrt(scales * aspects))
    ch = torch.round(s1 * torch.sqrt(scales / aspects))
    valid = (cw > 0) & (ch > 0) & (cw <= s1) & (ch <= s1)
    first = valid.to(torch.uint8).argmax(dim=1, keepdim=True)
    any_valid = valid.any(dim=1)
    cw_i = torch.where(any_valid, cw.gather(1, first)[:, 0], float(s1))
    ch_i = torch.where(any_valid, ch.gather(1, first)[:, 0], float(s1))
    # torchvision's randint(0, s1 - cw) is inclusive
    x0 = torch.floor(draws["ux"].to(dev) * (s1 - cw_i + 1.0))
    y0 = torch.floor(draws["uy"].to(dev) * (s1 - ch_i + 1.0))

    # output grid -> crop coordinates (half-pixel centres) -> unrotate
    ar = torch.arange(out, device=dev, dtype=torch.float32) + 0.5
    u = ar * (cw_i / out)[:, None] - 0.5 + x0[:, None]          # [B, out]
    v = ar * (ch_i / out)[:, None] - 0.5 + y0[:, None]
    xg = u[:, None, :].expand(b, out, out)
    yg = v[:, :, None].expand(b, out, out)
    c = (s1 - 1) / 2.0
    theta = draws["theta"].to(dev)
    cos_t, sin_t = torch.cos(theta)[:, None, None], \
        torch.sin(theta)[:, None, None]
    xs = c + cos_t * (xg - c) - sin_t * (yg - c)
    ys = c + sin_t * (xg - c) + cos_t * (yg - c)
    if h0 != s1 or w0 != s1:
        # the host Resize(canvas) folded in: canvas -> source coordinates
        xs = (xs + 0.5) * (w0 / s1) - 0.5
        ys = (ys + 0.5) * (h0 / s1) - 0.5
    return _bilinear_fill(img.float(), ys, xs, cfg.geo_fill)


def make_device_twoview_augment(cfg: DeviceAugmentConfig):
    """``augment(generator, batch, shard=None) -> (view1, view2)``: the
    device-side transform2 applied twice with independent draws from
    ``generator`` (on the batch's device), after the shared transform1
    when ``cfg.geo``. ``batch`` [B, H, W, 3] is float in [0, 1] or uint8
    (the ``ToUint8Array`` transport, exactly ToArray's value once divided
    by 255). ``shard`` (parallel/mesh.py: BatchShard): ``batch`` is a
    rank's rows of a world batch; the draws are the world's, cut to those
    rows."""

    def augment(generator, batch, shard=None):
        if not batch.is_floating_point():
            batch = batch.float() / 255.0
        def draw(fn, shape):
            # the draws of a batch of ``shape``, or of the world's batch
            # cut to this rank's rows
            if shard is None:
                return fn(generator, shape, cfg)
            d = fn(generator, shard.world_shape(shape), cfg)
            return {k: shard.take(v) for k, v in d.items()}

        if cfg.geo:
            batch = apply_geo(batch, draw(
                lambda g, s, c: draw_geo(g, s[0], c), batch.shape), cfg)
        v1 = apply_view(batch, draw(draw_view, batch.shape), cfg)
        v2 = apply_view(batch, draw(draw_view, batch.shape), cfg)
        return v1, v2

    return augment
