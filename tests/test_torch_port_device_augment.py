"""The device-side two-view augmentation (count_pipnet_tpu_torch/data/
device_augment.py) against the JAX package's data/device_augment.py.

* With the JAX package's draws fed in (its key splits repeated here),
  ``apply_view`` and ``apply_geo`` equal ``_one_view`` and ``_shared_geo``
  to 1e-5, with and without the Resize folded into the resample.
* The port's own draws: the values lie in range, the two views differ, the
  geometric draw is shared by both views, identity draws give the input
  back, and the uint8 transport equals the float input divided by 255.
Small images; inputs from numpy seeds."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.data import device_augment as jda
from count_pipnet_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD
from count_pipnet_tpu_torch.data.device_augment import (
    DeviceAugmentConfig, apply_geo, apply_view, draw_geo, draw_view,
    make_device_twoview_augment)

VIEW = DeviceAugmentConfig(img_size=16, brightness=0.1, contrast=0.1,
                           noise_std=0.1, noise_p=0.5)


def _images(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _keys(n, seed):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def _jax_view_draws(keys, cfg, h, w):
    """The variates ``_one_view`` draws from each key, in the port's
    format."""
    s = cfg.img_size
    d = {k: [] for k in ("brightness", "contrast", "ox", "oy", "noise",
                         "apply")}
    for key in keys:
        kb, kc, kx, ky, kn, kp = jax.random.split(key, 6)
        d["brightness"].append(jax.random.uniform(
            kb, (), minval=max(0.0, 1 - cfg.brightness),
            maxval=1 + cfg.brightness))
        d["contrast"].append(jax.random.uniform(
            kc, (), minval=max(0.0, 1 - cfg.contrast),
            maxval=1 + cfg.contrast))
        d["ox"].append(jax.random.randint(kx, (), 0, max(w - s, 0) + 1))
        d["oy"].append(jax.random.randint(ky, (), 0, max(h - s, 0) + 1))
        d["noise"].append(jax.random.normal(kn, (s, s, 3)))
        d["apply"].append(jax.random.bernoulli(kp, cfg.noise_p))
    out = {k: torch.from_numpy(np.stack([np.asarray(v) for v in vs]))
           for k, vs in d.items()}
    out["ox"], out["oy"] = out["ox"].long(), out["oy"].long()
    return out


def _jax_geo_draws(keys, cfg):
    """The variates ``_shared_geo`` draws from each key."""
    d = {k: [] for k in ("theta", "scales", "aspects", "ux", "uy")}
    la0 = jnp.log(jnp.asarray(cfg.geo_ratio[0]))
    la1 = jnp.log(jnp.asarray(cfg.geo_ratio[1]))
    for key in keys:
        ka, ks, kr, kx, ky = jax.random.split(key, 5)
        d["theta"].append(jax.random.uniform(
            ka, (), minval=-cfg.geo_rot, maxval=cfg.geo_rot)
            * (jnp.pi / 180.0))
        d["scales"].append(jax.random.uniform(
            ks, (10,), minval=cfg.geo_scale[0], maxval=cfg.geo_scale[1]))
        d["aspects"].append(jnp.exp(jax.random.uniform(
            kr, (10,), minval=la0, maxval=la1)))
        d["ux"].append(jax.random.uniform(kx))
        d["uy"].append(jax.random.uniform(ky))
    return {k: torch.from_numpy(np.stack([np.asarray(v) for v in vs]))
            for k, vs in d.items()}


def test_apply_view_matches_one_view():
    imgs = _images((6, 24, 22, 3), seed=1)
    keys = _keys(6, seed=2)
    want = np.asarray(jax.vmap(jda._one_view, in_axes=(0, 0, None))(
        keys, jnp.asarray(imgs), VIEW))
    draws = _jax_view_draws(keys, VIEW, 24, 22)
    assert draws["apply"].any() and not draws["apply"].all()
    got = apply_view(torch.from_numpy(imgs), draws, VIEW).numpy()
    assert got.shape == (6, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("canvas", [0, 48])
def test_apply_geo_matches_shared_geo(canvas):
    """``canvas`` 0: the input is the canvas; 48: the host's Resize of a
    40x40 raw image to 48x48 is folded into the resample."""
    cfg = DeviceAugmentConfig(img_size=16, geo=True, geo_rot=10.0,
                              geo_out=24, geo_scale=(0.5, 1.0),
                              geo_fill=1.0, geo_canvas=canvas)
    side = 40 if canvas else 32
    imgs = _images((5, side, side, 3), seed=3)
    keys = _keys(5, seed=4)
    want = np.asarray(jax.vmap(jda._shared_geo, in_axes=(0, 0, None))(
        keys, jnp.asarray(imgs), cfg))
    got = apply_geo(torch.from_numpy(imgs), _jax_geo_draws(keys, cfg),
                    cfg).numpy()
    assert got.shape == (5, 24, 24, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _denormalized(v):
    return v * torch.tensor(IMAGENET_STD) + torch.tensor(IMAGENET_MEAN)


def test_views_in_range_and_different():
    """Without noise every de-normalized value lies in [0, 1]; the two
    views of an image differ; the draws lie in their ranges."""
    cfg = VIEW._replace(noise_std=0.0)
    imgs = torch.from_numpy(_images((8, 24, 24, 3), seed=5))
    gen = torch.Generator().manual_seed(0)
    v1, v2 = make_device_twoview_augment(cfg)(gen, imgs)
    assert v1.shape == v2.shape == (8, 16, 16, 3)
    for v in (v1, v2):
        d = _denormalized(v)
        assert d.min() >= -1e-6 and d.max() <= 1 + 1e-6
    assert (v1 - v2).abs().amax(dim=(1, 2, 3)).min() > 1e-3
    d = draw_view(torch.Generator().manual_seed(1), (4000, 24, 24), VIEW)
    assert 0.9 <= d["brightness"].min() and d["brightness"].max() <= 1.1
    assert 0.9 <= d["contrast"].min() and d["contrast"].max() <= 1.1
    assert d["ox"].min() == 0 and d["ox"].max() == 8
    assert abs(d["apply"].float().mean().item() - 0.5) < 0.05
    g = draw_geo(torch.Generator().manual_seed(2), 4000,
                 DeviceAugmentConfig(img_size=16, geo=True, geo_rot=10.0,
                                     geo_scale=(0.95, 1.0)))
    assert g["theta"].abs().max() <= math.radians(10.0) + 1e-6
    assert 0.95 <= g["scales"].min() and g["scales"].max() <= 1.0
    assert 0.75 - 1e-6 <= g["aspects"].min() <= g["aspects"].max() \
        <= 4 / 3 + 1e-6


def test_geometric_draw_is_shared_by_both_views():
    """With no photometric change and no crop margin the two views are the
    same image, and not the input: the geometric transform was drawn once
    per image and applied to both."""
    cfg = DeviceAugmentConfig(img_size=24, brightness=0.0, contrast=0.0,
                              geo=True, geo_rot=10.0, geo_out=24,
                              geo_scale=(0.8, 1.0), geo_canvas=32)
    imgs = torch.from_numpy(_images((4, 32, 32, 3), seed=6))
    v1, v2 = make_device_twoview_augment(cfg)(
        torch.Generator().manual_seed(3), imgs)
    torch.testing.assert_close(v1, v2, rtol=0, atol=0)
    plain = make_device_twoview_augment(cfg._replace(geo=False))(
        torch.Generator().manual_seed(3), imgs[:, :24, :24])[0]
    assert (v1 - plain).abs().max() > 1e-2


def test_identity_draws_give_the_input_back():
    cfg = DeviceAugmentConfig(img_size=16, geo=True, geo_out=20)
    imgs = torch.from_numpy(_images((2, 20, 20, 3), seed=7))
    draws = {"theta": torch.zeros(2), "scales": torch.ones(2, 10),
             "aspects": torch.ones(2, 10), "ux": torch.full((2,), 0.5),
             "uy": torch.full((2,), 0.5)}
    torch.testing.assert_close(apply_geo(imgs, draws, cfg), imgs,
                               rtol=0, atol=1e-6)


def test_uint8_transport_equals_float_over_255():
    """``ToUint8Array`` batches give exactly the views of ToArray's float
    batches (uint8 / 255), with and without the geometric transform."""
    raw = np.random.default_rng(8).integers(0, 256, (3, 40, 40, 3),
                                            dtype=np.uint8)
    for cfg in (VIEW, VIEW._replace(geo=True, geo_rot=10.0, geo_out=24,
                                    geo_scale=(0.95, 1.0), geo_canvas=48)):
        aug = make_device_twoview_augment(cfg)
        a = aug(torch.Generator().manual_seed(4), torch.from_numpy(raw))
        b = aug(torch.Generator().manual_seed(4),
                torch.from_numpy(raw.astype(np.float32) / 255.0))
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
