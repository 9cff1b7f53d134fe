"""The port's random samplers against the JAX package's, by distribution.

The parity tests elsewhere inject the draws into both packages, so they
hold what a step does with its noise, not the noise. Here each sampler
itself, on the CPU, is held to the JAX package's at about 1e6 draws:

* ``ops/gumbel.py: sample_gumbel`` against ``jax.random.gumbel`` (what
  ``count_pipnet_tpu/ops/gumbel.py`` draws): mean, variance and the
  1e-3 and 1e-5 upper tails of both against Gumbel(0, 1), and the
  two-sample KS statistic between them;
* ``models/convnext.py: draw_drop_mask`` against ``jax.random.bernoulli``
  at every stochastic-depth probability of ``convnext_tiny_26``: each keep
  rate against ``1 - sd_prob``. The trunk's train-mode forward draws its
  masks through it;
* ``data/device_augment.py: draw_geo`` and ``draw_view`` against the
  draws of the JAX package's ``_shared_geo`` and ``_one_view``, taken
  from those functions as they run (each ``jax.random`` sampler they call
  is wrapped to hand its value out of the traced function): the ranges,
  and the two-sample KS statistic of each continuous variate; the crop
  offsets' frequencies and the noise's apply rate against their
  probabilities.

Gates: means, variances and rates within 5 standard errors; KS
statistics under the two-sample critical value at level 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.data import device_augment as jaug
from count_pipnet_tpu_torch.data.device_augment import (DeviceAugmentConfig,
                                                        draw_geo, draw_view)
from count_pipnet_tpu_torch.models.convnext import (ConvNeXtFeatures,
                                                    draw_drop_mask)
from count_pipnet_tpu_torch.ops.gumbel import sample_gumbel

N = 1_000_000
SIGMAS = 5.0
ALPHA = 1e-4
GAMMA = 0.5772156649015329
SAMPLERS = ("uniform", "randint", "normal", "bernoulli")
# the flagship's augmentation (data/registry.py: device_augment_config for
# shapes_200 with --device_geometric), the view's crop at 4 px on a 12 px
# canvas: the same 9 offsets as 224 px on 232
GEO = DeviceAugmentConfig(img_size=224, noise_std=0.1, geo=True,
                          geo_rot=10.0, geo_out=232, geo_scale=(0.95, 1.0),
                          geo_canvas=256)
VIEW = DeviceAugmentConfig(img_size=4, noise_std=0.1)
VIEW_SIDE = 12


def ks_limit(n, m):
    return math.sqrt(-0.5 * math.log(ALPHA / 2)) * math.sqrt((n + m)
                                                             / (n * m))


def ks_2samp(a, b):
    a, b = np.sort(np.ravel(a)), np.sort(np.ravel(b))
    both = np.concatenate([a, b])
    fa = np.searchsorted(a, both, side="right") / a.size
    fb = np.searchsorted(b, both, side="right") / b.size
    return np.abs(fa - fb).max()


def assert_same_law(what, ours, theirs):
    d, lim = ks_2samp(ours, theirs), ks_limit(np.size(ours),
                                               np.size(theirs))
    assert d <= lim, (what, d, lim)


def assert_rate(what, hits, n, p):
    se = math.sqrt(p * (1 - p) / n)
    assert abs(hits / n - p) <= SIGMAS * se, (what, hits / n, p, se)


def assert_moments(what, x, mean, var, kurt_excess):
    x = np.ravel(x).astype(np.float64)
    se_m = math.sqrt(var / x.size)
    se_v = var * math.sqrt((2.0 + kurt_excess) / x.size)
    assert abs(x.mean() - mean) <= SIGMAS * se_m, (what, x.mean(), mean)
    assert abs(x.var(ddof=1) - var) <= SIGMAS * se_v, (what, x.var(), var)


def jax_draws(fn, n, seed, *args):
    """What ``fn(key, *args)`` draws through ``jax.random``'s samplers for
    ``n`` keys split from ``seed`` (``args`` the same for every key): a
    list, in call order, of (sampler, array [n, ...]). Each sampler is
    wrapped while ``fn`` is traced, and the wrapper's values are the
    traced function's outputs."""
    names = []

    def one(key, *args):
        real = {s: getattr(jax.random, s) for s in SAMPLERS}
        out = []

        def spy(name):
            def draw(*a, **k):
                v = real[name](*a, **k)
                names.append(name)
                out.append(v)
                return v
            return draw
        try:
            for s in SAMPLERS:
                setattr(jax.random, s, spy(s))
            fn(key, *args)
        finally:
            for s, f in real.items():
                setattr(jax.random, s, f)
        return out

    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    values = jax.jit(jax.vmap(one, in_axes=(0,) + (None,) * len(args)))(
        keys, *args)
    return [(s, np.asarray(v)) for s, v in zip(names, values)]


def test_gumbel_matches_jax():
    ours = sample_gumbel((N,), torch.Generator().manual_seed(0),
                         "cpu").numpy()
    theirs = np.asarray(jax.random.gumbel(jax.random.PRNGKey(0), (N,),
                                          jnp.float32))
    for what, x in (("port", ours), ("jax", theirs)):
        assert np.isfinite(x).all(), what
        assert_moments(what, x, GAMMA, math.pi ** 2 / 6, 2.4)
        for p in (1e-3, 1e-5):
            q = -math.log(-math.log1p(-p))
            assert_rate(f"{what} tail {p}", int((x > q).sum()), x.size, p)
    assert_same_law("gumbel", ours, theirs)


def test_drop_masks_match_jax():
    with torch.device("meta"):  # the probabilities only
        probs = sorted({b.sd_prob for b in ConvNeXtFeatures().blocks()
                        if b.sd_prob > 0})
    assert len(probs) == 17
    gen = torch.Generator().manual_seed(1)
    bern = jax.jit(lambda k, p: jax.random.bernoulli(k, p, (N, 1, 1, 1)))
    for i, p in enumerate(probs):
        ours = draw_drop_mask(N, p, "cpu", gen)
        assert ours.shape == (N, 1, 1, 1) and ours.dtype == torch.float32
        assert bool(((ours == 0) | (ours == 1)).all())
        theirs = np.asarray(bern(jax.random.PRNGKey(i), 1.0 - p))
        assert_rate(f"port keep at {p}", float(ours.sum()), N, 1.0 - p)
        assert_rate(f"jax keep at {p}", int(theirs.sum()), N, 1.0 - p)


def test_trunk_draws_its_masks_through_draw_drop_mask():
    """A small trunk's train-mode forward hands each block the mask that
    draw_drop_mask draws from the same generator state."""
    trunk = ConvNeXtFeatures(((16, 2), (32, 2)), 40, 3)
    probs = [b.sd_prob for b in trunk.blocks()]
    seen = []
    for b in trunk.blocks():
        b.register_forward_pre_hook(lambda m, args: seen.append(args[1]))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        trunk(torch.rand(5, 32, 32, 3), train=True, generator=gen)
    gen.manual_seed(2)
    want = [draw_drop_mask(5, p, "cpu", gen) if p > 0 else None
            for p in probs]
    assert len(seen) == len(want) == 4 and seen[0] is None
    for got, ref in zip(seen[1:], want[1:]):
        assert torch.equal(got, ref)


@pytest.fixture(scope="module")
def geo_draws():
    n = N // 10  # ten scales and ten aspects an image
    # the draws do not depend on the output's side: a 4 px output keeps
    # the traced resample small
    small = GEO._replace(geo_out=4)
    theirs = jax_draws(lambda k, img: jaug._shared_geo(k, img, small), n, 3,
                       jnp.zeros((4, 4, 3)))
    ours = draw_geo(torch.Generator().manual_seed(3), n, GEO)
    return theirs, {k: v.numpy() for k, v in ours.items()}


def test_geo_draws_match_jax(geo_draws):
    theirs, ours = geo_draws
    # _shared_geo: theta (degrees), scales, log aspects, ux, uy
    assert [s for s, _ in theirs] == ["uniform"] * 5
    t_theta, t_scales, t_logasp, t_ux, t_uy = (v for _, v in theirs)
    la = [math.log(r) for r in GEO.geo_ratio]
    for what, x, y, lo, hi in (
            ("theta", ours["theta"] * 180.0 / math.pi, t_theta,
             -GEO.geo_rot, GEO.geo_rot),
            ("scales", ours["scales"], t_scales, *GEO.geo_scale),
            ("log aspects", np.log(ours["aspects"]), t_logasp, *la),
            ("ux", ours["ux"], t_ux, 0.0, 1.0),
            ("uy", ours["uy"], t_uy, 0.0, 1.0)):
        assert x.shape == y.shape, (what, x.shape, y.shape)
        slack = 1e-6 * (hi - lo)  # the bounds as f32 rounds them
        for side, v in (("port", x), ("jax", y)):
            assert v.min() >= lo - slack and v.max() <= hi + slack, (
                what, side, v.min(), v.max())
        assert_same_law(what, x, y)


def test_view_draws_match_jax():
    n = N // 4
    img = jnp.zeros((VIEW_SIDE, VIEW_SIDE, 3))
    theirs = jax_draws(lambda k, im: jaug._one_view(k, im, VIEW), n, 4, img)
    # _one_view: brightness, contrast, ox, oy, the noise, its apply draw
    assert [s for s, _ in theirs] == ["uniform", "uniform", "randint",
                                      "randint", "normal", "bernoulli"]
    t = dict(zip(("brightness", "contrast", "ox", "oy", "noise", "apply"),
                 (v for _, v in theirs)))
    ours = {k: v.numpy() for k, v in draw_view(
        torch.Generator().manual_seed(4), (n, VIEW_SIDE, VIEW_SIDE, 3),
        VIEW).items()}
    assert ours["noise"].shape == t["noise"].shape == (n, 4, 4, 3)
    for k, amp in (("brightness", VIEW.brightness),
                   ("contrast", VIEW.contrast)):
        for side, v in (("port", ours[k]), ("jax", t[k])):
            assert v.min() >= 1 - amp - 1e-6 and v.max() <= 1 + amp + 1e-6
        assert_same_law(k, ours[k], t[k])
    assert_same_law("noise", ours["noise"][: N // 48], t["noise"][: N // 48])
    assert_moments("port noise", ours["noise"], 0.0, 1.0, 0.0)
    top = VIEW_SIDE - VIEW.img_size
    for k in ("ox", "oy"):
        for side, v in (("port", ours[k]), ("jax", t[k])):
            assert v.min() >= 0 and v.max() <= top, (k, side)
            for j in range(top + 1):
                assert_rate(f"{side} {k}={j}", int((v == j).sum()), n,
                            1.0 / (top + 1))
    for side, v in (("port", ours["apply"]), ("jax", t["apply"])):
        assert_rate(f"{side} noise applied", int(v.sum()), n, VIEW.noise_p)
