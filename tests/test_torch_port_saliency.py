"""The port's saliency methods (count_pipnet_tpu_torch/interpret/
saliency.py) against the JAX package's on the same inputs:

* IG, LeftIG, IDG, Guided IG and SmoothGrad on two analytic scorers
  written once in ``jnp`` and once in ``torch`` with the same weights (the
  linear map of tests/test_interpret.py and a smooth nonlinear one): equal
  to float rounding (1e-5 of the largest attribution);
* ``_alpha_parameters`` equal on seeded slopes, a zero-span and an
  all-zero case; the visualisers equal;
* ``make_score_grad_fn`` on a tiny Count-PIPNet (Gumbel add-on, hard
  samples with the same injected noise; the eager and the
  ``--fused_blocks`` block routes) and a tiny PIP-Net, through
  interpret_idg's ``make_prototype_fn`` / ``make_logit_fn``, on eight
  images of an IG path: scores and input gradients within
  tests/test_torch_port_model.py's RTOL = ATOL = 2e-4 (the gradients'
  ATOL relative to their largest value); the model's parameters keep
  ``.grad is None``;
* IG and IDG through the tiny PIP-Net within the same tolerance;
* a resnet18 PIP-Net (eval-mode BatchNorm on random running statistics):
  scores and input gradients within the same tolerance, its running
  statistics unmoved and its parameters' ``.grad`` None.
Small widths; inputs from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.interpret import saliency as js
from count_pipnet_tpu.models.convnext import ConvNeXtFeatures as JFeatures
from count_pipnet_tpu.models.pipnet import CountPIPNet as JCountPIPNet
from count_pipnet_tpu.models.pipnet import PIPNet as JPIPNet
from count_pipnet_tpu_torch.interpret import interpret_idg as tidg
from count_pipnet_tpu_torch.interpret import saliency as ts
from count_pipnet_tpu_torch.models.convert import (from_jax_params,
                                                   to_jax_batch_stats)
from count_pipnet_tpu_torch.models.convnext import ConvNeXtFeatures
from count_pipnet_tpu_torch.models.pipnet import CountPIPNet, PIPNet
from count_pipnet_tpu_torch.ops import gumbel as tgumbel
from test_torch_port_interpret_idg import two_threads  # noqa: F401
from test_torch_port_model import ATOL, RTOL
from test_torch_port_resnet import _pipnet_pair
from test_torch_port_trajectory import LAT, NUM_STAGES, P, STAGES

NC = 5
SIDE = 64
EXACT = 1e-5   # float rounding, relative to the largest attribution


def _analytic(kind):
    """(jnp scorer, torch scorer) [B, 12, 12, 3] -> [B, 2] on the same
    weights: the linear map of tests/test_interpret.py, or
    sum(tanh(x * w)) + 0.1 * sum(x^2 * w)."""
    w = np.random.default_rng(0).normal(size=(12, 12, 3, 2)) \
        .astype(np.float32)
    wj, wt = jnp.asarray(w), torch.from_numpy(w)
    if kind == "linear":
        return (lambda xs: jnp.einsum("bhwc,hwck->bk", xs, wj),
                lambda xs: torch.einsum("bhwc,hwck->bk", xs, wt))
    return (lambda xs: (jnp.tanh(xs[..., None] * wj).sum(axis=(1, 2, 3))
                        + 0.1 * (xs[..., None] ** 2 * wj).sum(axis=(1, 2,
                                                                    3))),
            lambda xs: (torch.tanh(xs[..., None] * wt).sum(dim=(1, 2, 3))
                        + 0.1 * (xs[..., None] ** 2 * wt).sum(dim=(1, 2,
                                                                   3))))


def _image(seed, shape=(1, 12, 12, 3)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=EXACT):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("kind", ["linear", "nonlinear"])
@pytest.mark.parametrize("method", ["IG", "LIG", "IDG", "GIG"])
def test_attributions_match_jax_on_analytic_scorers(kind, method):
    jfn, tfn = _analytic(kind)
    x = _image(1)
    call = {"IG": lambda m, f, **k: m.IG(x, f, steps=32, batch_size=16,
                                          target_class=0, **k),
            "LIG": lambda m, f, **k: m.IG(x, f, steps=32, batch_size=16,
                                           alpha_star=0.4, target_class=1,
                                           **k),
            "IDG": lambda m, f, **k: m.IDG(x, f, steps=32, batch_size=16,
                                            target_class=1, **k),
            "GIG": lambda m, f, **k: m.guided_ig(x, f, steps=16,
                                                 target_class=0, **k)}[
        method]
    want = call(js, jfn)
    got = call(ts, tfn, device="cpu")
    assert got.shape == want.shape == (12, 12, 3)
    assert np.isfinite(got).all()
    _close(got, want)


@pytest.mark.parametrize("magnitude", [True, False])
def test_smoothgrad_matches_jax(magnitude):
    jfn, tfn = _analytic("nonlinear")
    x = _image(2)
    want = js.smoothgrad(lambda v: js.IG(v, jfn, steps=16, batch_size=8,
                                         target_class=0), x, n_samples=3,
                         magnitude=magnitude, seed=4)
    got = ts.smoothgrad(lambda v: ts.IG(v, tfn, steps=16, batch_size=8,
                                        target_class=0, device="cpu"), x,
                        n_samples=3, magnitude=magnitude, seed=4)
    _close(got, want)


@pytest.mark.parametrize("case", ["seeded", "zero_span", "all_zero",
                                  "negative"])
def test_alpha_parameters_equal(case):
    steps = 32
    rng = np.random.default_rng(3)
    slopes = {"seeded": rng.normal(size=steps),
              "zero_span": np.full(steps, 0.7),
              "all_zero": np.zeros(steps),
              "negative": -np.abs(rng.normal(size=steps))}[case] \
        .astype(np.float32)
    step = 1.0 / (steps - 1)
    for got, want in zip(ts._alpha_parameters(slopes, steps, step),
                         js._alpha_parameters(slopes, steps, step)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_visualizers_equal():
    attr = _image(4, (8, 8, 3))
    np.testing.assert_array_equal(ts.visualize_grayscale(attr),
                                  js.visualize_grayscale(attr))
    np.testing.assert_array_equal(ts.visualize_diverging(attr, 95),
                                  js.visualize_diverging(attr, 95))


def _family(kind, fused, seed=7):
    """The flax and the port's model on the same parameters: layer scales
    0.2 (so every block shows), a stem bias of N(0, 0.5) (with the init's
    zero bias the stem and its LayerNorm make the features, and so the
    scores, the same at every point of the IG path but its baseline),
    the trainer's classifier init."""
    jb = JFeatures(stage_settings=STAGES, stride_threshold=40,
                   num_stages=NUM_STAGES, fused_mlp=fused)
    tb = ConvNeXtFeatures(STAGES, 40, NUM_STAGES, fused_mlp=fused)
    if kind == "count":
        jm = JCountPIPNet(num_classes=NC, num_prototypes=P, max_count=3,
                          backbone=jb, num_features=P, use_ste=True)
        tm = CountPIPNet(num_classes=NC, num_prototypes=P, max_count=3,
                         backbone=tb, num_features=P, use_ste=True)
    else:
        jm = JPIPNet(num_classes=NC, num_prototypes=P, backbone=jb,
                     num_features=P)
        tm = PIPNet(num_classes=NC, num_prototypes=P, backbone=tb,
                    num_features=P)
    params = jax.device_get(jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(seed), "gumbel": jax.random.PRNGKey(1)},
        jnp.zeros((1, SIDE, SIDE, 3)))["params"])
    rng = np.random.default_rng(seed)
    bb = {k: (dict(v, layer_scale=np.full_like(v["layer_scale"], 0.2))
              if "layer_scale" in v else v)
          for k, v in params["backbone"].items()}
    stem = bb["features_0"]
    bb["features_0"] = dict(stem, conv=dict(stem["conv"], bias=(
        0.5 * rng.normal(size=stem["conv"]["bias"].shape)).astype(
            np.float32)))
    clf = {"weight": (1.0 + 0.1 * rng.normal(
        size=params["classification"]["weight"].shape)).astype(np.float32),
        "multiplier": np.full((1,), 2.0, np.float32)}
    params = dict(params, backbone=bb, classification=clf)
    tm.load_state_dict(from_jax_params(params))
    return jm, params, tm


def _inject_noise(monkeypatch):
    """The same Gumbel noise on both sides, the first rows of one block
    for a batch of any size."""
    noise = np.random.default_rng(11).gumbel(size=(32, LAT, LAT, P)) \
        .astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(noise[:shape[0]], dtype))
    monkeypatch.setattr(tgumbel, "sample_gumbel",
                        lambda shape, generator=None, device=None:
                        torch.from_numpy(noise[:shape[0]]))


def _jax_fns(jm, params):
    """The JAX package's interpret_idg targets, without its loader."""
    def run(xs):
        return jm.apply({"params": params}, xs, inference=True, train=False,
                        tau=1.0, rngs={"gumbel": jax.random.PRNGKey(0)})
    return (lambda p: lambda xs: run(xs)[1][:, p].astype(jnp.float32),
            lambda c: lambda xs: run(xs)[2][:, c].astype(jnp.float32))


def _path(n=8, seed=5):
    """``n`` images on the IG path from a seeded image to baseline 0."""
    x = _image(seed, (1, SIDE, SIDE, 3))
    return np.linspace(0, 1, n, dtype=np.float32).reshape(-1, 1, 1, 1) * x


@pytest.mark.parametrize("kind,fused", [("count", False), ("count", True),
                                        ("pipnet", False)],
                         ids=["count_eager", "count_fused_blocks",
                              "pipnet_eager"])
@pytest.mark.parametrize("target", ["prototype", "logit"])
def test_score_grad_matches_jax_on_tiny_models(monkeypatch, kind, fused,
                                               target):
    _inject_noise(monkeypatch)
    jm, params, tm = _family(kind, fused)
    proto_j, logit_j = _jax_fns(jm, params)
    if target == "prototype":
        jfn, tfn = proto_j(3), tidg.make_prototype_fn(tm, 3)
    else:
        logits = tidg.make_logit_fn(tm)
        jfn, tfn = logit_j(1), (lambda xs: logits(xs)[:, 1])
    xs = _path()
    gj, sj = jax.device_get(js.make_score_grad_fn(jfn)(jnp.asarray(xs)))
    gt, st = ts.make_score_grad_fn(tfn)(torch.from_numpy(xs))
    gt, st = gt.numpy(), st.numpy()
    np.testing.assert_allclose(st, sj, rtol=RTOL, atol=ATOL)
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(gt, gj, rtol=RTOL,
                               atol=ATOL * np.abs(gj).max())
    assert all(p.grad is None for p in tm.parameters())


@pytest.mark.parametrize("method", ["IG", "IDG"])
def test_ig_and_idg_match_jax_on_tiny_pipnet(monkeypatch, method):
    """One image, its most active prototype's pooled score, 16 steps in
    batches of 8: the attribution within RTOL/ATOL of the largest."""
    _inject_noise(monkeypatch)
    jm, params, tm = _family("pipnet", False)
    x = _image(6, (1, SIDE, SIDE, 3))
    with torch.no_grad():
        pooled = tm(torch.from_numpy(x), inference=True)[1][0]
    p = int(pooled.argmax())
    assert float(pooled[p]) > 0.1  # active: past the abstention
    jfn = _jax_fns(jm, params)[0](p)
    tfn = tidg.make_prototype_fn(tm, p)
    fn = {"IG": lambda m, f, **k: m.IG(x, f, steps=16, batch_size=8, **k),
          "IDG": lambda m, f, **k: m.IDG(x, f, steps=16, batch_size=8,
                                          **k)}[method]
    want = fn(js, jfn)
    got = fn(ts, tfn, device="cpu")
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())
    assert all(q.grad is None for q in tm.parameters())


def test_score_grad_on_resnet_pipnet_keeps_batchnorm():
    """Two images of an IG path through a resnet18 PIP-Net's pooled score
    of one prototype: the running statistics serve the forward (eval
    mode) and do not move."""
    jm, params, _, tm = _pipnet_pair()
    rng = np.random.default_rng(8)
    with torch.no_grad():
        for name, buf in tm.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(0.1 * rng.normal(
                    size=buf.shape)).float())
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(0.5 + rng.random(
                    buf.shape)).float())
    stats = to_jax_batch_stats(tm.state_dict())
    before = {n: b.clone() for n, b in tm.named_buffers()}
    side = 64
    x = _image(9, (1, side, side, 3))
    xs = np.linspace(0.25, 1, 2, dtype=np.float32).reshape(-1, 1, 1, 1) * x
    jfn = lambda v: jm.apply(  # noqa: E731
        {"params": params, "batch_stats": stats}, v, inference=True,
        train=False)[1][:, 2]
    gj, sj = jax.device_get(js.make_score_grad_fn(jfn)(jnp.asarray(xs)))
    gt, st = ts.make_score_grad_fn(tidg.make_prototype_fn(tm, 2))(
        torch.from_numpy(xs))
    np.testing.assert_allclose(st.numpy(), sj, rtol=RTOL, atol=ATOL)
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(gt.numpy(), gj, rtol=RTOL,
                               atol=ATOL * np.abs(gj).max())
    for name, buf in tm.named_buffers():
        assert torch.equal(buf, before[name]), name
    assert all(p.grad is None for p in tm.parameters())
