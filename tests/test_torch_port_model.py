"""The port's eager model (count_pipnet_tpu_torch/models) against the flax
model on the same parameters and inputs: ConvNeXt features, and the
Count-PIPNet forward with gumbel-hard (same injected noise) and softmax
heads. Small widths; inputs from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.models.convnext import ConvNeXtFeatures as JFeatures
from count_pipnet_tpu.models.convnext import convert_torchvision_convnext
from count_pipnet_tpu.models.pipnet import CountPIPNet as JCountPIPNet
from count_pipnet_tpu.ops import ste as jste
from count_pipnet_tpu_torch.models import convnext as tconvnext
from count_pipnet_tpu_torch.models.convert import (backbone_from_jax_params,
                                                   from_jax_params)
from count_pipnet_tpu_torch.models.convnext import ConvNeXtFeatures
from count_pipnet_tpu_torch.models.intermediates import make_intermediate
from count_pipnet_tpu_torch.models.pipnet import (CountPIPNet,
                                                  get_count_network)
from count_pipnet_tpu_torch.ops import gumbel as tgumbel
from count_pipnet_tpu_torch.ops import ste as tste
from test_torch_golden import synth_sd

RTOL = ATOL = 2e-4
NARROW = ((16, 1), (32, 1), (64, 2), (128, 1))


def _x(seed, shape=(2, 64, 64, 3)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("threshold,num_stages,want", [
    (20, 7, (2, 6, 6, 128)),     # one stride-2, two stride-1 downsamples
    (20, 4, (2, 7, 7, 64)),      # mid-layer truncation
    (100, 7, (2, 2, 2, 128)),    # every downsample at stride 2
])
def test_features_match_flax(threshold, num_stages, want):
    jm = JFeatures(stage_settings=NARROW, stride_threshold=threshold,
                   num_stages=num_stages)
    x = _x(num_stages)
    params = jm.init(jax.random.PRNGKey(num_stages), jnp.asarray(x[:1]))
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = ConvNeXtFeatures(NARROW, threshold, num_stages)
    tm.load_state_dict(backbone_from_jax_params(params["params"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == want
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_full_width_features_match_flax():
    """ConvNeXt-Tiny widths, 7 stages, stride surgery at 100, torchvision
    synthetic weights through both converters."""
    sd = synth_sd(np.random.default_rng(42))
    x = _x(5, (1, 64, 64, 3)) * 0.5
    ref = np.asarray(JFeatures(stride_threshold=100, num_stages=7).apply(
        {"params": convert_torchvision_convnext(sd)}, jnp.asarray(x)))
    tm = tconvnext.convnext_tiny_26_features()
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 6, 6, 768)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert tconvnext.get_feature_dimensions(False, 7, 224, 100) == \
        (1, 26, 26, 768)
    assert tconvnext.get_feature_dimensions(False, 7, 224, 300) == \
        (1, 13, 13, 768)
    assert tconvnext.get_feature_dimensions(True, 3, 224, 100) == \
        (1, 28, 28, 192)


def _pair(activation, num_features, seed=0):
    jb = JFeatures(stage_settings=NARROW, stride_threshold=20, num_stages=7)
    jm = JCountPIPNet(num_classes=5, num_prototypes=num_features or 128,
                      backbone=jb, activation=activation,
                      num_features=num_features)
    x = _x(seed + 10)
    params = jm.init({"params": jax.random.PRNGKey(seed),
                      "gumbel": jax.random.PRNGKey(1)},
                     jnp.asarray(x[:1]))["params"]
    tm = CountPIPNet(num_classes=5, num_prototypes=num_features or 128,
                     backbone=ConvNeXtFeatures(NARROW, 20, 7),
                     activation=activation, num_features=num_features)
    tm.load_state_dict(from_jax_params(jax.device_get(params)))
    return jm, params, tm.eval(), x


@pytest.mark.parametrize("num_features", [0, 8])
def test_gumbel_hard_forward_matches_flax(monkeypatch, num_features):
    """Same injected Gumbel noise on both sides (jax.random.gumbel patched
    to return it): equal winners and clamped counts, logits to 2e-4."""
    jm, params, tm, x = _pair("gumbel_softmax", num_features)
    p = num_features or 128
    noise = np.random.default_rng(3).gumbel(size=(2, 6, 6, p)) \
        .astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(noise, dtype))
    proto_j, pooled_j, out_j = jm.apply(
        {"params": params}, jnp.asarray(x), inference=True,
        rngs={"gumbel": jax.random.PRNGKey(2)})
    with torch.no_grad():
        proto_t, pooled_t, out_t = tm(torch.from_numpy(x), inference=True,
                                      noise=torch.from_numpy(noise))
    # straight-through one-hot: y_hard + y_soft - y_soft, one-hot to ~1 ulp
    np.testing.assert_array_equal(proto_t.numpy().argmax(-1),
                                  np.asarray(proto_j).argmax(-1))
    np.testing.assert_allclose(proto_t.numpy(), np.asarray(proto_j),
                               atol=1e-6)
    np.testing.assert_array_equal(pooled_t.numpy(), np.asarray(pooled_j))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("inference", [False, True])
def test_softmax_forward_matches_flax(inference):
    jm, params, tm, x = _pair("softmax", 8, seed=1)
    proto_j, pooled_j, out_j = jm.apply({"params": params}, jnp.asarray(x),
                                        inference=inference)
    with torch.no_grad():
        proto_t, pooled_t, out_t = tm(torch.from_numpy(x),
                                      inference=inference)
    np.testing.assert_allclose(proto_t.numpy(), np.asarray(proto_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pooled_t.numpy(), np.asarray(pooled_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)


def test_modified_encoding_matches_jax():
    counts = np.array([[0.0, 0.05, 1.0, 2.0, 3.0, 4.0, 7.0, 2.5]],
                      np.float32)
    want = np.asarray(jste.create_modified_encoding(jnp.asarray(counts), 3))
    got = tste.create_modified_encoding(torch.from_numpy(counts), 3)
    np.testing.assert_array_equal(got.numpy(), want)
    raw = np.random.default_rng(0).uniform(-1, 5, size=(4, 16)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        tste.modified_onehot_ste(torch.from_numpy(raw), 3).numpy(),
        np.asarray(jste.modified_onehot_ste(jnp.asarray(raw), 3)))


def test_gumbel_softmax_ops():
    logits = torch.from_numpy(_x(1, (3, 4, 10)))
    noise = torch.from_numpy(np.random.default_rng(2).gumbel(
        size=(3, 4, 10)).astype(np.float32))
    soft = tgumbel.gumbel_softmax(logits, tau=0.5, noise=noise)
    torch.testing.assert_close(soft, torch.softmax((logits + noise) / 0.5,
                                                   dim=-1))
    hard = tgumbel.gumbel_softmax(logits, hard=True, noise=noise)
    assert torch.equal(hard.argmax(-1), (logits + noise).argmax(-1))
    torch.testing.assert_close(hard.sum(-1), torch.ones(3, 4))
    g = torch.Generator().manual_seed(0)
    a = tgumbel.gumbel_softmax(logits, hard=True, generator=g)
    b = tgumbel.gumbel_softmax(logits, hard=True,
                               generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    det = tgumbel.hard_deterministic(logits)
    assert torch.equal(det.argmax(-1), logits.argmax(-1))


def test_factories():
    class Args:
        net = "convnext_tiny_26"
        num_features = 0
        use_mid_layers = True
        num_stages = 3
        activation = "gumbel_softmax"
        intermediate_layer = "onehot"

    model, p = get_count_network(200, Args, max_count=3)
    assert p == 192 and model.classification.weight.shape == (200, 576)
    for kind, dim in (("linear", 12), ("linear_full", 12), ("bilinear", 12),
                      ("identity", 4)):
        assert make_intermediate(kind, 4, 3).output_dim == dim
    with pytest.raises(ValueError, match="Unknown intermediate"):
        make_intermediate("cubic", 4, 3)
    Args.net = "resnet50"
    with pytest.raises(ValueError):
        get_count_network(200, Args)
