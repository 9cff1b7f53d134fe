"""The port's serving slice against the JAX package's: activation
calibration, and the int8-static whole-block backbone with the fused
gumbel-hard head plus clamp, encoding and classifier (the composition of
bench.py:165-173), under the same injected noise.

Narrow widths: stages 16/32/64 run bf16 and stage 128 int8-static (the
default int8_min_dim=96). On the JAX side padded_max_dim=64 sends stage 4
through fused_block_apply and fused_block_gumbel_counts, and stages 1-3
through fused_block_apply_padded, all in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.models import quantized as jq
from count_pipnet_tpu.models.convnext import ConvNeXtFeatures as JFeatures
from count_pipnet_tpu.models.pipnet import CountPIPNet as JCountPIPNet
from count_pipnet_tpu.ops.ste import create_modified_encoding as jenc
from count_pipnet_tpu_torch.models import quantized as tq
from count_pipnet_tpu_torch.models.convert import from_jax_params
from count_pipnet_tpu_torch.models.convnext import ConvNeXtFeatures
from count_pipnet_tpu_torch.models.pipnet import CountPIPNet
from count_pipnet_tpu_torch.models.serving import make_gumbel_serving_fn
from count_pipnet_tpu_torch.ops.gumbel_head import gumbel_noise
from count_pipnet_tpu_torch.ops.ste import create_modified_encoding

SLICE = ((16, 1), (32, 1), (64, 2), (128, 2))
THRESHOLD = 20


@pytest.fixture(scope="module")
def pair():
    jm = JCountPIPNet(num_classes=10, num_prototypes=128,
                      backbone=JFeatures(SLICE, THRESHOLD, num_stages=7))
    rng = np.random.default_rng(0)
    x_cal = rng.normal(size=(8, 64, 64, 3)).astype(np.float32)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    params = jax.device_get(jm.init({"params": jax.random.PRNGKey(0),
                                     "gumbel": jax.random.PRNGKey(1)},
                                    jnp.asarray(x[:1]))["params"])
    tm = CountPIPNet(num_classes=10, num_prototypes=128,
                     backbone=ConvNeXtFeatures(SLICE, THRESHOLD, 7))
    tm.load_state_dict(from_jax_params(params))
    kw = dict(stride_threshold=THRESHOLD, num_stages=7, stage_settings=SLICE)
    scales_j = jax.device_get(jq.calibrate_act_scales(
        params["backbone"], jnp.asarray(x_cal), **kw))
    scales_t = tq.calibrate_act_scales(tm.backbone, torch.from_numpy(x_cal))
    return dict(params=params, tm=tm.eval(), x=x, kw=kw, scales_j=scales_j,
                scales_t=scales_t)


def test_calibrate_act_scales_matches_jax(pair):
    sj, st = pair["scales_j"], pair["scales_t"]
    assert set(sj) == set(st) and len(st) == 6
    for scope in sj:
        for a, b in zip(sj[scope], st[scope]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                       atol=1e-6)


def _classify(counts, w):
    clamped = np.clip(np.round(counts), 0.0, 3.0)
    enc = np.asarray(jenc(jnp.asarray(clamped), 3)).reshape(len(counts), -1)
    return clamped, enc @ np.maximum(w, 0.0).T


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_slice_matches_jax(pair, dtype):
    x, params = pair["x"], pair["params"]
    noise = np.random.default_rng(5).gumbel(size=(2, 6, 6, 128)) \
        .astype(np.float32)
    counts_j = np.asarray(jq.fused_block_convnext_apply(
        params["backbone"], jnp.asarray(x), dtype=getattr(jnp, dtype),
        act_scales=pair["scales_j"], padded_max_dim=64,
        gumbel_head={"seed": 0, "noise": jnp.asarray(noise)},
        interpret=True, **pair["kw"]))
    counts_t = tq.fused_block_convnext_apply(
        pair["tm"].backbone, torch.from_numpy(x),
        dtype=getattr(torch, dtype), act_scales=pair["scales_t"],
        gumbel_head={"noise": torch.from_numpy(noise)}).numpy()
    np.testing.assert_array_equal(counts_t.sum(axis=1), 36.0)
    w = np.asarray(params["classification"]["weight"])
    cj, oj = _classify(counts_j, w)
    ct, ot = _classify(counts_t, w)
    assert np.mean(cj == ct) >= 0.99
    assert np.abs(ot - oj).max() / (np.abs(oj).max() + 1e-9) < 0.05


def test_serving_fn_is_the_composition(pair):
    """make_gumbel_serving_fn == backbone + fused head on the seed's Philox
    noise, then clamp, encoding and relu(W)."""
    tm, x = pair["tm"], torch.from_numpy(pair["x"])
    infer = make_gumbel_serving_fn(tm, act_scales=pair["scales_t"],
                                   device="cpu", dtype=torch.float32)
    clamped, logits = infer(x, 3)
    counts = tq.fused_block_convnext_apply(
        tm.backbone, x, dtype=torch.float32, act_scales=pair["scales_t"],
        gumbel_head={"noise": gumbel_noise(3, 2, 36, 128)})
    want = torch.clamp(torch.round(counts), 0, 3)
    assert torch.equal(clamped, want)
    enc = create_modified_encoding(want, 3).reshape(2, -1)
    torch.testing.assert_close(
        logits, enc @ torch.relu(tm.classification.weight).t())
    assert not torch.equal(infer(x, 4)[0], clamped)


def test_serving_fn_with_add_on_conv(pair):
    """num_features > 0: blocks, then the 1x1 conv, then the standalone
    head (kernel B on a GPU)."""
    tm = CountPIPNet(num_classes=10, num_prototypes=12,
                     backbone=ConvNeXtFeatures(SLICE, THRESHOLD, 7),
                     num_features=12)
    tm.backbone.load_state_dict(pair["tm"].backbone.state_dict())
    infer = make_gumbel_serving_fn(tm, act_scales=pair["scales_t"],
                                   device="cpu", dtype=torch.float32)
    clamped, logits = infer(pair["x"], 1)
    assert clamped.shape == (2, 12) and logits.shape == (2, 10)
    assert clamped.min() >= 0 and clamped.max() <= 3
    assert torch.isfinite(logits).all()


def test_int8_without_scales_raises(pair):
    """Int8 without act_scales raises no error: it is the dynamic per-row
    mode, here at widths >= 96, against the JAX package's forward without
    scales (f32 planes, within 2e-3 of the largest feature). Only the
    kernel C wrapper refuses that mode, on a CUDA tensor."""
    x = pair["x"]
    want = np.asarray(jq.fused_block_convnext_apply(
        pair["params"]["backbone"], jnp.asarray(x), dtype=jnp.float32,
        int8_min_dim=96, padded_max_dim=64, interpret=True, **pair["kw"]))
    got = tq.fused_block_convnext_apply(pair["tm"].backbone,
                                        torch.from_numpy(x),
                                        dtype=torch.float32,
                                        int8_min_dim=96).numpy()
    assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()
