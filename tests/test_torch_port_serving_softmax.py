"""The port's softmax serving path and its backbones against the JAX
package's, on the same bridged parameters and numpy-seeded images:

* ``quantize_convnext_params`` / ``quant_convnext_apply`` (int8 pointwise
  GEMMs), ``fused_convnext_apply`` (K5's plain version vs the Pallas
  kernel in interpret mode);
* ``make_serving_fn`` on each backbone (K9's plain version vs the Pallas
  head in interpret mode), and its rejection of a gumbel model;
* ``fused_block_convnext_apply`` with ``int8_downsample`` and the dynamic
  int8 blocks (no ``act_scales``).

Small models: the JAX package's own test configurations
(tests/test_quantized.py), 64 prototypes, layer scales 0.1 so that every
block's branch shows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.models import get_count_network as jax_get_network
from count_pipnet_tpu.models import quantized as jq
from count_pipnet_tpu.models.serving import make_serving_fn as jax_serving
from count_pipnet_tpu_torch.models import quantized as tq
from count_pipnet_tpu_torch.models.convert import from_jax_params
from count_pipnet_tpu_torch.models.pipnet import get_count_network
from count_pipnet_tpu_torch.models.serving import make_serving_fn
from count_pipnet_tpu_torch.ops.fused_head import fused_count_head
from count_pipnet_tpu_torch.ops.ste import create_modified_encoding


class Args:
    net = "convnext_tiny_26"
    num_features = 64
    use_mid_layers = True
    num_stages = 2
    bias = False
    activation = "softmax"
    intermediate_layer = "onehot"
    positive_grad_strategy = None
    backward_clamp_strategy = "Identity"
    disable_pretrained = True


def _pair(num_stages, seed=1):
    """(flax model, params with layer scales 0.1, port model, images)."""
    args = type("A", (Args,), {"num_stages": num_stages})
    jm, _ = jax_get_network(3, args, max_count=3, use_ste=True)
    x = np.random.default_rng(seed).uniform(size=(2, 32, 32, 3)) \
        .astype(np.float32)
    params = jax.device_get(jm.init({"params": jax.random.PRNGKey(seed)},
                                    jnp.asarray(x))["params"])
    for scope, sub in params["backbone"].items():
        if "_block_" in scope:
            sub["layer_scale"] = np.full_like(sub["layer_scale"], 0.1)
    tm, _ = get_count_network(3, args, max_count=3)
    tm.load_state_dict(from_jax_params(params))
    return jm, params, tm.eval(), x


@pytest.fixture(scope="module")
def two_stage():
    return _pair(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def test_quantize_convnext_params_equal_jax(two_stage):
    _, params, tm, _ = two_stage
    want = jq.quantize_convnext_params(params["backbone"])
    got = tq.quantize_convnext_params(tm.backbone)
    assert set(got) == {s for s in want if "_block_" in s}
    for scope, layers in got.items():
        for name in ("pw1", "pw2"):
            np.testing.assert_array_equal(layers[name]["q"].numpy(),
                                          np.asarray(want[scope][name]["q"]))
            np.testing.assert_array_equal(
                layers[name]["scale"].numpy(),
                np.asarray(want[scope][name]["scale"]))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
def test_quant_convnext_apply_matches_jax(two_stage, dtype, tol):
    """The int8 backbone: f32 planes within 1e-4 of the largest feature
    (the same int8 operands; sums in another order), bf16 planes within
    3e-2 (the two frameworks round the bf16 convs differently)."""
    _, params, tm, x = two_stage
    want = np.asarray(jq.quant_convnext_apply(
        jq.quantize_convnext_params(params["backbone"]), jnp.asarray(x),
        stride_threshold=100, num_stages=2, dtype=getattr(jnp, dtype)),
        np.float32)
    got = tq.quant_convnext_apply(
        tm.backbone, tq.quantize_convnext_params(tm.backbone),
        torch.from_numpy(x), dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    assert _rel(got.float().numpy(), want) < tol


def test_fused_convnext_apply_matches_jax(two_stage):
    """K5's plain version against the Pallas kernel in interpret mode, bf16
    planes: within 2e-2 of the largest feature (bf16 planes; the plain
    version keeps the GEMM results in f32)."""
    _, params, tm, x = two_stage
    want = np.asarray(jq.fused_convnext_apply(
        params["backbone"], jnp.asarray(x), stride_threshold=100,
        num_stages=2, interpret=True), np.float32)
    got = tq.fused_convnext_apply(tm.backbone, torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _rel(got.float().numpy(), want) < 2e-2


BACKBONES = {"plain": {}, "quantize": {"quantize": True},
             "fused_mlp": {"fused_mlp": True}}


@pytest.mark.parametrize("backbone", list(BACKBONES))
def test_make_serving_fn_matches_jax(two_stage, backbone):
    """Against the JAX make_serving_fn on the same backbone with the Pallas
    head in interpret mode: the f32 module backbone gives the same clamped
    counts and logits within rtol 1e-3 (the JAX package's own limit,
    tests/test_pallas_head.py); the int8 and K5 backbones agree on at least
    0.8 / 0.95 of the counts (the JAX package's bounds against its own f32
    path, tests/test_quantized.py) and give finite logits."""
    jm, params, tm, x = two_stage
    flags = BACKBONES[backbone]
    counts_j, out_j = jax_serving(jm, use_pallas=True, interpret=True,
                                  **flags)(params, jnp.asarray(x))
    counts, out = make_serving_fn(tm, device="cpu", **flags)(x)
    counts_j, out_j = np.asarray(counts_j), np.asarray(out_j)
    assert counts.shape == (2, 64) and out.shape == (2, 3)
    assert len(np.unique(counts_j)) > 1   # not all clamped to one value
    if backbone == "plain":
        np.testing.assert_array_equal(counts.numpy(), counts_j)
        np.testing.assert_allclose(out.numpy(), out_j, rtol=1e-3, atol=1e-4)
    else:
        agree = np.mean(counts.numpy() == counts_j)
        assert agree >= (0.8 if backbone == "quantize" else 0.95), agree
        assert torch.isfinite(out).all()


def test_make_serving_fn_is_the_composition(two_stage):
    """infer(x) == K9 on the module's features, round, clamp, one-hot and
    relu(W); a gumbel model is rejected."""
    _, _, tm, x = two_stage
    xt = torch.from_numpy(x)
    clamped, logits = make_serving_fn(tm, device="cpu")(xt)
    with torch.no_grad():
        conv = tm.add_on.conv1x1
        counts = fused_count_head(tm.backbone(xt), conv.weight, conv.bias)
        _, pooled, out = tm(xt, inference=True)
    want = torch.clamp(torch.round(counts), 0, 3)
    assert torch.equal(clamped, want) and torch.equal(clamped, pooled)
    enc = create_modified_encoding(want, 3).reshape(2, -1)
    torch.testing.assert_close(
        logits, enc @ torch.relu(tm.classification.weight).t())
    torch.testing.assert_close(logits, out, rtol=1e-5, atol=1e-6)
    gumbel, _ = get_count_network(
        3, type("G", (Args,), {"activation": "gumbel_softmax"}))
    with pytest.raises(ValueError, match="softmax"):
        make_serving_fn(gumbel, device="cpu")


def test_int8_downsample_and_dynamic_blocks_match_jax():
    """fused_block_convnext_apply(int8_min_dim=96, int8_downsample=True)
    without act_scales on the 4-stage model (tests/test_quantized.py:
    241-264): the blocks of widths 96 and 192 in the dynamic int8 mode and
    the stride-1 192 -> 384 downsample as im2col + K10, f32 planes: within
    1e-3 of the largest feature of the JAX package's (the same int8
    operands unless a rounding flips)."""
    _, params, tm, x = _pair(4, seed=2)
    want = np.asarray(jq.fused_block_convnext_apply(
        params["backbone"], jnp.asarray(x), stride_threshold=100,
        num_stages=4, dtype=jnp.float32, int8_min_dim=96,
        int8_downsample=True, interpret=True))
    prepared = tq.prepare_fused_blocks(tm.backbone, None, 96,
                                       fused_head=False,
                                       int8_downsample=True)
    assert set(prepared) >= {"features_4", "features_1_block_0",
                             "features_3_block_0"}
    assert all(pb["dynamic"] for s, pb in prepared.items() if "_block_" in s)
    got = tq.fused_block_convnext_apply(
        tm.backbone, torch.from_numpy(x), dtype=torch.float32,
        int8_min_dim=96, int8_downsample=True)
    assert got.shape == want.shape == (2, 3, 3, 384)
    assert _rel(got.numpy(), want) < 1e-3
