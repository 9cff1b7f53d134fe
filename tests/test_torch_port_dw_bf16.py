"""Kernel A's bf16 depthwise taps (``dw_bf16``) in the port against the
JAX package, on the CPU (the plain versions; the CUDA kernel is held
against them on the card by chip_smoke.py).

(a) The tap helper ``dwconv7_bf16_taps_plain`` against the same tap
    arithmetic written with jnp bf16 ops and run eagerly: each eager op
    rounds to bf16, as the TPU kernel does, so the two are equal bit for
    bit. Under ``jit`` (and so in Pallas interpret mode) XLA on the CPU
    keeps excess precision for bf16 and does not round after every op.
(b) ``fused_block(..., dw_bf16=True)`` against ``fused_block_apply`` (K2)
    and ``fused_block_apply_padded`` (K1, in-kernel pad and unpad) with
    ``dw_bf16=True`` in interpret mode, in the three GEMM modes: the branch
    (out - x) / gamma within 3e-2 of its largest value, the JAX package's
    own limit for this mode (tests/test_fused_blocks.py:351,
    tests/test_quantized.py:238). 1e-2, kernel A's limit with f32 taps, is
    too tight here because of the interpret mode's excess precision
    (above): the readings are 0.44-0.46 % (bf16 GEMMs) and 1.32-1.57 %
    (int8 GEMMs, where a changed tap sum flips rounded int8 operands);
    with ``XLA_FLAGS=--xla_allow_excess_precision=false`` the same cases
    read 0.03-0.45 %, as with f32 taps (0.0-0.65 %).
(c) ``fused_block_convnext_apply(dw_bf16=True)`` on a narrow model against
    the JAX one, within tests/test_quantized.py:262-264's 3e-2.
(d) The serving-variants entry point on the CPU, small.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_ops import C, _amax, _params, _prepared
from test_torch_port_slice import SLICE, THRESHOLD

from count_pipnet_tpu.models import quantized as jq
from count_pipnet_tpu.models.convnext import ConvNeXtFeatures as JFeatures
from count_pipnet_tpu.ops.pallas import fused_block as jfb
from count_pipnet_tpu_torch.models import quantized as tq
from count_pipnet_tpu_torch.models.convert import backbone_from_jax_params
from count_pipnet_tpu_torch.models.convnext import ConvNeXtFeatures
from count_pipnet_tpu_torch.ops import fused_block as tfb
from count_pipnet_tpu_torch.scripts import bench_serving_variants

K = 7


def _jnp_taps(x, wk, bias):
    """The TPU kernels' bf16 tap arithmetic (``_dwconv_pad``) in eager jnp
    ops on a zero-padded NHWC plane."""
    _, h, w, _ = x.shape
    xp = jnp.pad(x.astype(jnp.bfloat16), ((0, 0), (3, 3), (3, 3), (0, 0)))
    wt = wk.astype(jnp.bfloat16)
    acc = jnp.broadcast_to(bias.astype(jnp.float32), x.shape)
    for dx in range(K):
        vs = None
        for dy in range(K):
            t = xp[:, dy:dy + h, dx:dx + w] * wt[dy * K + dx]
            vs = t if vs is None else vs + t
        acc = acc + vs.astype(jnp.float32)
    return acc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [9, 26], ids=["9x9", "26x26"])
def test_bf16_taps_plain_equal_eager_jnp(hw, dtype):
    rng = np.random.default_rng(hw)
    x = rng.normal(size=(2, hw, hw, C)).astype(np.float32)
    wk = (rng.normal(size=(K * K, C)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(C,)) * 0.1).astype(np.float32)
    want = np.asarray(_jnp_taps(jnp.asarray(x).astype(getattr(jnp, dtype)),
                                jnp.asarray(wk), jnp.asarray(bias)))
    got = tfb.dwconv7_bf16_taps_plain(
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(wk),
        torch.from_numpy(bias))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the taps really are bf16: f32 taps differ
    f32 = torch.nn.functional.conv2d(
        torch.from_numpy(x).to(getattr(torch, dtype)).float()
        .permute(0, 3, 1, 2), torch.from_numpy(wk).t().reshape(C, 1, K, K),
        torch.from_numpy(bias), padding=3, groups=C).permute(0, 2, 3, 1)
    assert not torch.equal(got, f32)


@pytest.mark.parametrize("mode", ["bf16", "int8_static", "int8_dynamic"])
@pytest.mark.parametrize("hw", [(9, 9), (26, 26)], ids=["9x9", "26x26"])
def test_fused_block_dw_bf16_matches_jax(mode, hw):
    h, w = hw
    tp, jp = _params(C, 7)
    x4 = np.random.default_rng(1).normal(size=(2, h, w, C)) \
        .astype(np.float32)
    scales = _amax(x4, tp) if mode == "int8_static" else None
    int8 = mode != "bf16"
    if mode == "int8_dynamic":
        pb = tfb.prepare_block(
            **{k: torch.from_numpy(v) for k, v in tp.items()}, int8=True)
    else:
        pb = _prepared(tp, scales)
    xt = torch.from_numpy(x4)
    got = tfb.fused_block(xt, pb, dw_bf16=True)
    assert torch.equal(got, tfb.fused_block_plain(xt, pb, dw_bf16=True))
    assert not torch.equal(got, tfb.fused_block(xt, pb))
    br_got = (got.numpy() - x4) / 0.1
    flat = jfb.fused_block_apply(
        jnp.asarray(x4.reshape(2, h * w, C)), h, w, *jp, int8=int8,
        act_scales=scales, dw_bf16=True, interpret=True)
    padded = jfb.fused_block_apply_padded(
        jnp.asarray(x4), h, w, *jp, int8=int8, act_scales=scales,
        dw_bf16=True, pad_in=True, unpad_out=True, interpret=True)
    for ref in (np.asarray(flat).reshape(2, h, w, C), np.asarray(padded)):
        br_ref = (ref - x4) / 0.1
        err = np.abs(br_got - br_ref).max()
        assert err <= 3e-2 * np.abs(br_ref).max(), err


def test_fused_block_convnext_apply_dw_bf16_matches_jax():
    """The narrow 4-stage model of test_torch_port_slice.py, dynamic int8
    at widths >= 64 and bf16 GEMMs below, bf16 taps in every block; on the
    JAX side stages 1-3 run K1 (padded) and stage 4 K2. The features within
    3e-2 of their largest value."""
    jm = JFeatures(SLICE, THRESHOLD, num_stages=7)
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)) \
        .astype(np.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.asarray(x[:1]))["params"])
    # layer scales 0.1 instead of the init's 1e-6, so each branch shows
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: np.full_like(v, 0.1)
        if "layer_scale" in jax.tree_util.keystr(p) else v, params)
    tm = ConvNeXtFeatures(SLICE, THRESHOLD, 7)
    tm.load_state_dict(backbone_from_jax_params(params))
    want = np.asarray(jq.fused_block_convnext_apply(
        params, jnp.asarray(x), stride_threshold=THRESHOLD, num_stages=7,
        stage_settings=SLICE, dtype=jnp.float32, int8_min_dim=64,
        dw_bf16=True, padded_max_dim=64, interpret=True))
    got = tq.fused_block_convnext_apply(
        tm.eval(), torch.from_numpy(x), dtype=torch.float32,
        int8_min_dim=64, dw_bf16=True).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=3e-2)


def test_bench_serving_variants_cpu(capsys):
    results = bench_serving_variants.main(["--device", "cpu", "--batch", "2",
                                           "--iters", "1"])
    out = capsys.readouterr().out
    for name in bench_serving_variants.VARIANTS:
        assert name in out and "img/s" in out
        assert results[name][1].shape == (2, 768)
        assert (results[name][1].sum(1) == 676).all()
    assert "counts agreement int8+ds_int8 vs int8+ds_int8+dwbf16:" in out
