"""The port's kernel modules (plain versions, CPU) against the JAX package's
Pallas kernels run in interpret mode, on the same numpy-seeded inputs.

count_pipnet_tpu_torch/ops/fused_block.py  vs  ops/pallas/fused_block.py
count_pipnet_tpu_torch/ops/gumbel_head.py  vs  ops/pallas/gumbel_head.py

On a CUDA tensor the same wrappers launch the CUDA kernels; those are held
against these plain versions on the GPU by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from count_pipnet_tpu.ops.pallas import fused_block as jfb
from count_pipnet_tpu.ops.pallas import gumbel_head as jgh
from count_pipnet_tpu_torch.ops import fused_block as tfb
from count_pipnet_tpu_torch.ops import gumbel_head as tgh

C = 128


def _params(c, seed, gamma=0.1):
    """torch-layout block parameters (numpy) and the same in flax layout."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(size=s).astype(np.float32)
    tp = dict(dw_weight=n(c, 1, 7, 7) * 0.1, dw_bias=n(c) * 0.01,
              ln_weight=1 + n(c) * 0.01, ln_bias=n(c) * 0.01,
              pw1_weight=n(4 * c, c) * 0.05, pw1_bias=n(4 * c) * 0.01,
              pw2_weight=n(c, 4 * c) * 0.05, pw2_bias=n(c) * 0.01,
              layer_scale=np.full((c,), gamma, np.float32))
    jp = (np.transpose(tp["dw_weight"], (2, 3, 1, 0)), tp["dw_bias"],
          tp["ln_weight"], tp["ln_bias"], tp["pw1_weight"].T,
          tp["pw1_bias"], tp["pw2_weight"].T, tp["pw2_bias"],
          tp["layer_scale"])
    return tp, jp


def _amax(x4, tp):
    """Calibrated (amax_ln, amax_gelu) of one block, numpy."""
    x = torch.from_numpy(x4)
    c = x.shape[-1]
    d = F.conv2d(x.permute(0, 3, 1, 2), torch.from_numpy(tp["dw_weight"]),
                 torch.from_numpy(tp["dw_bias"]), padding=3,
                 groups=c).permute(0, 2, 3, 1)
    nrm = F.layer_norm(d, (c,), torch.from_numpy(tp["ln_weight"]),
                       torch.from_numpy(tp["ln_bias"]), eps=1e-6)
    a = F.gelu(nrm @ torch.from_numpy(tp["pw1_weight"]).t()
               + torch.from_numpy(tp["pw1_bias"]), approximate="tanh")
    return (nrm.abs().amax(dim=(0, 1, 2)).numpy(),
            a.abs().amax(dim=(0, 1, 2)).numpy())


def _prepared(tp, scales):
    return tfb.prepare_block(
        **{k: torch.from_numpy(v) for k, v in tp.items()},
        int8=scales is not None,
        act_scales=None if scales is None
        else tuple(torch.from_numpy(s) for s in scales))


def _ref_counts(feats, noise):
    b, h, w, c = feats.shape
    winner = np.asarray(jnp.argmax(
        jnp.asarray(feats + noise).reshape(b, h * w, c), axis=-1))
    return np.stack([np.bincount(wi, minlength=c) for wi in winner]) \
        .astype(np.float32)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hw", [(9, 9), (26, 26)], ids=["9x9", "26x26"])
def test_fused_block_plain_matches_jax(int8, hw):
    """Plain block (both GEMM modes) vs JAX fused_block_apply (K2) and
    fused_block_apply_padded with in-kernel pad/unpad (K1): branch
    (out - x) / gamma within 1e-2 of the branch's max."""
    h, w = hw
    tp, jp = _params(C, 7)
    x4 = np.random.default_rng(1).normal(size=(2, h, w, C)) \
        .astype(np.float32)
    scales = _amax(x4, tp) if int8 else None
    got = tfb.fused_block(torch.from_numpy(x4), _prepared(tp, scales))
    br_got = (got.numpy() - x4) / 0.1
    flat = jfb.fused_block_apply(
        jnp.asarray(x4.reshape(2, h * w, C)), h, w, *jp, int8=int8,
        act_scales=scales, interpret=True)
    padded = jfb.fused_block_apply_padded(
        jnp.asarray(x4), h, w, *jp, int8=int8, act_scales=scales,
        pad_in=True, unpad_out=True, interpret=True)
    for ref in (np.asarray(flat).reshape(2, h, w, C), np.asarray(padded)):
        br_ref = (ref - x4) / 0.1
        err = np.abs(br_got - br_ref).max()
        assert err <= 1e-2 * np.abs(br_ref).max(), err


def test_quantize_block_weights_folded_equals_jax():
    rng = np.random.default_rng(3)
    k = rng.normal(size=(C, 4 * C)).astype(np.float32) * 0.05
    k[:, 5] = 0.0                      # an all-zero output channel
    amax = np.abs(rng.normal(size=(C,))).astype(np.float32)
    amax[3] = 0.0                      # clamped to 1e-9 on both sides
    jq, js, ji = jfb.quantize_block_weights_folded(k, amax)
    tq, ts, ti = tfb.quantize_block_weights_folded(torch.from_numpy(k),
                                                   torch.from_numpy(amax))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("shape", [(2, 5, 5, 128), (1, 26, 26, 128),
                                   (3, 4, 4, 128)],
                         ids=["small", "ragged_26x26", "batch_pad"])
def test_gumbel_hard_counts_plain_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    feats = rng.normal(size=shape).astype(np.float32)
    noise = rng.gumbel(size=shape).astype(np.float32)
    want = np.asarray(jgh.gumbel_hard_counts(
        jnp.asarray(feats), 0, noise=jnp.asarray(noise), interpret=True))
    got = tgh.gumbel_hard_counts(torch.from_numpy(feats),
                                 noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, _ref_counts(feats, noise))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_fused_block_gumbel_counts_plain_matches_jax(int8):
    h = w = 26
    tp, jp = _params(C, 11, gamma=1e-2)
    x4 = np.random.default_rng(2).normal(size=(2, h, w, C)) \
        .astype(np.float32)
    noise = np.random.default_rng(4).gumbel(size=(2, h * w, C)) \
        .astype(np.float32)
    scales = _amax(x4, tp) if int8 else None
    want = np.asarray(jgh.fused_block_gumbel_counts(
        jnp.asarray(x4.reshape(2, h * w, C)), h, w, *jp, 0, int8=int8,
        act_scales=scales, noise=jnp.asarray(noise), interpret=True))
    got = tgh.fused_block_gumbel_counts(
        torch.from_numpy(x4), _prepared(tp, scales),
        noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_array_equal(got.sum(axis=1), h * w)
    assert np.mean(got == want) >= 0.99


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    m = 0xFFFFFFFF
    cases = [((0, 0, 0, 0), 0,
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((m, m, m, m), (m << 32) | m,
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0x299f31d0 << 32) | 0xa4093822,
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in cases:
        words = tgh.philox4x32_10(
            *[torch.tensor([c], dtype=torch.int64) for c in ctr], key)
        assert tuple(int(w) for w in words) == want


def test_gumbel_noise_draw():
    a = tgh.gumbel_noise(7, 4, 100, 64)
    assert a.shape == (4, 100, 64) and a.dtype == torch.float32
    assert torch.equal(a, tgh.gumbel_noise(7, 4, 100, 64))
    assert not torch.equal(a, tgh.gumbel_noise(8, 4, 100, 64))
    assert torch.isfinite(a).all()
    # Gumbel(0, 1): mean is the Euler-Mascheroni constant, var pi^2 / 6
    assert abs(a.mean().item() - 0.5772) < 0.02
    assert abs(a.var().item() - 1.6449) < 0.05


def test_seeded_counts_structure():
    feats = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 26, 26, 200)).astype(np.float32))
    c1 = tgh.gumbel_hard_counts(feats, 7)
    assert torch.all(c1.sum(dim=1) == 676.0)
    assert torch.equal(c1, tgh.gumbel_hard_counts(feats, 7))
    assert not torch.equal(c1, tgh.gumbel_hard_counts(feats, 8))


def test_dispatch_and_validation():
    tp, _ = _params(32, 0)
    pb = _prepared(tp, None)
    x = torch.randn(1, 5, 5, 32)
    assert torch.equal(tfb.fused_block(x, pb), tfb.fused_block_plain(x, pb))
    with pytest.raises(ValueError):
        tfb.fused_block(x.to("meta"), pb)
    with pytest.raises(ValueError):
        tgh.gumbel_hard_counts(x.to("meta"))
    # int8 without act_scales is the dynamic per-row mode
    pd = tfb.prepare_block(**{k: torch.from_numpy(v) for k, v in tp.items()},
                           int8=True)
    assert pd["int8"] and pd["dynamic"] and pd["i1"] is None
    assert not pb["dynamic"] and not _prepared(tp, _amax(
        x.numpy(), tp))["dynamic"]
    assert torch.equal(tfb.fused_block(x, pd), tfb.fused_block_plain(x, pd))


def test_quantize_block_weights_equals_jax():
    """The dynamic mode's per-output-channel int8 weights: exactly the JAX
    package's, an all-zero channel included."""
    rng = np.random.default_rng(5)
    k = rng.normal(size=(C, 4 * C)).astype(np.float32) * 0.05
    k[:, 9] = 0.0
    jq, js = jfb.quantize_block_weights(k)
    tq, ts = tfb.quantize_block_weights(torch.from_numpy(k))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("hw", [(9, 9), (14, 13)], ids=["9x9", "14x13"])
def test_fused_block_dynamic_plain_matches_jax(hw):
    """The dynamic per-row int8 mode (``int8=True``, no act_scales)
    against the Pallas bodies ``_kernel_int8`` (fused_block_apply, K2) and
    ``_kernel_int8_pad`` (fused_block_apply_padded with in-kernel pad and
    unpad, K1): the output within 2e-3 of its largest value (the same
    int8 operands unless an f32 rounding flips one)."""
    h, w = hw
    tp, jp = _params(C, 7)
    x4 = np.random.default_rng(1).normal(size=(2, h, w, C)) \
        .astype(np.float32)
    pb = tfb.prepare_block(**{k: torch.from_numpy(v) for k, v in tp.items()},
                           int8=True)
    got = tfb.fused_block(torch.from_numpy(x4), pb).numpy()
    flat = jfb.fused_block_apply(
        jnp.asarray(x4.reshape(2, h * w, C)), h, w, *jp, int8=True,
        interpret=True)
    padded = jfb.fused_block_apply_padded(
        jnp.asarray(x4), h, w, *jp, int8=True, pad_in=True, unpad_out=True,
        interpret=True)
    for ref in (np.asarray(flat).reshape(2, h, w, C), np.asarray(padded)):
        assert np.abs(got - ref).max() <= 2e-3 * np.abs(ref).max()
