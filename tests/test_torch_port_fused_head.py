"""K9's plain version (count_pipnet_tpu_torch/ops/fused_head.py) against the
JAX package's fused_count_head (ops/pallas/fused_head.py) in interpret mode
and its XLA reference, on the same numpy-seeded inputs. The port takes the
1x1 conv's weight as [P, C], the JAX function as [C, P].

On a CUDA tensor the same wrapper launches K9; chip_smoke.py holds it
against this plain version on the card, and each of its launches against
the plain stage tested here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.ops.pallas.fused_head import (
    fused_count_head as jax_fused_count_head, fused_count_head_reference)
from count_pipnet_tpu_torch.ops.fused_head import (
    fused_count_head, fused_count_head_plain, fused_count_head_split_plain,
    head_logits_plain, head_logits_stats, head_partial_counts,
    head_partial_counts_plain, head_row_stats_plain, prepare_count_head,
    split_features, split_features_plain)


def _inputs(hw, c, p, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(2, hw, hw, c)).astype(np.float32)
    w = (rng.normal(size=(c, p)) * scale).astype(np.float32)
    b = (rng.normal(size=(p,)) * 0.1).astype(np.float32)
    return feats, w, b


def _port(feats, w, b):
    return fused_count_head(torch.from_numpy(feats),
                            torch.from_numpy(np.ascontiguousarray(w.T)),
                            torch.from_numpy(b)).numpy()


@pytest.mark.parametrize("hw,c,p", [(6, 128, 128), (22, 128, 256),
                                    (27, 128, 128)],
                         ids=["6x6", "22x22", "ragged_27x27"])
def test_plain_matches_pallas_and_reference(hw, c, p):
    """rtol/atol 1e-4, the JAX package's own parity limit
    (tests/test_pallas_head.py); 27x27 = 729 patches leaves a ragged last
    tile on both sides."""
    feats, w, b = _inputs(hw, c, p, seed=hw)
    got = _port(feats, w, b)
    assert got.shape == (2, p) and got.dtype == np.float32
    want = np.asarray(jax_fused_count_head(
        jnp.asarray(feats), jnp.asarray(w), jnp.asarray(b), tile_hw=128,
        interpret=True))
    ref = np.asarray(fused_count_head_reference(
        jnp.asarray(feats), jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_counts_sum_to_num_patches():
    """Softmax rows sum to one, so each image's counts sum to H*W
    (relative 1e-4)."""
    feats, w, _ = _inputs(5, 128, 128, seed=1, scale=1.0)
    got = _port(feats, w, np.zeros(128, np.float32))
    np.testing.assert_allclose(got.sum(axis=1), 25.0, rtol=1e-4)


def test_identity_head_and_bf16_features():
    """num_features=0: the identity weight and a zero bias give the
    per-patch softmax of the features themselves; bf16 features are read
    as they are (the same values as their f32 copy, 1e-6)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 4, 4, 64)).astype(np.float32))
    eye, zero = torch.eye(64), torch.zeros(64)
    want = torch.softmax(x.reshape(2, 16, 64), dim=-1).sum(1)
    torch.testing.assert_close(fused_count_head(x, eye, zero), want,
                               rtol=1e-6, atol=1e-6)
    xb = x.to(torch.bfloat16)
    torch.testing.assert_close(fused_count_head(xb, eye, zero),
                               fused_count_head(xb.float(), eye, zero),
                               rtol=1e-6, atol=1e-6)
    # the conv's own [P, C, 1, 1] weight is taken as well
    torch.testing.assert_close(
        fused_count_head(x, eye.reshape(64, 64, 1, 1), zero), want,
        rtol=1e-6, atol=1e-6)


def test_dispatch_rejects_other_devices():
    """A CPU tensor runs the plain version; another device raises."""
    x = torch.randn(1, 2, 2, 32)
    w, b = torch.randn(8, 32), torch.randn(8)
    assert torch.equal(fused_count_head(x, w, b),
                       fused_count_head_plain(x, w, b))
    with pytest.raises(ValueError):
        fused_count_head(x.to("meta"), w, b)


# ---- K9's launches in their plain versions (ops/fused_head.py) ----
#
# On the card K9 computes the logits from bf16 halves of each operand
# (prepare_count_head, split_features) in a GEMM that also gives the rows'
# softmax statistics per column tile; a row kernel sums their probabilities
# per 64-row subtile of an image. The weights below are scaled so that the
# logits reach O(5): there the low halves matter
# (test_hi_only_product_misses_the_limit).

def _split_inputs(hw, c, p, seed):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(2, hw, hw, c)).astype(np.float32)
    w = (rng.normal(size=(p, c)) * 5.0 / np.sqrt(c)).astype(np.float32)
    b = (rng.normal(size=(p,)) * 0.5).astype(np.float32)
    return feats, w, b


def _jax_counts(feats, w, b, dtype):
    """The JAX package's fused_count_head (interpret mode) and its XLA
    reference on the same features (``w`` [P, C], the port's layout)."""
    x = jnp.asarray(feats, dtype=dtype)
    wj, bj = jnp.asarray(np.ascontiguousarray(w.T)), jnp.asarray(b)
    return (np.asarray(jax_fused_count_head(x, wj, bj, tile_hw=128,
                                            interpret=True)),
            np.asarray(fused_count_head_reference(x, wj, bj)))


def _split_port(feats, w, b, dtype, hi_only=False):
    x = torch.from_numpy(feats).to(dtype)
    prep = prepare_count_head(torch.from_numpy(w), torch.from_numpy(b))
    return fused_count_head_split_plain(x, prep, hi_only=hi_only).numpy()


@pytest.mark.parametrize("hw,p,dtype", [
    (27, 256, "float32"), (27, 768, "bfloat16"), (26, 768, "float32"),
    (26, 256, "bfloat16")],
    ids=["ragged_27x27_p256_f32", "ragged_27x27_p768_bf16",
         "image_boundary_26x26_p768_f32", "image_boundary_26x26_p256_bf16"])
def test_split_stages_match_pallas_and_reference(hw, p, dtype):
    """The split operands, the GEMM's logits and row statistics, the row
    kernel and the ordered sum composed (fused_count_head_split_plain)
    against the JAX package at its parity limit, rtol/atol 1e-4. 27x27
    leaves a ragged last subtile; at 26x26 (676 rows an image) the GEMM's
    128-row tile 5 holds rows of image 0 and of image 1."""
    feats, w, b = _split_inputs(hw, 128, p, seed=hw + p)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if dtype == "bfloat16":  # both sides read the same bf16 values
        feats = torch.from_numpy(feats).to(tdt).float().numpy()
    got = _split_port(feats, w, b, tdt)
    want, ref = _jax_counts(feats, w, b, jdt)
    assert got.shape == (2, p) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hi_only_product_misses_the_limit(dtype):
    """One bf16 product (x_hi w_hi, no low halves) on the same inputs is
    outside 1e-4, so the parity test would catch a dropped low term."""
    feats, w, b = _split_inputs(26, 128, 256, seed=3)
    tdt = getattr(torch, dtype)
    if dtype == "bfloat16":
        feats = torch.from_numpy(feats).to(tdt).float().numpy()
    _, ref = _jax_counts(feats, w, b, getattr(jnp, dtype))
    np.testing.assert_allclose(_split_port(feats, w, b, tdt), ref,
                               rtol=1e-4, atol=1e-4)
    hi = _split_port(feats, w, b, tdt, hi_only=True)
    assert not np.allclose(hi, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_prototypes_match_pallas(dtype):
    """P = 100 is padded to 104 (zero weight rows, a bias of -inf); the
    padded operands' plain path gives the JAX package's counts, the padding
    sliced off."""
    feats, w, b = _split_inputs(9, 64, 100, seed=100)
    tdt = getattr(torch, dtype)
    if dtype == "bfloat16":
        feats = torch.from_numpy(feats).to(tdt).float().numpy()
    got = _split_port(feats, w, b, tdt)
    want, ref = _jax_counts(feats, w, b, getattr(jnp, dtype))
    assert got.shape == (2, 100)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_prepare_count_head_splits_and_pads():
    """[w_hi | w_lo] in bf16 with w_hi + w_lo within 2^-16 of w, P padded
    to a multiple of 8 by zero rows with a bias of -inf."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.normal(size=(100, 64)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(100,)).astype(np.float32))
    prep = prepare_count_head(w.reshape(100, 64, 1, 1), b)
    assert prep["p"] == 100 and prep["w"].shape == (104, 128)
    assert prep["w"].dtype == torch.bfloat16
    hi, lo = prep["w"][:100].float().split(64, dim=1)
    assert torch.equal(hi, w.to(torch.bfloat16).float())
    assert ((hi + lo - w).abs() <= 2.0 ** -16 * w.abs()).all()
    assert not prep["w"][100:].any()
    assert torch.equal(prep["b"][:100], b)
    assert torch.isneginf(prep["b"][100:]).all()


def test_split_features_plain_is_the_bf16_pair():
    """x_hi = bf16(x), x_lo = bf16(x - x_hi): x_hi + x_lo within 2^-16 of x
    (the kernel's split is held to this bit for bit on the card)."""
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(50, 64)).astype(np.float32))
    hi, lo = split_features_plain(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, x.to(torch.bfloat16))
    assert ((hi.float() + lo.float() - x).abs() <= 2.0 ** -16 * x.abs()).all()


@pytest.mark.parametrize("bn", [64, 128, 256])
def test_row_stats_combine_to_the_row_softmax(bn):
    """The GEMM's row statistics, combined in tile order, give each row's
    max and sum of exp(l - max) over all its columns (padded columns -inf),
    and the row kernel's subtiles add up to the softmax sums."""
    feats, w, b = _split_inputs(9, 64, 100, seed=6)
    x = torch.from_numpy(feats).reshape(-1, 64)
    prep = prepare_count_head(torch.from_numpy(w), torch.from_numpy(b))
    logits = head_logits_plain(x, prep)
    stats = head_row_stats_plain(logits, bn)
    assert stats.shape == (81 * 2, -(-104 // bn), 2)
    mx = stats[..., 0].amax(-1)
    s = (stats[..., 1] * torch.exp(stats[..., 0] - mx[:, None])).sum(-1)
    torch.testing.assert_close(mx, logits.amax(-1), rtol=0, atol=0)
    torch.testing.assert_close(s, torch.exp(logits - mx[:, None]).sum(-1),
                               rtol=1e-6, atol=0)
    part = head_partial_counts_plain(logits, stats, 2, 81)
    assert part.shape == (2, 2, 104)
    torch.testing.assert_close(
        part.sum(1), torch.softmax(logits, -1).reshape(2, 81, -1).sum(1),
        rtol=1e-5, atol=1e-5)


def test_launch_wrappers_on_the_cpu_run_their_plain_versions():
    """Each launch's wrapper, given CPU tensors, returns its plain
    version's result; fused_count_head with prepared operands still runs
    the f32 plain version."""
    feats, w, b = _split_inputs(6, 64, 64, seed=7)
    x = torch.from_numpy(feats)
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    prep = prepare_count_head(wt, bt)
    x2 = x.reshape(-1, 64)
    for got, want in zip(split_features(x2), split_features_plain(x2)):
        assert torch.equal(got, want)
    logits, stats = head_logits_stats(x2, prep)
    assert torch.equal(logits, head_logits_plain(x2, prep))
    assert torch.equal(stats, head_row_stats_plain(logits))
    assert torch.equal(head_partial_counts(logits, stats, 2, 36),
                       head_partial_counts_plain(logits, stats, 2, 36))
    assert torch.equal(fused_count_head(x, wt, bt, prepared=prep),
                       fused_count_head_plain(x, wt, bt))
