"""K9's plain version (count_pipnet_tpu_torch/ops/fused_head.py) against the
JAX package's fused_count_head (ops/pallas/fused_head.py) in interpret mode
and its XLA reference, on the same numpy-seeded inputs. The port takes the
1x1 conv's weight as [P, C], the JAX function as [C, P].

On a CUDA tensor the same wrapper launches K9; chip_smoke.py holds it
against this plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.ops.pallas.fused_head import (
    fused_count_head as jax_fused_count_head, fused_count_head_reference)
from count_pipnet_tpu_torch.ops.fused_head import (fused_count_head,
                                                   fused_count_head_plain)


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
