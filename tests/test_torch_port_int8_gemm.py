"""K10's plain version (count_pipnet_tpu_torch/ops/int8_gemm.py) and the
int8 downsample of the serving backbone against the JAX package's
int8_quant_gemm (ops/pallas/int8_gemm.py, interpret mode) and its conv, on
the same numpy-seeded inputs.

On a CUDA tensor the same wrapper launches K10; chip_smoke.py holds it
against this plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.models.quantized import _conv as jax_conv
from count_pipnet_tpu.ops.pallas.int8_gemm import (
    int8_quant_gemm as jax_int8_quant_gemm,
    quantize_gemm_weights as jax_quantize_gemm_weights)
from count_pipnet_tpu_torch.models.quantized import im2col_2x2
from count_pipnet_tpu_torch.ops.int8_gemm import (int8_quant_gemm,
                                                  int8_quant_gemm_plain,
                                                  prepare_gemm,
                                                  quant_rows,
                                                  quantize_gemm_weights)


def test_quantize_gemm_weights_equal_jax():
    """Exactly the JAX package's int8 weights and scales, an all-zero
    column included."""
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(96, 48)) * 0.1).astype(np.float32)
    w[:, 7] = 0.0
    q, s = quantize_gemm_weights(torch.from_numpy(w))
    jq, js = jax_quantize_gemm_weights(jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    prep = prepare_gemm(torch.from_numpy(w))
    np.testing.assert_array_equal(prep["wq"].numpy(), np.asarray(jq).T)
    assert prep["b"].abs().max() == 0


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas(out_dtype):
    """(70, 64) x (64, 48) with a bias, ragged against the JAX row tile of
    16: f32 out within 1e-6 of the largest value (the same integer sums,
    the epilogue rounded alike); bf16 out within one bf16 ulp of it
    (4e-3)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(70, 64)).astype(np.float32)
    x[3] = 0.0                          # a zero row: scale 1e-9 / 127
    w = (rng.normal(size=(64, 48)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(48,)) * 0.1).astype(np.float32)
    got = int8_quant_gemm(torch.from_numpy(x),
                          prepare_gemm(torch.from_numpy(w),
                                       torch.from_numpy(b)),
                          getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (70, 48)
    want = np.asarray(jax_int8_quant_gemm(
        jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b),
        out_dtype=getattr(jnp, out_dtype), row_tile=16, interpret=True),
        np.float32)
    tol = 1e-6 if out_dtype == "float32" else 4e-3
    scale = np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= tol * scale
    if out_dtype == "float32":  # a zero row gives the bias exactly
        np.testing.assert_array_equal(got[3].numpy(), b)


def test_quant_rows_rule():
    """max(amax, 1e-9) / 127, round half to even, no clip."""
    x = torch.tensor([[0.5, -1.27, 1.27], [0.0, 0.0, 0.0]])
    q, s = quant_rows(x)
    torch.testing.assert_close(s, torch.tensor([[1.27 / 127], [1e-9 / 127]]))
    assert q.tolist() == [[50.0, -127.0, 127.0], [0.0, 0.0, 0.0]]


def test_int8_downsample_matches_conv():
    """The stride-1 2x2 im2col + K10's plain version equals the JAX
    package's f32 conv within 2e-2 of the largest value (int8 rounding; the
    JAX package's own bound, tests/test_quantized.py:203-222), and the
    JAX im2col + int8_quant_gemm within 1e-6."""
    rng = np.random.default_rng(1)
    b, h, w, cin, cout = 2, 9, 9, 32, 48
    hn = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    kern = (rng.normal(size=(2, 2, cin, cout)) * 0.1).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    ref = np.asarray(jax_conv(jnp.asarray(hn), jnp.asarray(kern),
                              jnp.asarray(bias), 1, jnp.float32))
    cols = im2col_2x2(torch.from_numpy(hn))
    assert cols.shape == (b, h - 1, w - 1, 4 * cin)
    oihw = torch.from_numpy(kern).permute(3, 2, 0, 1)
    wmat = oihw.permute(2, 3, 1, 0).reshape(4 * cin, cout)
    got = int8_quant_gemm_plain(cols.reshape(-1, 4 * cin),
                                prepare_gemm(wmat, torch.from_numpy(bias)))
    got = got.reshape(b, h - 1, w - 1, cout).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 2e-2 * scale
    jcols = jnp.concatenate([hn[:, :-1, :-1], hn[:, :-1, 1:],
                             hn[:, 1:, :-1], hn[:, 1:, 1:]], axis=-1)
    want = np.asarray(jax_int8_quant_gemm(
        jcols.reshape(-1, 4 * cin), jnp.asarray(kern).reshape(4 * cin, cout),
        bias=jnp.asarray(bias), row_tile=32, interpret=True))
    assert np.abs(got.reshape(-1, cout) - want).max() <= 1e-6 * scale


def test_dispatch_and_validation():
    """A CPU tensor runs the plain version; another device raises."""
    x = torch.randn(5, 64)
    prep = prepare_gemm(torch.randn(64, 32))
    assert torch.equal(int8_quant_gemm(x, prep),
                       int8_quant_gemm_plain(x, prep))
    with pytest.raises(ValueError):
        int8_quant_gemm(x.to("meta"), prep)
