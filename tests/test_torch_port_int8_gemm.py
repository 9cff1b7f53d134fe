"""K10's plain version (count_pipnet_tpu_torch/ops/int8_gemm.py) and the
int8 downsample of the serving backbone against the JAX package's
int8_quant_gemm (ops/pallas/int8_gemm.py, interpret mode) and its conv, on
the same numpy-seeded inputs.

On a CUDA tensor the same wrapper launches K10 (its row quantize pass,
then the s8 GEMM with the row-scale epilogue, each with a plain version of
its own); chip_smoke.py holds it and each launch against these plain
versions on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.models.quantized import _conv as jax_conv
from count_pipnet_tpu.ops.pallas.fused_block import (
    _quant_rows as jax_quant_rows)
from count_pipnet_tpu.ops.pallas.int8_gemm import (
    int8_quant_gemm as jax_int8_quant_gemm,
    quantize_gemm_weights as jax_quantize_gemm_weights)
from count_pipnet_tpu_torch.models.quantized import im2col_2x2
from count_pipnet_tpu_torch.ops.int8_gemm import (int8_quant_gemm,
                                                  int8_quant_gemm_plain,
                                                  int8_rowscale_gemm,
                                                  int8_rowscale_gemm_plain,
                                                  prepare_gemm,
                                                  quant_rows,
                                                  quant_rows_int8,
                                                  quant_rows_int8_plain,
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


def _rows_with_ties(m, k, seed, bf16_valued=False):
    """[m, k] f32 rows, seeded: row 1 has abs-max 127 (scale 1) and values
    halfway between integers (round half to even), row 3 is all zero;
    ``bf16_valued``: every value representable in bf16 (the route's
    columns)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    x[1] = (rng.integers(-126, 126, size=k) + 0.5).astype(np.float32)
    x[1, 0] = 127.0
    x[3] = 0.0
    if bf16_valued:
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [768, 1536])
def test_plain_matches_pallas_at_downsample_k(k, out_dtype):
    """The downsample GEMMs' depths K = 768 and 1536 at N = 32 and a ragged
    M = 100 (against the JAX row tile of 16), with halfway values and a zero
    row: the plain version against the Pallas kernel (interpret mode),
    f32 out within 1e-6 of the largest value, bf16 out within one bf16 ulp
    of it (4e-3)."""
    x = _rows_with_ties(100, k, seed=k)
    rng = np.random.default_rng(k + 1)
    w = (rng.normal(size=(k, 32)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(32,)) * 0.1).astype(np.float32)
    got = int8_quant_gemm(torch.from_numpy(x),
                          prepare_gemm(torch.from_numpy(w),
                                       torch.from_numpy(b)),
                          getattr(torch, out_dtype))
    want = np.asarray(jax_int8_quant_gemm(
        jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b),
        out_dtype=getattr(jnp, out_dtype), row_tile=16, interpret=True),
        np.float32)
    tol = 1e-6 if out_dtype == "float32" else 4e-3
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("bf16_valued", [False, True])
@pytest.mark.parametrize("k", [128, 768, 1536])
def test_quant_rows_equal_jax(k, bf16_valued):
    """K10's row quantization (the plain version of its first launch) is
    the JAX package's _quant_rows bit for bit: the same int8 rows (halfway
    values to even, a zero row to zeros) and the same f32 scales."""
    x = _rows_with_ties(37, k, seed=2 * k + bf16_valued,
                        bf16_valued=bf16_valued)
    q, scale = quant_rows_int8_plain(torch.from_numpy(x))
    jq, jscale = jax_quant_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale)[:, 0])
    assert q.dtype == torch.int8 and not q[3].any()
    assert torch.equal(q, quant_rows(torch.from_numpy(x))[0].to(torch.int8))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [768, 1536])
def test_launch_plain_versions_compose(k, out_dtype):
    """K10's two launches, through their wrappers on CPU tensors (their
    plain versions), compose to the whole function's plain version exactly;
    the wrappers dispatch a CPU tensor to the plain versions."""
    dt = getattr(torch, out_dtype)
    x = torch.from_numpy(_rows_with_ties(50, k, seed=k + 7))
    prep = prepare_gemm(0.05 * torch.randn(k, 48), 0.1 * torch.randn(48))
    xq, asc = quant_rows_int8(x)
    assert torch.equal(xq, quant_rows_int8_plain(x)[0])
    got = int8_rowscale_gemm(xq, asc, prep, dt)
    assert torch.equal(got, int8_rowscale_gemm_plain(xq, asc, prep, dt))
    assert torch.equal(got, int8_quant_gemm_plain(x, prep, dt))
