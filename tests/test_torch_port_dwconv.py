"""K7 and K8, the depthwise 7x7 kernels (count_pipnet_tpu_torch/ops/dwconv.py,
dwconv_bwd.py): their plain versions against the JAX package's Pallas
kernels (interpret mode) and its XLA conv, and the two autograd Functions
against ``jax.vjp`` of the JAX package's ``_dw_conv``. Ragged planes
(9x9, 14x13, 6x11), 8 to 64 channels, and the planes a halo tile gets
wrong most easily (H or W below 7, a single column, a single image, 24 and
96 channels: chip_smoke.py holds K7 and K8 against their plain versions on
the card at the same kinds of plane; K8 also on planes its strips of four
rows split unevenly, and on bf16 planes), inputs from numpy seeds. The port takes the
torch weight layout [C, 1, 7, 7], JAX the flax [7, 7, 1, C]."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.ops.pallas.dwconv import dwconv7 as j_dwconv7
from count_pipnet_tpu.ops.pallas.dwconv_bwd import _dw_conv
from count_pipnet_tpu.ops.pallas.dwconv_bwd import \
    dwconv7_wgrad as j_dwconv7_wgrad
from count_pipnet_tpu_torch.ops.dwconv import dwconv7, dwconv7_plain
from count_pipnet_tpu_torch.ops.dwconv_bwd import (dwconv7_ad,
                                                   dwconv7_pfwd_ad,
                                                   dwconv7_wgrad,
                                                   dwconv7_wgrad_plain)

SHAPES = [(2, 9, 9, 8), (2, 14, 13, 32), (1, 6, 11, 64), (1, 3, 5, 24),
          (2, 9, 1, 96), (1, 5, 3, 96), (2, 14, 13, 40)]
# planes K8's halo tile splits unevenly: strips of four rows over 27 (an odd
# last strip) and 26 rows, channels past the last whole slab (40)
WGRAD_SHAPES = SHAPES + [(2, 27, 27, 40), (1, 26, 26, 64)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _setup(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (rng.normal(size=shape).astype(np.float32),
            (rng.normal(size=(7, 7, 1, c)) * 0.1).astype(np.float32),
            rng.normal(size=(c,)).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _torch_weight(k):
    """flax [7, 7, 1, C] -> torch [C, 1, 7, 7]."""
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _f32(a):
    return np.asarray(a, np.float32)


def _within_bf16_ulp(got, ref, atol=1e-6):
    """|got - ref| at most one bf16 ulp of the larger magnitude (bf16 keeps
    8 significant bits), plus ``atol`` for sums that cancel near zero."""
    mag = np.maximum(np.abs(got), np.abs(ref))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert (np.abs(got - ref) <= ulp + atol).all(), \
        np.abs(got - ref).max()


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_dwconv7_plain_matches_pallas_and_xla(shape, dt):
    """f32: the Pallas kernel and the XLA conv to 1e-5 relative (1e-5 of
    the largest value absolute, for outputs that cancel). bf16 planes: one
    bf16 ulp of the output."""
    jdt, tdt = DTYPES[dt]
    x, k, b, _ = _setup(shape, seed=shape[-1])
    xj = jnp.asarray(x, jdt)
    xt = torch.tensor(_f32(xj)).to(tdt)
    got = _f32(dwconv7_plain(xt, _torch_weight(k),
                             torch.from_numpy(b)).float())
    pallas = _f32(j_dwconv7(xj, k, b, interpret=True))
    xla = _f32(_dw_conv(xj.astype(jnp.float32), k, b,
                        jnp.float32).astype(jdt))
    for ref in (pallas, xla):
        if dt == "f32":
            np.testing.assert_allclose(got, ref, rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max())
        else:
            _within_bf16_ulp(got, ref)
    # the wrapper takes the plain version for a CPU tensor, and writes the
    # asked-for dtype
    via = dwconv7(xt, _torch_weight(k), torch.from_numpy(b))
    assert via.dtype == tdt
    np.testing.assert_array_equal(_f32(via.float()), got)
    wide = dwconv7(xt, _torch_weight(k), torch.from_numpy(b),
                   out_dtype=torch.float32)
    assert wide.dtype == torch.float32


@pytest.mark.parametrize("shape", WGRAD_SHAPES)
def test_wgrad_plain_matches_pallas_interpret(shape):
    """dK and db against the Pallas kernel in f32: rtol/atol 1e-4."""
    x, _, _, g = _setup(shape, seed=shape[-1] + 1)
    dk, db = dwconv7_wgrad_plain(torch.from_numpy(x), torch.from_numpy(g))
    dk_j, db_j = j_dwconv7_wgrad(jnp.asarray(x), jnp.asarray(g),
                                 interpret=True)
    assert dk.shape == (shape[-1], 1, 7, 7) and dk.dtype == torch.float32
    np.testing.assert_allclose(dk.numpy(),
                               _f32(dk_j).transpose(3, 2, 0, 1),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(db.numpy(), _f32(db_j), rtol=1e-4,
                               atol=1e-4)
    via = dwconv7_wgrad(torch.from_numpy(x), torch.from_numpy(g))
    for a, b in zip(via, (dk, db)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _round_bf16(a):
    """f32 -> the nearest bf16 value (ties to even), kept in f32."""
    u = a.astype(np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


@pytest.mark.parametrize("shape", [(2, 14, 13, 40), (1, 3, 5, 24),
                                   (2, 27, 27, 40), (1, 26, 26, 64)])
def test_wgrad_plain_matches_pallas_interpret_bf16(shape):
    """bf16 planes (x and g rounded to bf16 with numpy): the plain sums
    against the Pallas kernel on the same bf16 arrays, rtol/atol 1e-4 (both
    sum the bf16 values in f32)."""
    x, _, _, g = _setup(shape, seed=shape[-1] + 2)
    x, g = _round_bf16(x), _round_bf16(g)
    xt, gt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, g))
    dk, db = dwconv7_wgrad_plain(xt, gt)
    dk_j, db_j = j_dwconv7_wgrad(jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(g, jnp.bfloat16),
                                 interpret=True)
    assert dk.dtype == torch.float32 and db.dtype == torch.float32
    np.testing.assert_allclose(dk.numpy(),
                               _f32(dk_j).transpose(3, 2, 0, 1),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(db.numpy(), _f32(db_j), rtol=1e-4,
                               atol=1e-4)
    via = dwconv7_wgrad(xt, gt)
    for a, b in zip(via, (dk, db)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _ref_vjp(x, k, b, g, jdt):
    y, pull = jax.vjp(lambda xx, kk, bb: _dw_conv(xx, kk, bb, jdt), x, k, b)
    return y, pull(jnp.asarray(g).astype(y.dtype))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("fn", ["dwconv7_ad", "dwconv7_pfwd_ad"])
def test_autograd_functions_match_jax_vjp(fn, dt):
    """The tolerances of tests/test_dwconv_bwd.py:59-70: the output to
    1e-5 relative (bf16: one bf16 ulp, since the two frameworks' bf16
    convs may round a sum the other way); dx, dK, db to 1e-4 in f32 and
    3e-2 in bf16 (of each gradient's largest value for dK and db). The
    K7 forward's reference is what the JAX package's ``dwconv7_pfwd_ad``
    computes on its chip, the Pallas kernel on ``x.astype(dtype)`` with
    f32 taps; the rest is XLA's conv, which rounds the taps to ``dtype``."""
    jdt, tdt = DTYPES[dt]
    x, k, b, g = _setup((2, 12, 11, 16), seed=7)
    y_r, (dx_r, dk_r, db_r) = _ref_vjp(x, k, b, g, jdt)
    if fn == "dwconv7_pfwd_ad":
        y_r = j_dwconv7(jnp.asarray(x, jdt), k, b, interpret=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    kt = _torch_weight(k).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    f = {"dwconv7_ad": dwconv7_ad, "dwconv7_pfwd_ad": dwconv7_pfwd_ad}[fn]
    y = f(xt, kt, bt, tdt)
    assert y.dtype == tdt
    y.backward(torch.from_numpy(g).to(tdt))
    got_y, ref_y = _f32(y.detach().float()), _f32(y_r)
    if dt == "f32":
        np.testing.assert_allclose(got_y, ref_y, rtol=1e-5, atol=1e-6)
    else:
        _within_bf16_ulp(got_y, ref_y)
    tol = 1e-4 if dt == "f32" else 3e-2
    np.testing.assert_allclose(xt.grad.numpy(), _f32(dx_r), rtol=tol,
                               atol=tol)
    dk_ref = _f32(dk_r).transpose(3, 2, 0, 1)
    np.testing.assert_allclose(kt.grad.numpy(), dk_ref, rtol=tol,
                               atol=tol * np.abs(dk_ref).max())
    np.testing.assert_allclose(bt.grad.numpy(), _f32(db_r), rtol=tol,
                               atol=tol * np.abs(_f32(db_r)).max())


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor neither on the CPU nor on a CUDA card
    raises."""
    x = torch.zeros(1, 6, 6, 8, device="meta")
    w, b = torch.zeros(8, 1, 7, 7), torch.zeros(8)
    with pytest.raises(ValueError, match="unsupported device"):
        dwconv7(x, w, b)
    with pytest.raises(ValueError, match="unsupported device"):
        dwconv7_wgrad(x, x)
