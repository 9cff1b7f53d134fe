"""Kernel A's stages (ops/fused_block.py) on the CPU: the plain versions of
the prologue, GEMM 1 and GEMM 2 of the bf16, int8-static and int8-dynamic
modes, whose composition is ``fused_block_plain``.

(a) The composition against the one-piece arithmetic it replaced (written
    out below as ``_one_piece``): equal in the int8 modes (float64 sums),
    within 1e-6 of the largest value in bf16; f32 and bf16 taps, f32 and
    bf16 planes. The int8 GEMM operands are the same integers, and in the
    dynamic mode the rows' scales the same floats.
(b) The composition against the JAX package's ``fused_block_apply`` (K2)
    and ``fused_block_apply_padded`` (K1, in-kernel pad and unpad), Pallas
    in interpret mode, at C = 32 and 64: the branch (out - x) / gamma
    within 1e-2 of its largest value, as tests/test_torch_port_ops.py holds
    the block.
(c) The stage wrappers and the s8 GEMM core's wrapper take their plain
    versions for CPU tensors; so does the dynamic mode's GEMM 1 scan pass,
    whose row maxima give the quantize pass alone the scales of GEMM 1
    whole.

The CUDA launches are held against these plain versions on the card by
chip_smoke.py (phase ``block``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_port_ops import _amax, _params, _prepared

from count_pipnet_tpu.ops.pallas import fused_block as jfb
from count_pipnet_tpu_torch.ops import fused_block as tfb
from count_pipnet_tpu_torch.ops.int8_gemm import quant_rows

MODES = ("bf16", "int8-static", "int8-dynamic")


def _one_piece(x, pb, eps=1e-6, dw_bf16=False):
    """The plain block as one function, the arithmetic the three stages
    must keep: (f32 output, int8 n or None, int8 hidden or None; in the
    dynamic mode each with its rows' scales)."""
    x32 = x.to(torch.float32)
    c = x.shape[-1]
    if dw_bf16:
        d = tfb.dwconv7_bf16_taps_plain(x, pb["dwk"], pb["dwb"])
    else:
        wk = pb["dwk"].t().reshape(c, 1, 7, 7)
        d = F.conv2d(x32.permute(0, 3, 1, 2), wk, pb["dwb"], padding=3,
                     groups=c).permute(0, 2, 3, 1)
    mu = d.mean(dim=-1, keepdim=True)
    var = (d - mu).square().mean(dim=-1, keepdim=True)
    n = (d - mu) * torch.rsqrt(var + eps) * pb["lns"] + pb["lnb"]
    if pb["dynamic"]:
        # per-row scales over C and 4C
        nq, nsc = quant_rows(n)
        hid = (nq.double() @ pb["w1"].double().t()).float()
        hid = hid * nsc * pb["s1"] + pb["b1"]
        aq, asc = quant_rows(F.gelu(hid, approximate="tanh"))
        y = (aq.double() @ pb["w2"].double().t()).float()
        y = y * asc * pb["s2"] + pb["b2"]
        return x32 + y * pb["g"], (nq, nsc), (aq, asc)
    if pb["int8"]:
        nq = torch.round(torch.clamp(n * pb["i1"], -127.0, 127.0))
        hid = (nq.double() @ pb["w1"].double().t()).float()
        hid = hid * pb["s1"] + pb["b1"]
        a = F.gelu(hid, approximate="tanh")
        aq = torch.round(torch.clamp(a * pb["i2"], -127.0, 127.0))
        y = (aq.double() @ pb["w2"].double().t()).float()
        y = y * pb["s2"] + pb["b2"]
        return x32 + y * pb["g"], nq, aq
    hid = n.to(torch.bfloat16).float() @ pb["w1"].float().t() + pb["b1"]
    a = F.gelu(hid, approximate="tanh")
    y = a.to(torch.bfloat16).float() @ pb["w2"].float().t() + pb["b2"]
    return x32 + y * pb["g"], None, None


def _case(c, mode, hw=(7, 9), seed=0):
    """Parameters (torch and flax layout), a plane, the static scales (or
    None) and the prepared weights of ``mode``."""
    tp, jp = _params(c, 20 + c)
    x4 = np.random.default_rng(seed + c).normal(size=(2, *hw, c)) \
        .astype(np.float32)
    scales = _amax(x4, tp) if mode == "int8-static" else None
    if mode == "int8-dynamic":
        pb = tfb.prepare_block(
            **{k: torch.from_numpy(v) for k, v in tp.items()}, int8=True)
    else:
        pb = _prepared(tp, scales)
    return tp, jp, x4, scales, pb


def _equal(got, want):
    """Equal tensors, or equal (int8 operand, row scales) pairs."""
    if isinstance(want, tuple):
        return all(_equal(g, w) for g, w in zip(got, want))
    return torch.equal(got.double(), want.double())


@pytest.mark.parametrize("plane", ["f32", "bf16"])
@pytest.mark.parametrize("taps", ["f32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("c", [32, 64])
def test_stage_composition_equals_one_piece(c, mode, taps, plane):
    _, _, x4, _, pb = _case(c, mode)
    x = torch.from_numpy(x4)
    if plane == "bf16":
        x = x.to(torch.bfloat16)
    dw_bf16 = taps == "bf16"
    want, nq, aq = _one_piece(x, pb, dw_bf16=dw_bf16)
    n = tfb.block_prologue_plain(x, pb, dw_bf16=dw_bf16)
    hid = tfb.block_up_plain(n, pb)
    got = tfb.block_down_plain(hid, x, pb)
    assert got.dtype == x.dtype and got.shape == x.shape
    (nq_got, nsc), (hq, asc) = (n, hid) if mode == "int8-dynamic" \
        else ((n, None), (hid, None))
    assert hq.shape == (*x.shape[:-1], 4 * c)
    if mode == "int8-dynamic":
        assert nsc.shape == asc.shape == (*x.shape[:-1], 1)
        assert nsc.dtype == asc.dtype == torch.float32
    assert torch.equal(tfb.fused_block_plain(x, pb, dw_bf16=dw_bf16), got)
    res = tfb.block_residual_plain(x, pb, dw_bf16=dw_bf16)
    if mode != "bf16":
        assert nq_got.dtype == hq.dtype == torch.int8
        assert _equal(n, nq) and _equal(hid, aq)
        assert torch.equal(res, want)
    else:
        assert n.dtype == hid.dtype == torch.bfloat16
        err = (res - want).abs().max().item()
        assert err <= 1e-6 * want.abs().max().item(), err


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("c, hw", [(32, (9, 9)), (64, (9, 9)), (96, (5, 3))],
                         ids=["32", "64", "96-5x3"])
def test_stage_composition_matches_jax(c, hw, mode):
    """At 5x3 (H and W below 7, odd) kernel A's prologue owns whole image
    rows of a plane narrower than its halo."""
    h, w = hw
    _, jp, x4, scales, pb = _case(c, mode, hw=(h, w), seed=3)
    int8 = mode != "bf16"
    x = torch.from_numpy(x4)
    hid = tfb.block_up_plain(tfb.block_prologue_plain(x, pb), pb)
    br_got = (tfb.block_down_plain(hid, x, pb).numpy() - x4) / 0.1
    flat = jfb.fused_block_apply(
        jnp.asarray(x4.reshape(2, h * w, c)), h, w, *jp, int8=int8,
        act_scales=scales, interpret=True)
    padded = jfb.fused_block_apply_padded(
        jnp.asarray(x4), h, w, *jp, int8=int8, act_scales=scales,
        pad_in=True, unpad_out=True, interpret=True)
    for ref in (np.asarray(flat).reshape(2, h, w, c), np.asarray(padded)):
        br_ref = (ref - x4) / 0.1
        err = np.abs(br_got - br_ref).max()
        assert err <= 1e-2 * np.abs(br_ref).max(), err


@pytest.mark.parametrize("mode", MODES)
def test_stage_wrappers_take_the_plain_versions_on_cpu(mode):
    _, _, x4, _, pb = _case(32, mode)
    x = torch.from_numpy(x4)
    n = tfb.block_prologue(x, pb)
    assert _equal(n, tfb.block_prologue_plain(x, pb))
    hid = tfb.block_up(n, pb)
    assert _equal(hid, tfb.block_up_plain(n, pb))
    assert torch.equal(tfb.block_down(hid, x, pb),
                       tfb.block_down_plain(hid, x, pb))


def test_dynamic_scan_gives_the_quantize_pass_its_scales():
    _, _, x4, _, pb = _case(64, "int8-dynamic")
    n = tfb.block_prologue(torch.from_numpy(x4), pb)
    amax = tfb.block_up_scan(n, pb)
    assert amax.shape == (*x4.shape[:-1], 1) and amax.dtype == torch.float32
    assert torch.equal(amax, tfb.block_up_scan_plain(n, pb))
    whole = tfb.block_up(n, pb)
    assert _equal(tfb.block_up(n, pb, amax=amax), whole)
    # the scale of a row is its abs-max over 127, and its largest operand
    # +-127
    aq, asc = whole
    assert torch.equal(asc, amax / torch.full_like(amax, 127.0))
    assert torch.equal(aq.abs().amax(dim=-1).int(),
                       torch.full(aq.shape[:-1], 127, dtype=torch.int32))
    with pytest.raises(ValueError, match="dynamic"):
        tfb.block_up_scan(n, _case(64, "int8-static")[4])


@pytest.mark.parametrize("shape", [(37, 96, 384), (5, 3072, 768)],
                         ids=["gemm1", "gemm2"])
def test_sm90_gemm_s8_plain_is_exact(shape):
    m, k, n = shape
    rng = np.random.default_rng(m)
    a = rng.integers(-127, 128, (m, k), dtype=np.int8)
    b = rng.integers(-127, 128, (n, k), dtype=np.int8)
    a[0], b[0] = 127, 127  # 127^2 K: past f32's exact integers at K = 3072
    got = tfb.sm90_gemm_s8(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    want = a.astype(np.int64) @ b.astype(np.int64).T
    np.testing.assert_array_equal(got.numpy(), want)
