"""K5 and K6, the block-MLP kernels of ``--fused_blocks``
(count_pipnet_tpu_torch/ops/fused_mlp.py, fused_mlp_bwd.py): their plain
versions against the JAX package's Pallas kernels (interpret mode) and XLA
bodies, and the autograd Function against ``jax.vjp`` of
``fused_ln_mlp_residual_ad``. Inputs from numpy seeds; the port takes
torch-layout weights (w1 [4C, C], w2 [C, 4C]), JAX the transposes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.ops.pallas import fused_mlp as jmlp
from count_pipnet_tpu.ops.pallas.fused_mlp_bwd import fused_mlp_bwd as j_k6
from count_pipnet_tpu_torch.ops import fused_mlp as fm
from count_pipnet_tpu_torch.ops.fused_mlp import (
    fused_ln_mlp_residual, fused_ln_mlp_residual_ad,
    fused_ln_mlp_residual_plain)
from count_pipnet_tpu_torch.ops.fused_mlp_bwd import (bf16_round,
                                                      fused_mlp_bwd,
                                                      fused_mlp_bwd_plain)

NAMES = ("dx", "dls", "dlb", "dw1", "db1", "dw2", "db2", "dgamma")


def _setup(rows, c, seed=3):
    rng = np.random.default_rng(seed)

    def n(*s, sc=1.0):
        return (rng.normal(size=s) * sc).astype(np.float32)

    return dict(x=n(rows, c), res=n(rows, c), g=n(rows, c, sc=0.3),
                ls=1 + n(c, sc=0.1), lb=n(c, sc=0.1), w1=n(c, 4 * c, sc=0.3),
                b1=n(4 * c, sc=0.1), w2=n(4 * c, c, sc=0.3),
                b2=n(c, sc=0.1), gamma=n(c, sc=0.5))


def _params(p):
    """Torch-layout parameter tensors of the port's functions."""
    t = torch.from_numpy
    return dict(ln_scale=t(p["ls"]), ln_bias=t(p["lb"]),
                w1=t(p["w1"].T.copy()), b1=t(p["b1"]),
                w2=t(p["w2"].T.copy()), b2=t(p["b2"]), gamma=t(p["gamma"]))


def _jargs(p):
    return (p["ls"], p["lb"], p["w1"], p["b1"], p["w2"], p["b2"],
            p["gamma"])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.mark.parametrize("rows,c", [(300, 32), (70, 64)])
def test_k5_plain_matches_pallas_interpret(rows, c):
    """Same arithmetic as the Pallas kernel (bf16 operands, f32 sums):
    within 2e-3 of the branch's largest value (sum order, and a bf16 GELU
    output may round the other way). Against the XLA body, which also
    rounds the GEMM results to bf16: 2e-2."""
    p = _setup(rows, c)
    got = fused_ln_mlp_residual_plain(torch.from_numpy(p["x"]),
                                      torch.from_numpy(p["res"]),
                                      **_params(p)).numpy()
    ref = np.asarray(jmlp.fused_ln_mlp_residual(
        p["x"], p["res"], *_jargs(p), row_tile=128, interpret=True))
    assert _rel(got - p["res"], ref - p["res"]) < 2e-3
    body = np.asarray(jmlp._mlp_body(p["x"], *_jargs(p), 1e-6))
    assert _rel(got - p["res"], body) < 2e-2
    # the wrapper takes the plain version for a CPU tensor
    via = fused_ln_mlp_residual(torch.from_numpy(p["x"]),
                                torch.from_numpy(p["res"]), **_params(p))
    np.testing.assert_array_equal(via.numpy(), got)


def _one_pass_plain(x, residual, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
                    eps=1e-6):
    """K5's plain version as one body, before it was split into the three
    stages of the wgmma design: LayerNorm in f32, bf16 GEMM operands with
    f32 sums, the GELU output rounded to bf16, the residual added in f32."""
    c = x.shape[-1]
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    n = (x32 - mu) * torch.rsqrt(var + eps) * ln_scale.float().reshape(c) \
        + ln_bias.float().reshape(c)
    h = bf16_round(n) @ bf16_round(w1.float()).t() + b1.float()
    a = torch.nn.functional.gelu(h, approximate="tanh")
    y = bf16_round(a) @ bf16_round(w2.float()).t() + b2.float()
    return (residual.float() + y * gamma.float().reshape(c)).to(
        residual.dtype)


@pytest.mark.parametrize("c", [32, 96])
@pytest.mark.parametrize("res_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dt", [torch.float32, torch.bfloat16])
def test_k5_stages_compose_to_one_pass_plain(x_dt, res_dt, c):
    """The three stage plain versions (ln_rows_plain, mlp_up_gelu_plain,
    mlp_down_residual_plain) compose to the one-body plain version bit for
    bit: the split rounds where the body did, to bf16 before each GEMM.
    300 rows, not a multiple of the kernels' 128-row tiles."""
    p = _setup(300, c, seed=8)
    x = torch.from_numpy(p["x"]).to(x_dt)
    res = torch.from_numpy(p["res"]).to(res_dt)
    got = fused_ln_mlp_residual_plain(x, res, **_params(p))
    want = _one_pass_plain(x, res, **_params(p))
    assert got.dtype == res_dt and got.shape == res.shape
    assert torch.equal(got, want)
    q = _params(p)
    n = fm.ln_rows_plain(x, q["ln_scale"], q["ln_bias"])
    h = fm.mlp_up_gelu_plain(n, q["w1"], q["b1"])
    assert n.dtype == h.dtype == torch.bfloat16
    assert h.shape == (300, 4 * c)
    assert torch.equal(fm.mlp_down_residual_plain(h, res, q["w2"], q["b2"],
                                                  q["gamma"]), got)


def test_k5_stage_wrappers_take_plain_on_cpu():
    """On a CPU tensor each stage wrapper, and the GEMM core's, is its
    plain version."""
    p = _setup(70, 32, seed=9)
    q = _params(p)
    x = torch.from_numpy(p["x"])
    n = fm.ln_rows(x, q["ln_scale"], q["ln_bias"])
    assert torch.equal(n, fm.ln_rows_plain(x, q["ln_scale"], q["ln_bias"]))
    h = fm.mlp_up_gelu(n, q["w1"], q["b1"])
    assert torch.equal(h, fm.mlp_up_gelu_plain(n, q["w1"], q["b1"]))
    res = torch.from_numpy(p["res"])
    assert torch.equal(
        fm.mlp_down_residual(h, res, q["w2"], q["b2"], q["gamma"]),
        fm.mlp_down_residual_plain(h, res, q["w2"], q["b2"], q["gamma"]))
    d = fm.sm90_gemm(n, q["w1"])
    assert torch.equal(d, n.float() @ bf16_round(q["w1"]).t())


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype, device="meta")


_BAD_K5 = {
    # what is wrong: (x, residual, parameter overrides, error, message)
    "width": (_meta(8, 48), _meta(8, 48), {}, ValueError, "C % 32"),
    "residual shape": (_meta(8, 32), _meta(8, 64), {}, ValueError,
                       "residual"),
    "w1 shape": (_meta(8, 32), _meta(8, 32), {"w1": _meta(32, 32)},
                 ValueError, "weights"),
    "w2 shape": (_meta(8, 32), _meta(8, 32), {"w2": _meta(128, 32)},
                 ValueError, "weights"),
    "x dtype": (_meta(8, 32, dtype=torch.float16), _meta(8, 32), {},
                TypeError, "float16"),
    "residual dtype": (_meta(8, 32), _meta(8, 32, dtype=torch.float64), {},
                       TypeError, "float64"),
    "device": (_meta(8, 32), _meta(8, 32), {}, ValueError,
               "unsupported device"),
}


@pytest.mark.parametrize("case", sorted(_BAD_K5))
def test_k5_wrapper_refuses_before_launch(case, monkeypatch):
    """A bad width, shape, dtype or device raises before the kernels'
    library is built or called (the launches would read out of bounds or
    the wrong type)."""
    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(fm._cuda, "library", no_library)
    x, res, over, err, msg = _BAD_K5[case]
    p = {k: _meta(*v.shape) for k, v in _params(_setup(8, 32)).items()}
    p.update(over)
    with pytest.raises(err, match=msg):
        fused_ln_mlp_residual(x, res, **p)


def test_k5_stage_wrappers_refuse_before_launch(monkeypatch):
    """The stage wrappers check their operands the same way."""
    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(fm._cuda, "library", no_library)
    p = {k: _meta(*v.shape) for k, v in _params(_setup(8, 32)).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        fm.ln_rows(_meta(8, 32), p["ln_scale"], p["ln_bias"])
    with pytest.raises(TypeError, match="float32"):
        fm.mlp_up_gelu(_meta(8, 32), p["w1"], p["b1"])
    with pytest.raises(ValueError, match="last dimension"):
        fm.mlp_down_residual(_meta(8, 100, dtype=torch.bfloat16),
                             _meta(8, 32), p["w2"], p["b2"], p["gamma"])
    with pytest.raises(ValueError, match="multiples of 8"):
        fm.sm90_gemm(_meta(8, 36), _meta(16, 36))
    with pytest.raises(ValueError, match="unsupported devices"):
        fm.sm90_gemm(_meta(8, 32), _meta(16, 32))


def test_k5_plain_bf16_planes():
    """bf16 x and residual: the output is bf16, within one bf16 ulp of the
    Pallas kernel's."""
    p = _setup(96, 32, seed=4)
    xb = jnp.asarray(p["x"], jnp.bfloat16)
    rb = jnp.asarray(p["res"], jnp.bfloat16)
    ref = np.asarray(jmlp.fused_ln_mlp_residual(
        xb, rb, *_jargs(p), row_tile=64, interpret=True), np.float32)
    got = fused_ln_mlp_residual_plain(
        torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16),
        torch.from_numpy(np.asarray(rb, np.float32)).to(torch.bfloat16),
        **_params(p))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=8e-3,
                               atol=8e-3)


@pytest.mark.parametrize("rows,c,tile", [(300, 32, 256), (200, 64, 128)])
def test_k6_plain_matches_pallas_interpret(rows, c, tile):
    """Row counts not a multiple of the row tile (ragged last tile). All
    eight outputs within 2e-3 of each one's largest value."""
    p = _setup(rows, c, seed=5)
    got = fused_mlp_bwd_plain(torch.from_numpy(p["x"]),
                              torch.from_numpy(p["g"]), **_params(p))
    ref = j_k6(p["x"], p["g"], *_jargs(p), row_tile=tile, interpret=True)
    for name, a, b in zip(NAMES, got, ref):
        b = np.asarray(b)
        if name in ("dw1", "dw2"):
            b = b.T
        assert _rel(a.numpy(), b) < 2e-3, name


@pytest.mark.parametrize("c", [96, 768])
def test_k6_plain_matches_manual_bwd(c):
    """The XLA backward the JAX package takes at C = 768."""
    p = _setup(40, c, seed=6)
    got = fused_mlp_bwd_plain(torch.from_numpy(p["x"]),
                              torch.from_numpy(p["g"]), **_params(p))
    ref = jmlp._mlp_body_manual_bwd(p["x"], *_jargs(p), p["g"], 1e-6)
    for name, a, b in zip(NAMES, got, ref):
        b = np.asarray(b)
        if name in ("dw1", "dw2"):
            b = b.T
        assert _rel(a.numpy(), b) < 2e-3, name
    via = fused_mlp_bwd(torch.from_numpy(p["x"]), torch.from_numpy(p["g"]),
                        **_params(p))
    for a, b in zip(via, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_autograd_function_matches_jax_vjp():
    """Gradients of every input against jax.vjp of the JAX package's
    fused_ln_mlp_residual_ad (its CPU route: XLA forward, manual
    backward): within 2e-3 of each gradient's largest value; the
    residual's gradient is the cotangent itself."""
    p = _setup(60, 32, seed=7)
    inputs = {k: v.clone().requires_grad_(True)
              for k, v in _params(p).items()}
    x = torch.from_numpy(p["x"]).requires_grad_(True)
    res = torch.from_numpy(p["res"]).requires_grad_(True)
    out = fused_ln_mlp_residual_ad(x, res, **inputs)
    out.backward(torch.from_numpy(p["g"]))

    def f(x, res, ls, lb, w1, b1, w2, b2, gamma):
        return jmlp.fused_ln_mlp_residual_ad(x, res, ls, lb, w1, b1, w2, b2,
                                             gamma, 1e-6, False)

    out_j, vjp = jax.vjp(f, p["x"], p["res"], *_jargs(p))
    assert _rel(out.detach().numpy() - p["res"],
                np.asarray(out_j) - p["res"]) < 2e-2
    gj = vjp(jnp.asarray(p["g"]))
    np.testing.assert_array_equal(res.grad.numpy(), p["g"])
    got = [x.grad] + [inputs[k].grad for k in
                      ("ln_scale", "ln_bias", "w1", "b1", "w2", "b2",
                       "gamma")]
    want = [gj[0]] + list(gj[2:])
    for name, a, b in zip(("x",) + NAMES[1:], got, want):
        b = np.asarray(b)
        if name in ("dw1", "dw2"):
            b = b.T
        assert _rel(a.numpy(), b) < 2e-3, name


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA card raises."""
    p = _params(_setup(8, 32))
    x = torch.zeros(8, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ln_mlp_residual(x, x, **p)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mlp_bwd(x, x, **p)
