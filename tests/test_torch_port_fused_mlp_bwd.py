"""K6's five stages (count_pipnet_tpu_torch/ops/fused_mlp_bwd.py): their
plain versions compose to K6's plain version bit for bit and match the JAX
package's Pallas kernel (interpret mode) and XLA backward; each stage
wrapper takes its plain version on the CPU and refuses a bad operand before
the kernels' library is reached. Inputs from numpy seeds; the port takes
torch-layout weights (w1 [4C, C], w2 [C, 4C]), JAX the transposes."""

import numpy as np
import pytest
import torch

from count_pipnet_tpu.ops.pallas import fused_mlp as jmlp
from count_pipnet_tpu.ops.pallas.fused_mlp_bwd import fused_mlp_bwd as j_k6
from count_pipnet_tpu_torch.ops import fused_mlp_bwd as fb
from count_pipnet_tpu_torch.ops.fused_mlp_bwd import (
    _derive, bf16_round, fused_mlp_bwd, fused_mlp_bwd_plain,
    gelu_tanh_and_grad)

NAMES = ("dx", "dls", "dlb", "dw1", "db1", "dw2", "db2", "dgamma")


def _setup(rows, c, seed):
    rng = np.random.default_rng(seed)

    def n(*s, sc=1.0):
        return (rng.normal(size=s) * sc).astype(np.float32)

    return dict(x=n(rows, c), g=n(rows, c, sc=0.3), ls=1 + n(c, sc=0.1),
                lb=n(c, sc=0.1), w1=n(c, 4 * c, sc=0.3), b1=n(4 * c, sc=0.1),
                w2=n(4 * c, c, sc=0.3), b2=n(c, sc=0.1), gamma=n(c, sc=0.5))


def _params(p):
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


def _one_pass_plain(x, g, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
                    eps=1e-6):
    """K6's plain version as one body, before it was split into the five
    stages of the wgmma design."""
    c = x.shape[-1]
    x32 = x.reshape(-1, c).float()
    g32 = g.reshape(-1, c).float()
    mu = x32.mean(dim=1, keepdim=True)
    var = (x32 - mu).square().mean(dim=1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (x32 - mu) * inv
    ls = ln_scale.float().reshape(-1)
    nb = bf16_round(xhat * ls + ln_bias.float().reshape(-1))
    w1b, w2b = bf16_round(w1.float()), bf16_round(w2.float())
    h = nb @ w1b.t() + b1.float().reshape(-1)
    a, dgelu = gelu_tanh_and_grad(h)
    da = bf16_round(g32 * gamma.float().reshape(-1)) @ w2b
    dh = da * dgelu
    dhb = bf16_round(dh)
    dn = dhb @ w1b
    dw1 = dhb.t() @ nb
    dw2r = bf16_round(g32).t() @ bf16_round(a)
    sg = g32.sum(dim=0)
    dw2, db2, dgamma = _derive(dw2r, sg, w2, b2, gamma)
    dnh = dn * ls
    m1 = dnh.mean(dim=1, keepdim=True)
    m2 = (dnh * xhat).mean(dim=1, keepdim=True)
    dx = (inv * (dnh - m1 - xhat * m2)).reshape(x.shape).to(x.dtype)
    return (dx, (dn * xhat).sum(dim=0), dn.sum(dim=0), dw1, dh.sum(dim=0),
            dw2, db2, dgamma)


def _stages(x, g, q, eps=1e-6):
    """K6's five stages called one by one on [R, C] rows."""
    mu, inv, nb, dyb, gb, sg = fb.mlp_bwd_prologue(
        x, g, q["ln_scale"], q["ln_bias"], q["gamma"], eps)
    ab, dhb, db1 = fb.mlp_bwd_dual(nb, dyb, q["w1"], q["w2"], q["b1"])
    dn = fb.mlp_bwd_dn(dhb, q["w1"])
    dx, dls, dlb = fb.mlp_bwd_ln(dn, x, mu, inv, q["ln_scale"])
    dw1 = fb.mlp_wgrad(dhb, nb)
    dw2, db2, dgamma = _derive(fb.mlp_wgrad(gb, ab), sg, q["w2"], q["b2"],
                               q["gamma"])
    return dx, dls, dlb, dw1, db1, dw2, db2, dgamma


@pytest.fixture
def one_thread():
    """PyTorch's CPU operations on one thread for the test. Outside its
    conditional-reproducibility mode (MKL_CBWR, fixed before MKL loads)
    MKL does not promise the same bits from two calls of a multithreaded
    GEMM on the same operands: its threads' share of the work may change
    from call to call."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("c", [32, 96])
@pytest.mark.parametrize("g_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dt", [torch.float32, torch.bfloat16])
def test_k6_stages_compose_to_one_pass_plain(x_dt, g_dt, c, one_thread):
    """The five stage plain versions compose to the one-body plain version
    bit for bit (the split rounds where the body did), through
    fused_mlp_bwd_plain and called one by one. 300 rows, not a multiple of
    the kernels' 128-row tiles; [..., C] inputs of three dimensions, in
    PyTorch's own 64-byte aligned memory (numpy's heap alignment varies
    with what ran before in the process), on one thread."""
    p = _setup(300, c, seed=11)
    x = torch.from_numpy(p["x"]).to(x_dt).reshape(3, 100, c).clone()
    g = torch.from_numpy(p["g"]).to(g_dt).reshape(3, 100, c).clone()
    q = {k: v.clone() for k, v in _params(p).items()}
    want = _one_pass_plain(x, g, **q)
    got = fused_mlp_bwd_plain(x, g, **q)
    stages = _stages(x.reshape(-1, c), g.reshape(-1, c), q)
    assert got[0].dtype == x_dt and got[0].shape == x.shape
    for name, a, b, s in zip(NAMES, got, want, stages):
        assert torch.equal(a, b), name
        assert torch.equal(s.reshape(b.shape), b), name


def test_k6_stage_outputs():
    """Each stage's outputs: their dtypes and shapes, the bf16 operands
    rounded from the f32 values they stand for."""
    p = _setup(70, 64, seed=12)
    q = _params(p)
    x, g = torch.from_numpy(p["x"]), torch.from_numpy(p["g"])
    mu, inv, nb, dyb, gb, sg = fb.mlp_bwd_prologue_plain(
        x, g, q["ln_scale"], q["ln_bias"], q["gamma"])
    assert mu.shape == inv.shape == (70,)
    assert nb.dtype == dyb.dtype == gb.dtype == torch.bfloat16
    assert torch.equal(gb, g.to(torch.bfloat16))
    assert torch.equal(dyb, (g * q["gamma"]).to(torch.bfloat16))
    torch.testing.assert_close(sg, g.sum(0))
    torch.testing.assert_close(mu, x.mean(1))
    ab, dhb, db1 = fb.mlp_bwd_dual_plain(nb, dyb, q["w1"], q["w2"], q["b1"])
    assert ab.shape == dhb.shape == (70, 256) and db1.shape == (256,)
    assert ab.dtype == dhb.dtype == torch.bfloat16
    dn = fb.mlp_bwd_dn_plain(dhb, q["w1"])
    assert dn.shape == (70, 64) and dn.dtype == torch.float32
    dx, dls, dlb = fb.mlp_bwd_ln_plain(dn, x, mu, inv, q["ln_scale"])
    assert dx.dtype == torch.float32 and dls.shape == dlb.shape == (64,)
    torch.testing.assert_close(dlb, dn.sum(0))
    torch.testing.assert_close(fb.mlp_wgrad_plain(dhb, nb),
                               dhb.float().t() @ nb.float())


@pytest.mark.parametrize("ref", ["pallas", "manual"])
def test_k6_composed_stages_match_jax(ref):
    """The five stages, called one by one, against the JAX package's
    fused_mlp_bwd (Pallas, interpret mode, 300 rows at C = 32 with a
    ragged last row tile of 128) and _mlp_body_manual_bwd (the XLA backward
    it takes at C = 768; here 40 rows at C = 96): all eight outputs within
    2e-3 of each one's largest value (bf16 operands and f32 sums in
    another order)."""
    rows, c = (300, 32) if ref == "pallas" else (40, 96)
    p = _setup(rows, c, seed=13)
    got = _stages(torch.from_numpy(p["x"]), torch.from_numpy(p["g"]),
                  _params(p))
    if ref == "pallas":
        want = j_k6(p["x"], p["g"], *_jargs(p), row_tile=128,
                    interpret=True)
    else:
        want = jmlp._mlp_body_manual_bwd(p["x"], *_jargs(p), p["g"], 1e-6)
    for name, a, b in zip(NAMES, got, want):
        b = np.asarray(b)
        if name in ("dw1", "dw2"):
            b = b.T
        assert _rel(a.numpy(), b) < 2e-3, name


def test_k6_stage_wrappers_take_plain_on_cpu():
    """On a CPU tensor each stage wrapper is its plain version."""
    p = _setup(50, 32, seed=14)
    q = _params(p)
    x = torch.from_numpy(p["x"]).to(torch.bfloat16)
    g = torch.from_numpy(p["g"])
    args = (x, g, q["ln_scale"], q["ln_bias"], q["gamma"])
    pro = fb.mlp_bwd_prologue(*args)
    for a, b in zip(pro, fb.mlp_bwd_prologue_plain(*args)):
        assert torch.equal(a, b)
    mu, inv, nb, dyb, gb, _ = pro
    dual = fb.mlp_bwd_dual(nb, dyb, q["w1"], q["w2"], q["b1"])
    for a, b in zip(dual, fb.mlp_bwd_dual_plain(nb, dyb, q["w1"], q["w2"],
                                                q["b1"])):
        assert torch.equal(a, b)
    dn = fb.mlp_bwd_dn(dual[1], q["w1"])
    assert torch.equal(dn, fb.mlp_bwd_dn_plain(dual[1], q["w1"]))
    for a, b in zip(fb.mlp_bwd_ln(dn, x, mu, inv, q["ln_scale"]),
                    fb.mlp_bwd_ln_plain(dn, x, mu, inv, q["ln_scale"])):
        assert torch.equal(a, b)
    assert torch.equal(fb.mlp_wgrad(gb, dual[0]),
                       fb.mlp_wgrad_plain(gb, dual[0]))


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype, device="meta")


_BF = torch.bfloat16
_P = {k: _meta(*v.shape) for k, v in _params(_setup(8, 32, 0)).items()}
_MU = _meta(8)
_BAD = {
    # what is wrong: (stage, arguments, error, message)
    "prologue device": (
        "mlp_bwd_prologue", (_meta(8, 32), _meta(8, 32), _P["ln_scale"],
                             _P["ln_bias"], _P["gamma"]),
        ValueError, "unsupported device"),
    "prologue width": (
        "mlp_bwd_prologue", (_meta(8, 48), _meta(8, 48), _P["ln_scale"],
                             _P["ln_bias"], _P["gamma"]),
        ValueError, "C % 32"),
    "prologue too wide": (
        "mlp_bwd_prologue", (_meta(8, 1056), _meta(8, 1056),
                             _P["ln_scale"], _P["ln_bias"], _P["gamma"]),
        ValueError, "C <= 1024"),
    "prologue g dtype": (
        "mlp_bwd_prologue", (_meta(8, 32), _meta(8, 32, dtype=torch.float16),
                             _P["ln_scale"], _P["ln_bias"], _P["gamma"]),
        TypeError, "float16"),
    "dual dtype": (
        "mlp_bwd_dual", (_meta(8, 32), _meta(8, 32, dtype=_BF), _P["w1"],
                         _P["w2"], _P["b1"]),
        TypeError, "float32"),
    "dual device": (
        "mlp_bwd_dual", (_meta(8, 32, dtype=_BF), _meta(8, 32, dtype=_BF),
                         _P["w1"], _P["w2"], _P["b1"]),
        ValueError, "unsupported device"),
    "dn width": (
        "mlp_bwd_dn", (_meta(8, 100, dtype=_BF), _P["w1"]),
        ValueError, "last dimension"),
    "dn weight": (
        "mlp_bwd_dn", (_meta(8, 128, dtype=_BF), _meta(128)),
        ValueError, "w1"),
    "ln dn dtype": (
        "mlp_bwd_ln", (_meta(8, 32, dtype=_BF), _meta(8, 32), _MU, _MU,
                       _P["ln_scale"]),
        TypeError, "bfloat16"),
    "ln device": (
        "mlp_bwd_ln", (_meta(8, 32), _meta(8, 32), _MU, _MU,
                       _P["ln_scale"]),
        ValueError, "unsupported device"),
    "wgrad columns": (
        "mlp_wgrad", (_meta(8, 36, dtype=_BF), _meta(8, 32, dtype=_BF)),
        ValueError, "multiples of 8"),
    "wgrad rows": (
        "mlp_wgrad", (_meta(8, 32, dtype=_BF), _meta(9, 32, dtype=_BF)),
        ValueError, "multiples of 8"),
    "wgrad dtype": (
        "mlp_wgrad", (_meta(8, 32), _meta(8, 32, dtype=_BF)),
        TypeError, "float32"),
    "wgrad device": (
        "mlp_wgrad", (_meta(8, 32, dtype=_BF), _meta(8, 32, dtype=_BF)),
        ValueError, "unsupported device"),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_k6_stage_wrappers_refuse_before_launch(case, monkeypatch):
    """A bad width, shape, dtype or device raises before the kernels'
    library is built or called (the launches would read out of bounds or
    the wrong type)."""
    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(fb._cuda, "library", no_library)
    stage, args, err, msg = _BAD[case]
    with pytest.raises(err, match=msg):
        getattr(fb, stage)(*args)


_BAD_K6 = {
    # what is wrong: (x, g, parameter overrides, error, message)
    "width": (_meta(8, 48), _meta(8, 48), {}, ValueError, "C % 32"),
    "too wide": (_meta(8, 1056), _meta(8, 1056), {}, ValueError,
                 "C <= 1024"),
    "g shape": (_meta(8, 32), _meta(4, 32), {}, ValueError, "g "),
    "g dtype": (_meta(8, 32), _meta(8, 32, dtype=torch.float64), {},
                TypeError, "float64"),
    "w2 shape": (_meta(8, 32), _meta(8, 32), {"w2": _meta(128, 32)},
                 ValueError, "weights"),
}


@pytest.mark.parametrize("case", sorted(_BAD_K6))
def test_k6_wrapper_refuses_before_launch(case, monkeypatch):
    """K6's wrapper checks its operands the same way."""
    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(fb._cuda, "library", no_library)
    x, g, over, err, msg = _BAD_K6[case]
    p = dict(_P)
    p.update(over)
    with pytest.raises(err, match=msg):
        fused_mlp_bwd(x, g, **p)
