"""Backward of the fused ConvNeXt block MLP: K6 and its plain version.

Port of count_pipnet_tpu/ops/pallas/fused_mlp_bwd.py (``fused_mlp_bwd``)
and, at C = 768 where the JAX package leaves the Pallas kernel,
ops/pallas/fused_mlp.py:_mlp_body_manual_bwd: both compute the same math.
Given the block-body input ``x`` (the depthwise output) and the cotangent
``g`` of ``residual + gamma * MLP(LN(x))``:

    recompute   n = LN(x);  h = n W1^T + b1;  a = gelu_tanh(h)
    backward    da = (g * gamma) W2;  dh = da * gelu'(h);  dn = dh W1
                dx = LayerNorm backward of dn
    params      dW1 = dh^T n;  dW2r = g^T a;  db1 = sum dh;  sg = sum g
                dls = sum dn * xhat;  dlb = sum dn

with bf16 GEMM operands (n, a, dh, g * gamma, g and the weights) and f32
sums, as on the TPU. dW2, db2 and dgamma come from the raw sums outside
the kernel, as in the JAX package (gamma is per channel, so it factors out
of every row sum): dW2 = gamma * dW2r, db2 = gamma * sg,
dgamma = sum_j dW2r[:, j] * W2[:, j] + b2 * sg.

Weights are in the port's (torch) layout: ``w1`` [4C, C], ``w2`` [C, 4C];
the gradients come back in the same layout, in f32, and ``dx`` in
``x.dtype``. :func:`fused_mlp_bwd` launches K6 (ops/cuda/fused_mlp_bwd.cu)
for a CUDA tensor and runs :func:`fused_mlp_bwd_plain` for a CPU tensor.

K6 is five launches (and the ordered sums of their partial rows), and its
plain version the composition of the same five stages on [R, C] rows:
:func:`mlp_bwd_prologue_plain` (LayerNorm statistics, bf16 ``n``,
``g * gamma`` and ``g``, ``sg``), :func:`mlp_bwd_dual_plain` (``h`` and
``da`` from one tile, GELU and its derivative -> bf16 ``a`` and ``dh``,
``db1``), :func:`mlp_bwd_dn_plain` (``dn = dh W1``),
:func:`mlp_bwd_ln_plain` (LayerNorm backward -> ``dx``, ``dls``, ``dlb``)
and :func:`mlp_wgrad_plain` (``A^T B`` over the rows: ``dW1`` and
``dW2r``). :func:`mlp_bwd_prologue`, :func:`mlp_bwd_dual`,
:func:`mlp_bwd_dn`, :func:`mlp_bwd_ln` and :func:`mlp_wgrad` launch one
stage alone, so that a check can hold each against its plain version;
K6's launches are counted by :func:`fused_mlp_bwd` only.
"""

import ctypes

import torch

from . import cuda as _cuda

__all__ = ["fused_mlp_bwd", "fused_mlp_bwd_plain", "gelu_tanh_and_grad",
           "bf16_round", "mlp_bwd_prologue", "mlp_bwd_prologue_plain",
           "mlp_bwd_dual", "mlp_bwd_dual_plain", "mlp_bwd_dn",
           "mlp_bwd_dn_plain", "mlp_bwd_ln", "mlp_bwd_ln_plain",
           "mlp_wgrad", "mlp_wgrad_plain"]

_BF = torch.bfloat16
_F32 = torch.float32

_SQRT_2_OVER_PI = 0.7978845608028654
_KAPPA = 0.044715


def bf16_round(t):
    """``t`` rounded to bf16 and back to f32 (a GEMM operand's value)."""
    return t.to(torch.bfloat16).to(torch.float32)


def gelu_tanh_and_grad(h):
    """tanh-approximate GELU value and derivative (f32)."""
    t = torch.tanh(_SQRT_2_OVER_PI * (h + _KAPPA * h * h * h))
    a = 0.5 * h * (1.0 + t)
    da = 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * _SQRT_2_OVER_PI * (
        1.0 + 3.0 * _KAPPA * h * h)
    return a, da


def _derive(dw2r, sg, w2, b2, gamma):
    """dW2, db2, dgamma from the raw sums (f32)."""
    gam = gamma.detach().float().reshape(-1)
    dw2 = dw2r * gam[:, None]
    db2 = gam * sg
    dgamma = (dw2r * bf16_round(w2.detach().float())).sum(dim=1) \
        + b2.detach().float().reshape(-1) * sg
    return dw2, db2, dgamma


def _vec(t):
    return t.detach().float().reshape(-1)


def mlp_bwd_prologue_plain(x, g, ln_scale, ln_bias, gamma, eps: float = 1e-6):
    """Stage a on [R, C] rows: (mu [R], 1/sigma [R], nb = bf16(LN(x)),
    dyb = bf16(g * gamma), gb = bf16(g), sg = sum of g over the rows)."""
    x32, g32 = x.detach().float(), g.detach().float()
    mu = x32.mean(dim=1, keepdim=True)
    var = (x32 - mu).square().mean(dim=1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (x32 - mu) * inv
    nb = (xhat * _vec(ln_scale) + _vec(ln_bias)).to(_BF)
    return (mu[:, 0], inv[:, 0], nb, (g32 * _vec(gamma)).to(_BF),
            g32.to(_BF), g32.sum(dim=0))


def mlp_bwd_dual_plain(nb, dyb, w1, w2, b1):
    """Stage b: ``h = n W1^T + b1`` and ``da = dy W2`` (bf16 operands, f32
    sums), ``a = gelu(h)``, ``dh = da * gelu'(h)``: (bf16 a, bf16 dh,
    db1 = sum of dh over the rows)."""
    h = nb.float() @ bf16_round(w1.detach().float()).t() + _vec(b1)
    a, dgelu = gelu_tanh_and_grad(h)
    dh = (dyb.float() @ bf16_round(w2.detach().float())) * dgelu
    return a.to(_BF), dh.to(_BF), dh.sum(dim=0)


def mlp_bwd_dn_plain(dhb, w1):
    """Stage c: ``dn = dh W1`` (bf16 operands), f32 [R, C]."""
    return dhb.float() @ bf16_round(w1.detach().float())


def mlp_bwd_ln_plain(dn, x, mu, inv, ln_scale):
    """Stage d, the LayerNorm backward: (dx in x's dtype, dls = sum of
    dn * xhat, dlb = sum of dn over the rows)."""
    mu, inv = mu[:, None], inv[:, None]
    xhat = (x.detach().float() - mu) * inv
    dnh = dn * _vec(ln_scale)
    m1 = dnh.mean(dim=1, keepdim=True)
    m2 = (dnh * xhat).mean(dim=1, keepdim=True)
    dx = (inv * (dnh - m1 - xhat * m2)).to(x.dtype)
    return dx, (dn * xhat).sum(dim=0), dn.sum(dim=0)


def mlp_wgrad_plain(a, b):
    """Stage e: ``a^T b`` over the rows, f32 sums of the bf16 operands
    (``dW1 = dh^T n``, ``dW2r = g^T a``)."""
    return a.float().t() @ b.float()


def fused_mlp_bwd_plain(x, g, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
                        eps: float = 1e-6):
    """Plain PyTorch version of K6 (the math of the JAX package's
    ``_mlp_body_manual_bwd``): its five stages. Returns (dx, dls, dlb,
    dw1, db1, dw2, db2, dgamma). On a GPU it needs
    ``torch.backends.cuda.matmul.allow_tf32`` off (the default) to sum in
    full f32."""
    c = x.shape[-1]
    xf, gf = x.reshape(-1, c), g.reshape(-1, c)
    mu, inv, nb, dyb, gb, sg = mlp_bwd_prologue_plain(xf, gf, ln_scale,
                                                      ln_bias, gamma, eps)
    ab, dhb, db1 = mlp_bwd_dual_plain(nb, dyb, w1, w2, b1)
    dn = mlp_bwd_dn_plain(dhb, w1)
    dx, dls, dlb = mlp_bwd_ln_plain(dn, xf, mu, inv, ln_scale)
    dw1 = mlp_wgrad_plain(dhb, nb)
    dw2, db2, dgamma = _derive(mlp_wgrad_plain(gb, ab), sg, w2, b2, gamma)
    return dx.reshape(x.shape), dls, dlb, dw1, db1, dw2, db2, dgamma


def _f32(t):
    return t.detach().to(_F32).reshape(-1).contiguous()


def _check(t, c, what, dtypes=(_F32, _BF)):
    if t.shape[-1] != c:
        raise ValueError(f"{what}: last dimension {t.shape[-1]} != C={c}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} takes {', '.join(map(str, dtypes))}, not "
                        f"{t.dtype}")


def _rows(t, c, what, dtypes=(_F32, _BF), tma=False):
    """``t`` as a contiguous [R, C] CUDA tensor of one of ``dtypes``; a
    GEMM operand (``tma``) starting on a 16-byte boundary, as the TMA
    needs (the row kernels read element by element)."""
    _check(t, c, what, dtypes)
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    t = t.detach().reshape(-1, c).contiguous()
    if tma and t.data_ptr() % 16:
        raise ValueError(f"{what} must start on a 16-byte boundary "
                         f"(data_ptr {t.data_ptr():#x})")
    return t


def _width(c, what):
    if c % 32 or c > 1024:
        raise ValueError(f"{what} needs C % 32 == 0 and C <= 1024, got "
                         f"C={c}")
    return c


def _weight(w, shape, what):
    """A bf16 GEMM operand for the TMA: contiguous, 16-byte aligned."""
    if tuple(w.shape) != shape:
        raise ValueError(f"{what} is {tuple(w.shape)}, not {shape}")
    return _rows(w.to(_BF), shape[1], what, (_BF,), tma=True)


def _same_rows(r, *ts):
    for t in ts:
        if t.shape[0] != r:
            raise ValueError(f"{t.shape[0]} rows against {r}")


def _same_device(dev, *ts):
    for t in ts:
        if t.device != dev:
            raise ValueError(f"a tensor is on {t.device}, the rows on {dev}")


def _plan(r, c):
    """(the row kernels' grid, the splits over R of dW1 and of dW2r)."""
    grid, s1, s2 = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    _cuda.check(_cuda.library().cpt_fused_mlp_bwd_plan(
        r, c, ctypes.byref(grid), ctypes.byref(s1), ctypes.byref(s2)),
        "fused_mlp_bwd_plan")
    return grid.value, (s1.value, s2.value)


def _tiles(r):
    return (r + 127) // 128  # the dual GEMM's row tiles


def fused_mlp_bwd(x, g, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
                  eps: float = 1e-6):
    """Backward of ``residual + gamma * MLP(LN(x))`` with respect to ``x``
    and the parameters (the residual's cotangent is ``g`` itself).
    ``x`` and ``g``: [..., C], each f32 or bf16. CUDA tensor: K6; CPU
    tensor: the plain version."""
    if x.device.type == "cpu":
        return fused_mlp_bwd_plain(x, g, ln_scale, ln_bias, w1, b1, w2, b2,
                                   gamma, eps)
    c = x.shape[-1]
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} != x {tuple(x.shape)}")
    for t in (x, g):
        if t.dtype not in (_F32, _BF):
            raise TypeError(f"fused_mlp_bwd takes f32 or bf16, not {t.dtype}")
    _width(c, "fused_mlp_bwd")
    if tuple(w1.shape) != (4 * c, c) or tuple(w2.shape) != (c, 4 * c):
        raise ValueError(f"weights {tuple(w1.shape)}, {tuple(w2.shape)} "
                         f"are not [4C, C], [C, 4C] for C={c}")
    xf = _rows(x, c, "fused_mlp_bwd x")
    gf = _rows(g, c, "fused_mlp_bwd g")
    _same_device(x.device, g, ln_scale, ln_bias, w1, b1, w2, b2, gamma)
    r = xf.shape[0]
    dev = x.device
    grid, splits = _plan(r, c)
    w1b = _weight(w1, (4 * c, c), "w1")
    w1tb = w1b.t().contiguous()
    w2tb = w2.detach().t().to(_BF).contiguous()

    def empty(*shape, dtype=_F32):
        return torch.empty(*shape, dtype=dtype, device=dev)

    mu, inv = empty(r), empty(r)
    nb, dyb, gb = (empty(r, c, dtype=_BF) for _ in range(3))
    ab, dhb = empty(r, 4 * c, dtype=_BF), empty(r, 4 * c, dtype=_BF)
    dn = empty(r, c)
    part_a, part_b, part_d = (empty(grid, c), empty(_tiles(r), 4 * c),
                              empty(grid, 2 * c))
    ws = empty(max(splits) * 4 * c * c) if max(splits) > 1 else None
    dx = torch.empty_like(xf)
    dw1, dw2r, vec = empty(4 * c, c), empty(c, 4 * c), empty(7 * c)
    # held in names until the launch: a temporary freed while the
    # arguments are built could hand its memory to the next one
    lns, lnb, b1f, gam = _f32(ln_scale), _f32(ln_bias), _f32(b1), _f32(gamma)
    p = _cuda.ptr
    code = _cuda.library().cpt_fused_mlp_bwd(
        p(xf), p(gf), p(dx), int(xf.dtype == _BF), int(gf.dtype == _BF), r,
        c, p(lns), p(lnb), p(w1b), p(w1tb), p(w2tb),
        p(b1f), p(gam), float(eps), p(mu), p(inv), p(nb),
        p(dyb), p(gb), p(ab), p(dhb), p(dn), p(part_a), p(part_b),
        p(part_d), grid, p(ws), *splits, p(dw1), p(dw2r), p(vec),
        _cuda.stream_ptr(dev))
    _cuda.check(code, "fused_mlp_bwd")
    _cuda.count_launch("fused_mlp_bwd", c)
    db1, sg = vec[:4 * c], vec[4 * c:5 * c]
    dls, dlb = vec[5 * c:6 * c], vec[6 * c:]
    dw2, db2, dgamma = _derive(dw2r, sg, w2, b2, gamma)
    return dx.reshape(x.shape), dls, dlb, dw1, db1, dw2, db2, dgamma


def mlp_bwd_prologue(x, g, ln_scale, ln_bias, gamma, eps: float = 1e-6):
    """K6's stage a alone (CUDA), or :func:`mlp_bwd_prologue_plain`
    (CPU); ``x`` and ``g`` [R, C], each f32 or bf16."""
    if x.device.type == "cpu":
        return mlp_bwd_prologue_plain(x, g, ln_scale, ln_bias, gamma, eps)
    c = _width(x.shape[-1], "mlp_bwd_prologue")
    _check(g, c, "mlp_bwd_prologue g")
    xf = _rows(x, c, "mlp_bwd_prologue x")
    gf = _rows(g, c, "mlp_bwd_prologue g")
    r = xf.shape[0]
    _same_rows(r, gf)
    _same_device(x.device, g, ln_scale, ln_bias, gamma)
    grid, _ = _plan(r, c)
    dev = x.device
    mu, inv = (torch.empty(r, device=dev) for _ in range(2))
    nb, dyb, gb = (torch.empty(r, c, dtype=_BF, device=dev)
                   for _ in range(3))
    part, sg = torch.empty(grid, c, device=dev), torch.empty(c, device=dev)
    lns, lnb, gam = _f32(ln_scale), _f32(ln_bias), _f32(gamma)
    p = _cuda.ptr
    _cuda.check(_cuda.library().cpt_mlp_bwd_prologue(
        p(xf), int(xf.dtype == _BF), p(gf), int(gf.dtype == _BF), r, c,
        p(lns), p(lnb), p(gam), float(eps),
        p(mu), p(inv), p(nb), p(dyb), p(gb), p(part), grid, p(sg),
        _cuda.stream_ptr(dev)), "mlp_bwd_prologue")
    return mu, inv, nb, dyb, gb, sg


def mlp_bwd_dual(nb, dyb, w1, w2, b1):
    """K6's stage b (the dual GEMM and its epilogue) alone (CUDA), or
    :func:`mlp_bwd_dual_plain` (CPU); ``nb``, ``dyb`` bf16 [R, C]."""
    if nb.device.type == "cpu":
        return mlp_bwd_dual_plain(nb, dyb, w1, w2, b1)
    c = _width(nb.shape[-1], "mlp_bwd_dual")
    _check(dyb, c, "mlp_bwd_dual dyb", (_BF,))
    nf = _rows(nb, c, "mlp_bwd_dual nb", (_BF,), tma=True)
    df = _rows(dyb, c, "mlp_bwd_dual dyb", (_BF,), tma=True)
    r = nf.shape[0]
    _same_rows(r, df)
    _same_device(nb.device, dyb, w1, w2, b1)
    dev = nb.device
    w1b = _weight(w1, (4 * c, c), "w1")
    if tuple(w2.shape) != (c, 4 * c):
        raise ValueError(f"w2 is {tuple(w2.shape)}, not {(c, 4 * c)}")
    w2tb = w2.detach().t().to(_BF).contiguous()
    ab, dhb = (torch.empty(r, 4 * c, dtype=_BF, device=dev)
               for _ in range(2))
    part = torch.empty(_tiles(r), 4 * c, device=dev)
    db1, b1f = torch.empty(4 * c, device=dev), _f32(b1)
    p = _cuda.ptr
    _cuda.check(_cuda.library().cpt_mlp_bwd_dual(
        p(nf), p(df), p(w1b), p(w2tb), p(b1f), p(ab), p(dhb), p(part),
        r, c, p(db1), _cuda.stream_ptr(dev)), "mlp_bwd_dual")
    return ab, dhb, db1


def mlp_bwd_dn(dhb, w1):
    """K6's stage c (``dn = dh W1`` on the GEMM core) alone (CUDA), or
    :func:`mlp_bwd_dn_plain` (CPU); ``dhb`` bf16 [R, 4C]."""
    if dhb.device.type == "cpu":
        return mlp_bwd_dn_plain(dhb, w1)
    if w1.dim() != 2:
        raise ValueError(f"w1 is {tuple(w1.shape)}, not [4C, C]")
    c = _width(w1.shape[1], "mlp_bwd_dn")
    hf = _rows(dhb, 4 * c, "mlp_bwd_dn dhb", (_BF,), tma=True)
    _same_device(dhb.device, w1)
    w1tb = _weight(w1, (4 * c, c), "w1").t().contiguous()
    dn = torch.empty(hf.shape[0], c, device=dhb.device)
    _cuda.check(_cuda.library().cpt_mlp_bwd_dn(
        _cuda.ptr(hf), _cuda.ptr(w1tb), _cuda.ptr(dn), hf.shape[0], c,
        _cuda.stream_ptr(dhb.device)), "mlp_bwd_dn")
    return dn


def mlp_bwd_ln(dn, x, mu, inv, ln_scale):
    """K6's stage d (the LayerNorm backward) alone (CUDA), or
    :func:`mlp_bwd_ln_plain` (CPU); ``dn`` f32 and ``x`` [R, C], ``mu``
    and ``inv`` f32 [R]."""
    if dn.device.type == "cpu":
        return mlp_bwd_ln_plain(dn, x, mu, inv, ln_scale)
    c = _width(x.shape[-1], "mlp_bwd_ln")
    _check(x, c, "mlp_bwd_ln x")
    df = _rows(dn, c, "mlp_bwd_ln dn", (_F32,))
    xf = _rows(x, c, "mlp_bwd_ln x")
    r = xf.shape[0]
    _same_rows(r, df)
    for t, what in ((mu, "mu"), (inv, "inv")):
        if tuple(t.shape) != (r,) or t.dtype != _F32:
            raise ValueError(f"mlp_bwd_ln: {what} must be f32 [{r}], not "
                             f"{t.dtype} {tuple(t.shape)}")
    _same_device(x.device, dn, mu, inv, ln_scale)
    grid, _ = _plan(r, c)
    dev = x.device
    dx = torch.empty_like(xf)
    part = torch.empty(grid, 2 * c, device=dev)
    sums = torch.empty(2 * c, device=dev)
    muf, invf, lns = mu.contiguous(), inv.contiguous(), _f32(ln_scale)
    p = _cuda.ptr
    _cuda.check(_cuda.library().cpt_mlp_bwd_ln(
        p(df), p(xf), int(xf.dtype == _BF), p(muf), p(invf), p(lns), p(dx),
        r, c, p(part), grid,
        p(sums), _cuda.stream_ptr(dev)), "mlp_bwd_ln")
    return dx, sums[:c], sums[c:]


def mlp_wgrad(a, b):
    """K6's stage e (the GEMM core with MN-major operands: ``a^T b`` over
    the rows, split over them when the tiles alone do not fill the card)
    alone (CUDA), or :func:`mlp_wgrad_plain` (CPU); ``a`` [R, M], ``b``
    [R, N] bf16, M and N multiples of 8."""
    if a.device.type == "cpu":
        return mlp_wgrad_plain(a, b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0] \
            or a.shape[1] % 8 or b.shape[1] % 8:
        raise ValueError(f"mlp_wgrad takes [R, M], [R, N] with M and N "
                         f"multiples of 8, not {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    _check(b, b.shape[1], "mlp_wgrad b", (_BF,))
    af = _rows(a, a.shape[1], "mlp_wgrad a", (_BF,), tma=True)
    bf = _rows(b, b.shape[1], "mlp_wgrad b", (_BF,), tma=True)
    _same_device(af.device, bf)
    (r, m), n = af.shape, bf.shape[1]
    splits = ctypes.c_int(0)
    lib = _cuda.library()
    _cuda.check(lib.cpt_mlp_wgrad_plan(r, m, n, ctypes.byref(splits)),
                "mlp_wgrad_plan")
    splits = splits.value
    out = torch.empty(m, n, device=a.device)
    ws = torch.empty(splits * m * n, device=a.device) if splits > 1 \
        else None
    p = _cuda.ptr
    _cuda.check(lib.cpt_mlp_wgrad(p(af), p(bf), p(out), p(ws), r, m, n,
                                  splits, _cuda.stream_ptr(a.device)),
                "mlp_wgrad")
    return out
