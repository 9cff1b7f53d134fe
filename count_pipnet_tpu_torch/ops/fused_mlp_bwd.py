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
``x.dtype``. :func:`fused_mlp_bwd` launches the CUDA kernel
(ops/cuda/fused_mlp_bwd.cu) for a CUDA tensor and runs
:func:`fused_mlp_bwd_plain` for a CPU tensor.
"""

import ctypes

import torch

from . import cuda as _cuda

__all__ = ["fused_mlp_bwd", "fused_mlp_bwd_plain", "gelu_tanh_and_grad",
           "bf16_round"]

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


def fused_mlp_bwd_plain(x, g, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
                        eps: float = 1e-6):
    """Plain PyTorch version of K6 (the math of the JAX package's
    ``_mlp_body_manual_bwd``). Returns (dx, dls, dlb, dw1, db1, dw2, db2,
    dgamma). On a GPU it needs ``torch.backends.cuda.matmul.allow_tf32``
    off (the default) to sum in full f32."""
    c = x.shape[-1]
    x32 = x.detach().reshape(-1, c).float()
    g32 = g.detach().reshape(-1, c).float()
    mu = x32.mean(dim=1, keepdim=True)
    var = (x32 - mu).square().mean(dim=1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (x32 - mu) * inv
    ls = ln_scale.detach().float().reshape(-1)
    nb = bf16_round(xhat * ls + ln_bias.detach().float().reshape(-1))
    w1b = bf16_round(w1.detach().float())
    w2b = bf16_round(w2.detach().float())
    h = nb @ w1b.t() + b1.detach().float().reshape(-1)
    a, dgelu = gelu_tanh_and_grad(h)
    gam = gamma.detach().float().reshape(-1)
    da = bf16_round(g32 * gam) @ w2b
    dh = da * dgelu
    dhb = bf16_round(dh)
    dn = dhb @ w1b
    dw1 = dhb.t() @ nb
    dw2r = bf16_round(g32).t() @ bf16_round(a)
    db1 = dh.sum(dim=0)
    sg = g32.sum(dim=0)
    dw2, db2, dgamma = _derive(dw2r, sg, w2, b2, gamma)
    dnh = dn * ls
    m1 = dnh.mean(dim=1, keepdim=True)
    m2 = (dnh * xhat).mean(dim=1, keepdim=True)
    dx = (inv * (dnh - m1 - xhat * m2)).reshape(x.shape).to(x.dtype)
    return (dx, (dn * xhat).sum(dim=0), dn.sum(dim=0), dw1, db1, dw2, db2,
            dgamma)


def _f32(t):
    return t.detach().to(torch.float32).reshape(-1).contiguous()


def fused_mlp_bwd(x, g, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
                  eps: float = 1e-6):
    """Backward of ``residual + gamma * MLP(LN(x))`` with respect to ``x``
    and the parameters (the residual's cotangent is ``g`` itself).
    ``x`` and ``g``: [..., C], each f32 or bf16. CUDA tensor: K6; CPU
    tensor: the plain version."""
    if x.device.type == "cpu":
        return fused_mlp_bwd_plain(x, g, ln_scale, ln_bias, w1, b1, w2, b2,
                                   gamma, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_bwd: unsupported device {x.device}")
    c = x.shape[-1]
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} != x {tuple(x.shape)}")
    for t in (x, g):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"fused_mlp_bwd takes f32 or bf16, not {t.dtype}")
    if c % 32:
        raise ValueError(f"fused_mlp_bwd needs C % 32 == 0, got C={c}")
    if tuple(w1.shape) != (4 * c, c) or tuple(w2.shape) != (c, 4 * c):
        raise ValueError(f"weights {tuple(w1.shape)}, {tuple(w2.shape)} "
                         f"are not [4C, C], [C, 4C] for C={c}")
    for t in (g, ln_scale, ln_bias, w1, b1, w2, b2, gamma):
        if t.device != x.device:
            raise ValueError(f"a tensor is on {t.device}, x on {x.device}")
    r = x.numel() // c
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    xf = x.detach().reshape(r, c).contiguous()
    gf = g.detach().reshape(r, c).contiguous()
    xb, gb16 = int(xf.dtype == bf), int(gf.dtype == bf)
    lib = _cuda.library()
    grid, splits = ctypes.c_int(0), ctypes.c_int(0)
    _cuda.check(lib.cpt_fused_mlp_bwd_plan(r, c, xb, gb16,
                                           ctypes.byref(grid),
                                           ctypes.byref(splits)),
                "fused_mlp_bwd_plan")
    grid, splits = grid.value, splits.value
    w1d = w1.detach()
    w1b = w1d.to(bf).contiguous()
    w1tb = w1d.t().to(bf).contiguous()
    w2tb = w2.detach().t().to(bf).contiguous()
    lns, lnb, b1f, gam = _f32(ln_scale), _f32(ln_bias), _f32(b1), _f32(gamma)
    nb = torch.empty(r, c, dtype=bf, device=dev)
    gb = torch.empty(r, c, dtype=bf, device=dev)
    ab = torch.empty(r, 4 * c, dtype=bf, device=dev)
    dhb = torch.empty(r, 4 * c, dtype=bf, device=dev)
    part = torch.zeros(grid, 7 * c, dtype=f32, device=dev)
    ws = (torch.empty(splits * 4 * c * c, dtype=f32, device=dev)
          if splits > 1 else None)
    dx = torch.empty_like(xf)
    dw1 = torch.empty(4 * c, c, dtype=f32, device=dev)
    dw2r = torch.empty(c, 4 * c, dtype=f32, device=dev)
    vec = torch.empty(7 * c, dtype=f32, device=dev)
    p = _cuda.ptr
    code = lib.cpt_fused_mlp_bwd(
        p(xf), p(gf), p(dx), xb, gb16, r, c, p(lns), p(lnb), p(w1b),
        p(w1tb), p(w2tb), p(b1f), p(gam), float(eps), p(nb), p(gb), p(ab),
        p(dhb), p(part), grid, p(ws), splits, p(dw1), p(dw2r), p(vec),
        _cuda.stream_ptr(dev))
    _cuda.check(code, "fused_mlp_bwd")
    _cuda.count_launch("fused_mlp_bwd", c)
    db1, sg = vec[:4 * c], vec[4 * c:5 * c]
    dls, dlb = vec[5 * c:6 * c], vec[6 * c:]
    dw2, db2, dgamma = _derive(dw2r, sg, w2, b2, gamma)
    return dx.reshape(x.shape), dls, dlb, dw1, db1, dw2, db2, dgamma
