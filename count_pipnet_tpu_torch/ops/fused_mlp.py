"""The ConvNeXt block body after the depthwise conv, for ``--fused_blocks``:
K5, its plain version, and the differentiable wrapper.

    out = residual + gamma * (gelu_tanh(LN(x) W1^T + b1) W2^T + b2)

Port of count_pipnet_tpu/ops/pallas/fused_mlp.py: ``fused_ln_mlp_residual``
(the Pallas kernel, here K5 in ops/cuda/fused_mlp.cu) and
``fused_ln_mlp_residual_ad`` (its custom VJP, here
:class:`FusedLnMlpResidual`). As on the TPU the GEMM operands are bf16
with f32 sums, GELU is the tanh approximation in both passes, and the
backward saves only ``x`` and the parameters: it recomputes the rest in
K6 (ops/fused_mlp_bwd.py). The residual's gradient is the cotangent
itself.

Weights are in the port's (torch) layout: ``w1`` [4C, C] (pw1), ``w2``
[C, 4C] (pw2). ``x`` and ``residual`` are [..., C], each f32 or bf16; the
output has the residual's dtype. A CUDA tensor goes to the kernel, a CPU
tensor to the plain version.
"""

import torch

from . import cuda as _cuda
from .fused_mlp_bwd import bf16_round, fused_mlp_bwd

__all__ = ["fused_ln_mlp_residual", "fused_ln_mlp_residual_plain",
           "mlp_body_plain", "fused_ln_mlp_residual_ad",
           "FusedLnMlpResidual"]


def mlp_body_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
                   eps: float = 1e-6):
    """``gamma * MLP(LN(x))`` in f32 with bf16 GEMM operands (the
    kernel's arithmetic; the JAX package's ``_mlp_body`` also rounds the
    GEMM results to bf16)."""
    c = x.shape[-1]
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    n = (x32 - mu) * torch.rsqrt(var + eps) * ln_scale.float().reshape(c) \
        + ln_bias.float().reshape(c)
    h = bf16_round(n) @ bf16_round(w1.float()).t() + b1.float()
    a = torch.nn.functional.gelu(h, approximate="tanh")
    y = bf16_round(a) @ bf16_round(w2.float()).t() + b2.float()
    return y * gamma.float().reshape(c)


def fused_ln_mlp_residual_plain(x, residual, ln_scale, ln_bias, w1, b1, w2,
                                b2, gamma, eps: float = 1e-6):
    """Plain PyTorch version of K5."""
    return (residual.float() + mlp_body_plain(
        x, ln_scale, ln_bias, w1, b1, w2, b2, gamma, eps)).to(residual.dtype)


def _f32(t):
    return t.detach().to(torch.float32).reshape(-1).contiguous()


def fused_ln_mlp_residual(x, residual, ln_scale, ln_bias, w1, b1, w2, b2,
                          gamma, eps: float = 1e-6):
    """K5 for a CUDA tensor, the plain version for a CPU tensor. No
    autograd: see :func:`fused_ln_mlp_residual_ad`."""
    if x.device.type == "cpu":
        return fused_ln_mlp_residual_plain(x, residual, ln_scale, ln_bias,
                                           w1, b1, w2, b2, gamma, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_mlp_residual: unsupported device "
                         f"{x.device}")
    c = x.shape[-1]
    if residual.shape != x.shape:
        raise ValueError(f"residual {tuple(residual.shape)} != x "
                         f"{tuple(x.shape)}")
    for t in (x, residual):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"fused_ln_mlp_residual takes f32 or bf16, not "
                            f"{t.dtype}")
    if c % 32:
        raise ValueError(f"fused_ln_mlp_residual needs C % 32 == 0, got "
                         f"C={c}")
    if tuple(w1.shape) != (4 * c, c) or tuple(w2.shape) != (c, 4 * c):
        raise ValueError(f"weights {tuple(w1.shape)}, {tuple(w2.shape)} "
                         f"are not [4C, C], [C, 4C] for C={c}")
    for t in (residual, ln_scale, ln_bias, w1, b1, w2, b2, gamma):
        if t.device != x.device:
            raise ValueError(f"a tensor is on {t.device}, x on {x.device}")
    r = x.numel() // c
    bf = torch.bfloat16
    xf = x.detach().reshape(r, c).contiguous()
    rf = residual.detach().reshape(r, c).contiguous()
    out = torch.empty_like(rf)
    w1b = w1.detach().to(bf).contiguous()
    w2b = w2.detach().to(bf).contiguous()
    lns, lnb, b1f, b2f, gam = (_f32(ln_scale), _f32(ln_bias), _f32(b1),
                               _f32(b2), _f32(gamma))
    p = _cuda.ptr
    code = _cuda.library().cpt_fused_mlp(
        p(xf), p(rf), p(out), int(xf.dtype == bf), int(rf.dtype == bf), r,
        c, p(lns), p(lnb), p(w1b), p(b1f), p(w2b), p(b2f), p(gam),
        float(eps), _cuda.stream_ptr(x.device))
    _cuda.check(code, "fused_ln_mlp_residual")
    _cuda.count_launch("fused_ln_mlp_residual", c)
    return out.reshape(residual.shape)


class FusedLnMlpResidual(torch.autograd.Function):
    """K5 forward, K6 backward (the JAX package's ``custom_vjp``). Both
    run with autocast off: the kernels take their operands' dtypes as they
    are and cast inside."""

    @staticmethod
    def forward(ctx, x, residual, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
                eps):
        with torch.autocast(x.device.type, enabled=False):
            out = fused_ln_mlp_residual(x, residual, ln_scale, ln_bias, w1,
                                        b1, w2, b2, gamma, eps)
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2, gamma)
        ctx.eps = eps
        ctx.residual_dtype = residual.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, w1, b1, w2, b2, gamma = ctx.saved_tensors
        with torch.autocast(x.device.type, enabled=False):
            dx, dls, dlb, dw1, db1, dw2, db2, dgamma = fused_mlp_bwd(
                x, g, ln_scale, ln_bias, w1, b1, w2, b2, gamma, ctx.eps)

        def like(t, ref):
            return t.reshape(ref.shape).to(ref.dtype)

        return (dx.to(x.dtype), g.to(ctx.residual_dtype), like(dls, ln_scale),
                like(dlb, ln_bias), like(dw1, w1), like(db1, b1),
                like(dw2, w2), like(db2, b2), like(dgamma, gamma), None)


def fused_ln_mlp_residual_ad(x, residual, ln_scale, ln_bias, w1, b1, w2, b2,
                             gamma, eps: float = 1e-6):
    """Differentiable :func:`fused_ln_mlp_residual`."""
    return FusedLnMlpResidual.apply(x, residual, ln_scale, ln_bias, w1, b1,
                                    w2, b2, gamma, eps)
