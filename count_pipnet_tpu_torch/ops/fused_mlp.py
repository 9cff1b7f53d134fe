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

K5 is three launches, and its plain version the composition of the same
three stages: :func:`ln_rows_plain` (LayerNorm -> bf16 ``n``),
:func:`mlp_up_gelu_plain` (``n W1^T + b1``, tanh-GELU -> bf16 hidden) and
:func:`mlp_down_residual_plain` (``hidden W2^T + b2``, layer scale,
residual). :func:`ln_rows`, :func:`mlp_up_gelu`, :func:`mlp_down_residual`
and :func:`sm90_gemm` (the wgmma GEMM core both GEMMs run on) launch one
stage alone, so that a check can hold each against its plain version;
K5's launches are counted by :func:`fused_ln_mlp_residual` only.

Weights are in the port's (torch) layout: ``w1`` [4C, C] (pw1), ``w2``
[C, 4C] (pw2). ``x`` and ``residual`` are [..., C], each f32 or bf16; the
output has the residual's dtype. A CUDA tensor goes to the kernels, a CPU
tensor to the plain version.
"""

import torch

from . import cuda as _cuda
from .fused_mlp_bwd import _check, _f32, bf16_round, fused_mlp_bwd

__all__ = ["fused_ln_mlp_residual", "fused_ln_mlp_residual_plain",
           "ln_rows", "ln_rows_plain", "mlp_up_gelu", "mlp_up_gelu_plain",
           "mlp_down_residual", "mlp_down_residual_plain", "sm90_gemm",
           "fused_ln_mlp_residual_ad", "FusedLnMlpResidual"]

_BF = torch.bfloat16


def ln_rows_plain(x, ln_scale, ln_bias, eps: float = 1e-6):
    """Stage a: LayerNorm of each row in f32, rounded to bf16 (GEMM 1's
    operand)."""
    c = x.shape[-1]
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    n = (x32 - mu) * torch.rsqrt(var + eps) * ln_scale.float().reshape(c) \
        + ln_bias.float().reshape(c)
    return n.to(_BF)


def mlp_up_gelu_plain(n, w1, b1):
    """Stage b: ``gelu_tanh(n W1^T + b1)`` with bf16 operands and f32 sums,
    rounded to bf16 (GEMM 2's operand)."""
    h = n.float() @ bf16_round(w1.float()).t() + b1.float()
    return torch.nn.functional.gelu(h, approximate="tanh").to(_BF)


def mlp_down_residual_plain(h, residual, w2, b2, gamma):
    """Stage c: ``residual + gamma * (h W2^T + b2)`` in f32, in the
    residual's dtype."""
    c = residual.shape[-1]
    y = h.float() @ bf16_round(w2.float()).t() + b2.float()
    return (residual.float() + y * gamma.float().reshape(c)).to(
        residual.dtype)


def fused_ln_mlp_residual_plain(x, residual, ln_scale, ln_bias, w1, b1, w2,
                                b2, gamma, eps: float = 1e-6):
    """Plain PyTorch version of K5: its three stages."""
    n = ln_rows_plain(x, ln_scale, ln_bias, eps)
    return mlp_down_residual_plain(mlp_up_gelu_plain(n, w1, b1), residual,
                                   w2, b2, gamma)


def _rows(t, c, what, dtypes=(torch.float32, _BF)):
    """``t`` as a contiguous [R, C] CUDA tensor of one of ``dtypes``."""
    _check(t, c, what, dtypes)
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.detach().reshape(-1, c).contiguous()


def _aligned(t, what):
    """``t`` if it starts on a 16-byte boundary (the TMA's operands, and
    the 16-byte loads of the residual in GEMM 2's epilogue)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must start on a 16-byte boundary "
                         f"(data_ptr {t.data_ptr():#x})")
    return t


def _weight(w, shape, what):
    """A bf16 GEMM operand for the TMA: contiguous, 16-byte aligned."""
    if tuple(w.shape) != shape:
        raise ValueError(f"{what} is {tuple(w.shape)}, not {shape}")
    return _aligned(w.detach().to(_BF).contiguous(), what)


def _width(c):
    if c % 32:
        raise ValueError(f"fused_ln_mlp_residual needs C % 32 == 0, got "
                         f"C={c}")
    return c


def fused_ln_mlp_residual(x, residual, ln_scale, ln_bias, w1, b1, w2, b2,
                          gamma, eps: float = 1e-6):
    """K5 for a CUDA tensor, the plain version for a CPU tensor. No
    autograd: see :func:`fused_ln_mlp_residual_ad`."""
    if x.device.type == "cpu":
        return fused_ln_mlp_residual_plain(x, residual, ln_scale, ln_bias,
                                           w1, b1, w2, b2, gamma, eps)
    c = _width(x.shape[-1])
    if residual.shape != x.shape:
        raise ValueError(f"residual {tuple(residual.shape)} != x "
                         f"{tuple(x.shape)}")
    for w, shape in ((w1, (4 * c, c)), (w2, (c, 4 * c))):
        if tuple(w.shape) != shape:
            raise ValueError(f"weights {tuple(w1.shape)}, {tuple(w2.shape)} "
                             f"are not [4C, C], [C, 4C] for C={c}")
    _check(residual, c, "fused_ln_mlp_residual")
    xf = _rows(x, c, "fused_ln_mlp_residual")
    rf = _aligned(_rows(residual, c, "fused_ln_mlp_residual"), "residual")
    for t in (residual, ln_scale, ln_bias, w1, b1, w2, b2, gamma):
        if t.device != x.device:
            raise ValueError(f"a tensor is on {t.device}, x on {x.device}")
    w1b = _weight(w1, (4 * c, c), "w1")
    w2b = _weight(w2, (c, 4 * c), "w2")
    r = xf.shape[0]
    out = torch.empty_like(rf)
    n = torch.empty(r, c, dtype=_BF, device=x.device)
    h = torch.empty(r, 4 * c, dtype=_BF, device=x.device)
    # f32 copies held in names until the launch returns: an inline
    # temporary may be freed, and its memory taken, before the kernel runs
    lns, lnb, b1f, b2f, gf = map(_f32, (ln_scale, ln_bias, b1, b2, gamma))
    p = _cuda.ptr
    code = _cuda.library().cpt_fused_mlp(
        p(xf), p(rf), p(out), int(xf.dtype == _BF), int(rf.dtype == _BF), r,
        c, p(lns), p(lnb), p(w1b), p(b1f), p(w2b), p(b2f), p(gf), float(eps),
        p(n), p(h), _cuda.stream_ptr(x.device))
    _cuda.check(code, "fused_ln_mlp_residual")
    _cuda.count_launch("fused_ln_mlp_residual", c)
    return out.reshape(residual.shape)


def ln_rows(x, ln_scale, ln_bias, eps: float = 1e-6):
    """K5's stage a alone (CUDA), or :func:`ln_rows_plain` (CPU)."""
    if x.device.type == "cpu":
        return ln_rows_plain(x, ln_scale, ln_bias, eps)
    c = _width(x.shape[-1])
    xf = _rows(x, c, "ln_rows")
    n = torch.empty(xf.shape, dtype=_BF, device=x.device)
    lns, lnb = _f32(ln_scale), _f32(ln_bias)
    code = _cuda.library().cpt_mlp_ln_rows(
        _cuda.ptr(xf), int(xf.dtype == _BF), _cuda.ptr(n), xf.shape[0], c,
        _cuda.ptr(lns), _cuda.ptr(lnb), float(eps),
        _cuda.stream_ptr(x.device))
    _cuda.check(code, "ln_rows")
    return n.reshape(x.shape)


def mlp_up_gelu(n, w1, b1):
    """K5's stage b (GEMM 1 and its epilogue) alone (CUDA), or
    :func:`mlp_up_gelu_plain` (CPU)."""
    if n.device.type == "cpu":
        return mlp_up_gelu_plain(n, w1, b1)
    c = _width(n.shape[-1])
    nf = _rows(n, c, "mlp_up_gelu", (_BF,))
    h = torch.empty(nf.shape[0], 4 * c, dtype=_BF, device=n.device)
    w1b, b1f = _weight(w1, (4 * c, c), "w1"), _f32(b1)
    code = _cuda.library().cpt_mlp_up_gelu(
        _cuda.ptr(nf), _cuda.ptr(w1b), _cuda.ptr(b1f), _cuda.ptr(h),
        nf.shape[0], c, _cuda.stream_ptr(n.device))
    _cuda.check(code, "mlp_up_gelu")
    return h.reshape(*n.shape[:-1], 4 * c)


def mlp_down_residual(h, residual, w2, b2, gamma):
    """K5's stage c (GEMM 2 and its epilogue) alone (CUDA), or
    :func:`mlp_down_residual_plain` (CPU)."""
    if h.device.type == "cpu":
        return mlp_down_residual_plain(h, residual, w2, b2, gamma)
    c = _width(residual.shape[-1])
    hf = _rows(h, 4 * c, "mlp_down_residual", (_BF,))
    rf = _aligned(_rows(residual, c, "mlp_down_residual"), "residual")
    if hf.shape[0] != rf.shape[0]:
        raise ValueError(f"{hf.shape[0]} hidden rows, {rf.shape[0]} "
                         f"residual rows")
    out = torch.empty_like(rf)
    w2b, b2f, gf = _weight(w2, (c, 4 * c), "w2"), _f32(b2), _f32(gamma)
    code = _cuda.library().cpt_mlp_down_residual(
        _cuda.ptr(hf), _cuda.ptr(w2b), _cuda.ptr(b2f), _cuda.ptr(gf),
        _cuda.ptr(rf), int(rf.dtype == _BF), _cuda.ptr(out), rf.shape[0], c,
        _cuda.stream_ptr(h.device))
    _cuda.check(code, "mlp_down_residual")
    return out.reshape(residual.shape)


def sm90_gemm(a, b):
    """The GEMM core alone: ``a [M, K] . b [N, K]^T`` with bf16 operands,
    f32 out, with the tiles K5 takes for GEMM 1 (N = 4K) or else for GEMM
    2 (CUDA); on the CPU the same product in f32 of the bf16 operands."""
    if a.device.type == "cpu":
        return a.to(_BF).float() @ b.to(_BF).float().t()
    k = a.shape[-1]
    if a.dim() != 2 or b.dim() != 2 or b.shape[1] != k or k % 8 \
            or b.shape[0] % 8:
        raise ValueError(f"sm90_gemm takes [M, K], [N, K] with K and N "
                         f"multiples of 8, not {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"sm90_gemm: unsupported devices {a.device}, "
                         f"{b.device}")
    ab = _weight(a, tuple(a.shape), "a")
    bb = _weight(b, tuple(b.shape), "b")
    d = torch.empty(a.shape[0], b.shape[0], device=a.device)
    code = _cuda.library().cpt_sm90_gemm(
        _cuda.ptr(ab), _cuda.ptr(bb), _cuda.ptr(d), a.shape[0], b.shape[0],
        k, _cuda.stream_ptr(a.device))
    _cuda.check(code, "sm90_gemm")
    return d


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
