"""A GEMM with dynamic per-row int8 activations: K10 and its plain version.

    y[M, N] = dequant(quant_rows(x[M, K]) @ wq[K, N]) * wscale + bias

Port of count_pipnet_tpu/ops/pallas/int8_gemm.py. Weights are quantized
once, symmetric per output column (:func:`quantize_gemm_weights`, the JAX
package's function), and prepared in the layout the kernel reads
(:func:`prepare_gemm`: ``[N, K]`` int8). The activations are quantized per
row as the TPU kernel does it (:func:`quant_rows`): ``scale = max(amax,
1e-9) / 127`` and ``round(x / scale)``, half to even, no clip; then int32
sums and ``acc * scale * wscale + bias`` in f32, cast to ``out_dtype``.
``models/quantized.py:int8_rowwise_matmul`` uses another rule (``where(amax
> 0, amax / 127, 1)`` and a clip), as in the JAX package.

:func:`int8_quant_gemm` launches K10 (ops/cuda/int8_gemm.cu) for a CUDA
tensor and runs :func:`int8_quant_gemm_plain` for a CPU tensor. K10 is two
launches, each with a wrapper and a plain version of its own: the row
quantize pass (:func:`quant_rows_int8`) and the s8 GEMM with the row-scale
epilogue (:func:`int8_rowscale_gemm`).
"""

import torch

from . import cuda as _cuda

__all__ = ["quantize_gemm_weights", "prepare_gemm", "quant_rows",
           "int8_quant_gemm", "int8_quant_gemm_plain", "quant_rows_int8",
           "quant_rows_int8_plain", "int8_rowscale_gemm",
           "int8_rowscale_gemm_plain"]


def quantize_gemm_weights(w):
    """[K, N] float -> (int8 [K, N], f32 scale [1, N]) symmetric
    per-column."""
    w = torch.as_tensor(w, dtype=torch.float32)
    amax = w.abs().amax(dim=0, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def prepare_gemm(w, bias=None):
    """Kernel-ready weights of ``x @ w + bias`` (``w`` [K, N] float,
    ``bias`` [N] or None): ``{"wq": int8 [N, K], "ws": f32 [N], "b": f32
    [N]}``, contiguous, on ``w``'s device."""
    w = torch.as_tensor(w).detach()
    q, scale = quantize_gemm_weights(w)
    n = q.shape[1]
    b = (torch.zeros(n, dtype=torch.float32, device=w.device) if bias is None
         else torch.as_tensor(bias).detach().to(torch.float32).reshape(n))
    return {"wq": q.t().contiguous(), "ws": scale.reshape(n).contiguous(),
            "b": b.contiguous()}


def quant_rows(x, amax=None):
    """Dynamic per-row int8 quantization over the last axis, the TPU
    kernels' rule: (integer-valued f32 ``round(x / scale)``, f32 scale
    [..., 1]) with ``scale = max(amax, 1e-9) / 127``; ``amax`` [..., 1]:
    the rows' abs-max where it is already known (else taken from ``x``)."""
    x = x.to(torch.float32)
    if amax is None:
        amax = x.abs().amax(dim=-1, keepdim=True)
    # tensor / tensor: a division by a Python scalar may run as a multiply
    # by its reciprocal (on a CUDA tensor), an ulp off the IEEE quotient
    scale = torch.clamp_min(amax, 1e-9) / torch.full_like(amax, 127.0)
    return torch.round(x / scale), scale


def int8_quant_gemm_plain(x, prepared, out_dtype=None):
    """Plain version of K10: [M, K] -> [M, N] in ``out_dtype`` (default
    ``x.dtype``). The int8 product runs in float64, which holds its integer
    sums exactly."""
    xq, scale = quant_rows(x)
    acc = (xq.double() @ prepared["wq"].double().t()).float()
    y = acc * scale * prepared["ws"] + prepared["b"]
    return y.to(out_dtype or x.dtype)


def quant_rows_int8_plain(x):
    """Plain version of K10's first launch: ``x`` [M, K] -> (int8 [M, K],
    f32 scale [M]), :func:`quant_rows`."""
    q, scale = quant_rows(x)
    return q.to(torch.int8), scale.reshape(-1)


def int8_rowscale_gemm_plain(xq, asc, prepared, out_dtype):
    """Plain version of K10's second launch: int8 rows ``xq`` [M, K] with
    their scales ``asc`` [M] times the weights of :func:`prepare_gemm`, the
    epilogue of :func:`int8_quant_gemm_plain`."""
    acc = (xq.double() @ prepared["wq"].double().t()).float()
    y = acc * asc.reshape(-1, 1) * prepared["ws"] + prepared["b"]
    return y.to(out_dtype)


def _check(x, n, k, out_dtype, what):
    """``x`` made contiguous and 16-byte aligned after checking it against
    [N, K] = [n, k] weights."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"{what}: x {tuple(x.shape)} does not match "
                         f"weights [N, K] = [{n}, {k}]")
    for dt in (x.dtype, out_dtype):
        if dt not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{what} takes and gives f32 or bf16, not {dt}")
    if k % 32 or n % 16:
        raise ValueError(f"{what} needs K % 32 == 0 and N % 16 == 0, got "
                         f"K={k}, N={n}")
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check_weights(prepared, device):
    for name, t in prepared.items():
        if t.device != device:
            raise ValueError(f"weight {name} is on {t.device}, x on {device}")


def int8_quant_gemm(x, prepared, out_dtype=None):
    """``x`` [M, K] (f32 or bf16) times the int8 weights of
    :func:`prepare_gemm`, with per-row dynamic int8 activations; returns
    [M, N] in ``out_dtype`` (f32 or bf16, default ``x.dtype``). CUDA
    tensor: K10, two launches (``K % 32 == 0``, ``N % 16 == 0``); CPU
    tensor: the plain version."""
    if x.device.type == "cpu":
        return int8_quant_gemm_plain(x, prepared, out_dtype)
    out_dtype = out_dtype or x.dtype
    wq = prepared["wq"]
    x = _check(x, *wq.shape, out_dtype, "int8_quant_gemm")
    _check_weights(prepared, x.device)
    (m, k), n = x.shape, wq.shape[0]
    xq = torch.empty(m, k, dtype=torch.int8, device=x.device)
    asc = torch.empty(m, dtype=torch.float32, device=x.device)
    out = torch.empty(m, n, dtype=out_dtype, device=x.device)
    p = _cuda.ptr
    code = _cuda.library().cpt_int8_quant_gemm(
        p(x), int(x.dtype == torch.bfloat16), p(wq), p(prepared["ws"]),
        p(prepared["b"]), p(out), int(out_dtype == torch.bfloat16), p(xq),
        p(asc), m, k, n, _cuda.stream_ptr(x.device))
    _cuda.check(code, "int8_quant_gemm")
    _cuda.count_launch("int8_quant_gemm", k)
    return out


def quant_rows_int8(x):
    """K10's first launch on its own: ``x`` [M, K] (f32 or bf16) -> (int8
    [M, K], f32 scale [M]). CUDA tensor: the kernel; CPU tensor:
    :func:`quant_rows_int8_plain`."""
    if x.device.type == "cpu":
        return quant_rows_int8_plain(x)
    if x.dim() != 2:
        raise ValueError(f"quant_rows_int8 takes [M, K], got {tuple(x.shape)}")
    x = _check(x, 16, x.shape[1], x.dtype, "quant_rows_int8")
    m, k = x.shape
    xq = torch.empty(m, k, dtype=torch.int8, device=x.device)
    asc = torch.empty(m, dtype=torch.float32, device=x.device)
    code = _cuda.library().cpt_int8_quant_rows(
        _cuda.ptr(x), int(x.dtype == torch.bfloat16), _cuda.ptr(xq),
        _cuda.ptr(asc), m, k, _cuda.stream_ptr(x.device))
    _cuda.check(code, "quant_rows_int8")
    return xq, asc


def int8_rowscale_gemm(xq, asc, prepared, out_dtype, tile: int = 0):
    """K10's second launch on its own: int8 rows ``xq`` [M, K] and their
    scales ``asc`` [M] times the weights of :func:`prepare_gemm` -> [M, N]
    in ``out_dtype``. CUDA tensor: the s8 GEMM core with ``tile`` (0 K10's,
    1-5 a candidate of ops/cuda/int8_gemm.cu:rowscale_gemm_as); CPU tensor:
    :func:`int8_rowscale_gemm_plain`."""
    if xq.device.type == "cpu":
        return int8_rowscale_gemm_plain(xq, asc, prepared, out_dtype)
    wq = prepared["wq"]
    (m, k), n = xq.shape, wq.shape[0]
    if xq.dtype != torch.int8 or wq.shape[1] != k or asc.shape != (m,):
        raise ValueError(f"int8_rowscale_gemm: xq {tuple(xq.shape)} "
                         f"{xq.dtype}, asc {tuple(asc.shape)}, weights "
                         f"{tuple(wq.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8_rowscale_gemm gives f32 or bf16, not "
                        f"{out_dtype}")
    _check_weights(prepared, xq.device)
    xq, asc = xq.contiguous(), asc.to(torch.float32).contiguous()
    out = torch.empty(m, n, dtype=out_dtype, device=xq.device)
    p = _cuda.ptr
    code = _cuda.library().cpt_int8_rowscale_gemm(
        p(xq), p(asc), p(wq), p(prepared["ws"]), p(prepared["b"]), p(out),
        int(out_dtype == torch.bfloat16), m, k, n, int(tile),
        _cuda.stream_ptr(xq.device))
    _cuda.check(code, "int8_rowscale_gemm")
    return out
