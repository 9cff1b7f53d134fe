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
tensor and runs :func:`int8_quant_gemm_plain` for a CPU tensor.
"""

import torch

from . import cuda as _cuda

__all__ = ["quantize_gemm_weights", "prepare_gemm", "quant_rows",
           "int8_quant_gemm", "int8_quant_gemm_plain"]


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


def int8_quant_gemm(x, prepared, out_dtype=None):
    """``x`` [M, K] (f32 or bf16) times the int8 weights of
    :func:`prepare_gemm`, with per-row dynamic int8 activations; returns
    [M, N] in ``out_dtype`` (f32 or bf16, default ``x.dtype``). CUDA
    tensor: K10 (``K % 32 == 0``, ``N % 16 == 0``); CPU tensor: the plain
    version."""
    if x.device.type == "cpu":
        return int8_quant_gemm_plain(x, prepared, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_quant_gemm: unsupported device {x.device}")
    out_dtype = out_dtype or x.dtype
    wq = prepared["wq"]
    n, k = wq.shape
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"int8_quant_gemm: x {tuple(x.shape)} does not "
                         f"match weights [N, K] = {tuple(wq.shape)}")
    for dt in (x.dtype, out_dtype):
        if dt not in (torch.float32, torch.bfloat16):
            raise TypeError(f"int8_quant_gemm takes and gives f32 or bf16, "
                            f"not {dt}")
    if k % 32 or n % 16:
        raise ValueError(f"int8_quant_gemm needs K % 32 == 0 and N % 16 == "
                         f"0, got K={k}, N={n}")
    for name, t in prepared.items():
        if t.device != x.device:
            raise ValueError(f"weight {name} is on {t.device}, x on "
                             f"{x.device}")
    x = x.contiguous()
    out = torch.empty(x.shape[0], n, dtype=out_dtype, device=x.device)
    p = _cuda.ptr
    code = _cuda.library().cpt_int8_quant_gemm(
        p(x), int(x.dtype == torch.bfloat16), p(wq), p(prepared["ws"]),
        p(prepared["b"]), p(out), int(out_dtype == torch.bfloat16),
        x.shape[0], k, n, _cuda.stream_ptr(x.device))
    _cuda.check(code, "int8_quant_gemm")
    _cuda.count_launch("int8_quant_gemm", k)
    return out
