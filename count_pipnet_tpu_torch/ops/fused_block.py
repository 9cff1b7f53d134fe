"""A whole ConvNeXt block for serving: kernel A and its plain version.

    dwconv7x7 -> LayerNorm -> Dense(C->4C) -> GELU(tanh) -> Dense(4C->C)
        -> * layer_scale -> + residual

Port of count_pipnet_tpu/ops/pallas/fused_block.py (``fused_block_apply``
and ``fused_block_apply_padded``; the TPU's padded-plane layout is not
carried: the CUDA kernel reads compact NHWC planes and copies each strip
of image rows with its 3-pixel halo into shared memory as TMA boxes that
read zeros outside the image, as K7 does). Three GEMM modes, as on the
TPU:

* bf16: the LN and GELU outputs are cast to bf16, products accumulate in f32;
* int8-static: calibrated per-channel activation maxima are folded into
  the int8 weights (:func:`quantize_block_weights_folded`) and the kernel
  quantizes with one multiply, ``round(clip(x * 127/amax, +-127))``;
* int8-dynamic (``int8=True`` without ``act_scales``): per-output-channel
  int8 weights (:func:`quantize_block_weights`) and, per row, the LN output
  quantized over C and the GELU output over 4C with ``ops.int8_gemm.
  quant_rows`` (the TPU's ``_quant_rows``); its launches count as
  ``fused_block_int8_dyn``.

Kernel A is launches on the stream (ops/cuda/fused_block.cu), and its plain
version the composition of the same stages: :func:`block_prologue_plain`
(depthwise conv, LayerNorm, the GEMM operand ``n``: bf16, int8, or in the
dynamic mode int8 with its rows' scales, ``(nq, nsc)``),
:func:`block_up_plain` (GEMM 1, GELU, the hidden operand: bf16, int8, or
``(aq, asc)``) and :func:`block_down_plain` (GEMM 2, layer scale,
residual). The dynamic mode runs GEMM 1 twice on the card: a scan pass
that takes each row's GELU abs-max (:func:`block_up_scan`,
:func:`block_up_scan_plain`), then a quantize pass with the scale it
implies. :func:`block_prologue`, :func:`block_up_scan`, :func:`block_up`,
:func:`block_down` and :func:`sm90_gemm_s8` (the s8 mode of the GEMM core
all the int8 GEMMs run on) launch one stage alone, so that a check can
hold each against its plain version; a call of :func:`fused_block` counts
as one launch of kernel A.

``dw_bf16=True`` runs the 49 depthwise taps in bf16, in any of the three
modes, as the TPU's ``tap_dtype=bfloat16`` does
(:func:`dwconv7_bf16_taps_plain` writes the arithmetic out; the kernel
takes two channels a thread in bf16x2); its launches count as
``fused_block_dwbf16`` and ``fused_block_int8_dyn_dwbf16``.

Weights are prepared once (:func:`prepare_block`), in the layout the kernel
reads: ``[out, in]`` GEMM operands (K-major, as the int8 wgmma reads them).
:func:`fused_block` launches the CUDA kernels (ops/cuda/fused_block.cu) for
a CUDA tensor and runs :func:`fused_block_plain` for a CPU tensor.

For training (``--fused_whole_blocks``), :func:`fused_block_ad` is the
port of the JAX package's ``fused_block_ad``: kernel A in bf16 mode as the
forward, on weights prepared from the current parameters at every call;
the backward recomputes :func:`block_body_plain` (the JAX package's
``_block_body_xla``) under autograd, so nothing wider than the block input
is saved. In that recompute the f32 depthwise conv runs through
``dwconv7_ad`` (ops/dwconv_bwd.py), whose weight gradient is K8: cuDNN's
f32 grouped weight gradient took most of the step.
"""

import torch
import torch.nn.functional as F

from . import cuda as _cuda
from .dwconv_bwd import dwconv7_ad
from .fused_mlp import _aligned
from .fused_mlp_bwd import _rows
from .int8_gemm import quant_rows

__all__ = ["quantize_block_weights", "quantize_block_weights_folded",
           "prepare_block", "dwconv7_bf16_taps_plain", "fused_block",
           "fused_block_plain", "block_residual_plain", "block_prologue",
           "block_prologue_plain", "block_up_scan", "block_up_scan_plain",
           "block_up", "block_up_plain", "block_down", "block_down_plain",
           "sm90_gemm_s8",
           "block_body_plain", "fused_block_ad", "FusedBlock"]

K = 7
PAD = 3


def quantize_block_weights(kernel):
    """[C, H] float -> (int8 [C, H], f32 scale [1, H]) symmetric
    per-output-channel."""
    k = torch.as_tensor(kernel, dtype=torch.float32)
    amax = k.abs().amax(dim=0, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_block_weights_folded(kernel, act_amax):
    """Weight quantization for the static activation-scale mode: the
    per-input-channel activation scale ``amax_k / 127`` is folded into the
    ``[in, out]`` weight before per-output-channel quantization, so
    ``acc * wscale`` alone dequantizes the int8 GEMM.

    Returns (int8 [C, H], f32 wscale [1, H], f32 inv [1, C] = 127/amax).
    """
    amax = torch.clamp_min(
        torch.as_tensor(act_amax, dtype=torch.float32).reshape(-1), 1e-9)
    k = torch.as_tensor(kernel, dtype=torch.float32) \
        * (amax / 127.0)[:, None]
    q, scale = quantize_block_weights(k)
    # tensor / tensor: ``127.0 / amax`` would run as 127 * reciprocal(amax)
    # in PyTorch, one ulp off the IEEE quotient the JAX package computes
    inv = torch.full_like(amax, 127.0) / amax
    return q, scale, inv.reshape(1, -1)


def prepare_block(dw_weight, dw_bias, ln_weight, ln_bias, pw1_weight,
                  pw1_bias, pw2_weight, pw2_bias, layer_scale, *,
                  int8: bool = False, act_scales=None):
    """Kernel-ready weights of one block, from torch-layout parameters
    (``dw_weight`` [C, 1, 7, 7], ``pw1_weight`` [4C, C], ``pw2_weight``
    [C, 4C], ``layer_scale`` [C, 1, 1] or [C]).

    ``int8=True`` with ``act_scales = (amax_ln [C], amax_gelu [4C])`` is
    the static mode, without them the dynamic per-row mode. Returns a dict
    of contiguous tensors on the parameters' device.
    """
    f32 = lambda t: t.detach().to(torch.float32).reshape(-1).contiguous()
    c = dw_weight.shape[0]
    pb = {
        "int8": bool(int8), "dynamic": bool(int8) and act_scales is None,
        "dwk": dw_weight.detach().to(torch.float32).reshape(c, K * K)
        .t().contiguous(),                       # [49, C], tap dy * 7 + dx
        "dwb": f32(dw_bias), "lns": f32(ln_weight), "lnb": f32(ln_bias),
        "b1": f32(pw1_bias), "b2": f32(pw2_bias), "g": f32(layer_scale),
        "s1": None, "i1": None, "s2": None, "i2": None,
    }
    if pb["dynamic"]:
        w1q, s1 = quantize_block_weights(pw1_weight.detach().t())
        w2q, s2 = quantize_block_weights(pw2_weight.detach().t())
        pb.update(w1=w1q.t().contiguous(), s1=f32(s1),
                  w2=w2q.t().contiguous(), s2=f32(s2))
    elif int8:
        w1q, s1, i1 = quantize_block_weights_folded(
            pw1_weight.detach().t(), act_scales[0])
        w2q, s2, i2 = quantize_block_weights_folded(
            pw2_weight.detach().t(), act_scales[1])
        pb.update(w1=w1q.t().contiguous(), s1=f32(s1), i1=f32(i1),
                  w2=w2q.t().contiguous(), s2=f32(s2), i2=f32(i2))
    else:
        pb.update(w1=pw1_weight.detach().to(torch.bfloat16).contiguous(),
                  w2=pw2_weight.detach().to(torch.bfloat16).contiguous())
    return pb


def dwconv7_bf16_taps_plain(x, dwk, dwb):
    """Depthwise 7x7 (SAME) + bias of NHWC ``x`` with bf16 taps, the TPU's
    ``tap_dtype=bfloat16`` (count_pipnet_tpu/ops/pallas/fused_block.py:
    ``_dwconv_flat``, ``_dwconv_pad``): the plane and the [49, C] weights
    ``dwk`` rounded to bf16; for each dx the 7 products, each rounded to
    bf16, summed in bf16 in dy order; each per-dx sum cast to f32 and added
    to the f32 bias ``dwb``, in dx order. PyTorch rounds after every bf16
    operation, as the kernel does. Returns f32 [B, H, W, C]."""
    b, h, w, c = x.shape
    xp = F.pad(x.to(torch.bfloat16), (0, 0, PAD, PAD, PAD, PAD))
    wk = dwk.to(torch.bfloat16)
    acc = dwb.to(torch.float32).expand(b, h, w, c)
    for dx in range(K):
        vs = xp[:, 0:h, dx:dx + w] * wk[dx]
        for dy in range(1, K):
            vs = vs + xp[:, dy:dy + h, dx:dx + w] * wk[dy * K + dx]
        acc = acc + vs.to(torch.float32)
    return acc


def _ln_plain(x, pb, eps, dw_bf16):
    """Depthwise 7x7 + bias (f32 taps, or :func:`dwconv7_bf16_taps_plain`),
    then LayerNorm, in f32."""
    c = x.shape[-1]
    if dw_bf16:
        d = dwconv7_bf16_taps_plain(x, pb["dwk"], pb["dwb"])
    else:
        wk = pb["dwk"].t().reshape(c, 1, K, K)
        d = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2), wk, pb["dwb"],
                     padding=PAD, groups=c).permute(0, 2, 3, 1)
    mu = d.mean(dim=-1, keepdim=True)
    var = (d - mu).square().mean(dim=-1, keepdim=True)
    return (d - mu) * torch.rsqrt(var + eps) * pb["lns"] + pb["lnb"]


def _quant_static(v, inv):
    """round(clip(v * inv, +-127)) as int8, half to even (the kernels'
    quant_scaled)."""
    return torch.round(torch.clamp(v * inv, -127.0, 127.0)).to(torch.int8)


def block_prologue_plain(x, pb, eps: float = 1e-6, dw_bf16: bool = False):
    """Stage a of kernel A: the depthwise conv, LayerNorm, and GEMM 1's
    operand ``n``: bf16; int8 with the static scale (``round(clip(n *
    i1))``); or in the dynamic mode ``(nq, nsc)``, the rows quantized over
    C (:func:`quant_rows`) as int8 and their f32 scales [..., 1]. [B, H, W,
    C] -> the same shape in bf16 or int8."""
    n = _ln_plain(x, pb, eps, dw_bf16)
    if pb["dynamic"]:
        nq, nsc = quant_rows(n)
        return nq.to(torch.int8), nsc
    return _quant_static(n, pb["i1"]) if pb["int8"] else n.to(torch.bfloat16)


def _up_dyn(n, pb):
    """GEMM 1 of the dynamic mode on ``n = (nq, nsc)`` and its GELU (the
    kernels' up_dyn), f32 ``[..., 4C]``: ``gelu_tanh(sum * nsc * s1 +
    b1)``, exact sums in float64."""
    nq, nsc = n
    hid = (nq.double() @ pb["w1"].double().t()).float()
    return F.gelu(hid * nsc * pb["s1"] + pb["b1"], approximate="tanh")


def block_up_scan_plain(n, pb):
    """The dynamic mode's GEMM 1 scan pass: each row's GELU abs-max, f32
    [..., 1], from ``n = (nq, nsc)``."""
    return _up_dyn(n, pb).abs().amax(dim=-1, keepdim=True)


def block_up_plain(n, pb, amax=None):
    """Stage b: GEMM 1 ``n W1^T`` and its epilogue, ``[..., C] ->
    [..., 4C]``: int8 (exact sums in float64) ``gelu_tanh(sum * s1 + b1)``
    quantized with ``i2``; bf16 ``gelu_tanh(sum + b1)`` rounded to bf16; or
    in the dynamic mode, from ``n = (nq, nsc)``, ``(aq, asc)``: the GELU
    rows quantized over 4C as int8 and their f32 scales [..., 1], with the
    rows' abs-max ``amax`` where it is given (the quantize pass alone)."""
    if pb["dynamic"]:
        aq, asc = quant_rows(_up_dyn(n, pb), amax)
        return aq.to(torch.int8), asc
    if pb["int8"]:
        hid = (n.double() @ pb["w1"].double().t()).float()
        a = F.gelu(hid * pb["s1"] + pb["b1"], approximate="tanh")
        return _quant_static(a, pb["i2"])
    hid = n.float() @ pb["w1"].float().t() + pb["b1"]
    return F.gelu(hid, approximate="tanh").to(torch.bfloat16)


def _block_down_f32(h, x, pb):
    if pb["dynamic"]:
        aq, asc = h
        y = (aq.double() @ pb["w2"].double().t()).float()
        y = y * asc * pb["s2"] + pb["b2"]
    elif pb["int8"]:
        y = (h.double() @ pb["w2"].double().t()).float()
        y = y * pb["s2"] + pb["b2"]
    else:
        y = h.float() @ pb["w2"].float().t() + pb["b2"]
    return x.to(torch.float32) + y * pb["g"]


def block_down_plain(h, x, pb):
    """Stage c: GEMM 2 ``h W2^T`` and its epilogue, ``x + (sum * s2 + b2)
    * g`` (int8, exact sums), ``x + (sum * asc * s2 + b2) * g`` (dynamic,
    ``h = (aq, asc)``) or ``x + (sum + b2) * g`` (bf16), in ``x.dtype``."""
    return _block_down_f32(h, x, pb).to(x.dtype)


def block_residual_plain(x, pb, eps: float = 1e-6, dw_bf16: bool = False):
    """Plain PyTorch block on NHWC ``x``; returns the f32 block output
    (before the cast to ``x.dtype``): the composition of the three stages'
    plain versions. The int8 GEMMs run in float64, which holds their
    integer sums exactly. ``dw_bf16``: the depthwise taps of
    :func:`dwconv7_bf16_taps_plain`. On a GPU, set
    ``torch.backends.cudnn.allow_tf32 = False`` first: the f32 depthwise
    conv would otherwise run in TF32."""
    n = block_prologue_plain(x, pb, eps, dw_bf16)
    return _block_down_f32(block_up_plain(n, pb), x, pb)


def fused_block_plain(x, pb, eps: float = 1e-6, dw_bf16: bool = False):
    """Plain version of kernel A: [B, H, W, C] -> same shape and dtype."""
    return block_residual_plain(x, pb, eps, dw_bf16).to(x.dtype)


def check_block_inputs(x, pb):
    """Raise on what the CUDA block kernels do not take."""
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"expected a contiguous [B, H, W, C] plane, got "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"block kernel takes f32 or bf16 planes, not "
                        f"{x.dtype}")
    if x.shape[-1] % 32:
        raise ValueError(f"block kernel needs C % 32 == 0, got "
                         f"C={x.shape[-1]}")
    for k, v in pb.items():
        if torch.is_tensor(v) and v.device != x.device:
            raise ValueError(f"weight {k} is on {v.device}, plane on "
                             f"{x.device}")


def block_args(x, pb):
    """The kernel-A argument list shared with kernel C (ops/gumbel_head)."""
    p = _cuda.ptr
    b, h, w, c = x.shape
    return [int(x.dtype == torch.bfloat16), _mode(pb), b, h, w, c,
            p(pb["dwk"]), p(pb["dwb"]), p(pb["lns"]), p(pb["lnb"]),
            p(pb["w1"]), p(pb["s1"]), p(pb["b1"]), p(pb["i1"]),
            p(pb["w2"]), p(pb["s2"]), p(pb["b2"]), p(pb["i2"]),
            p(pb["g"])]


def _mode(pb):
    """The GEMM operand mode (ops/cuda/block.cuh: kQBf16, kQStatic,
    kQDyn)."""
    return 2 if pb["dynamic"] else int(pb["int8"])


def _operand_dtype(pb):
    return torch.int8 if pb["int8"] else torch.bfloat16


def _row_vector(t, r, what):
    """A per-row f32 vector ([..., 1], ``r`` rows) as a contiguous CUDA
    tensor of ``r`` floats."""
    if t.dtype != torch.float32 or t.numel() != r or t.device.type != "cuda":
        raise ValueError(f"{what}: expected {r} f32 values on a CUDA device, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    return t.detach().reshape(r).contiguous()


def fused_block(x, pb, eps: float = 1e-6, dw_bf16: bool = False):
    """Whole ConvNeXt block on a compact NHWC plane ``x`` [B, H, W, C]
    (f32 or bf16), weights from :func:`prepare_block`; ``dw_bf16``: bf16
    depthwise taps. Returns the block output in ``x.dtype``. CUDA tensor:
    kernel A; CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return fused_block_plain(x, pb, eps, dw_bf16)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block: unsupported device {x.device}")
    check_block_inputs(x, pb)
    _aligned(x, "fused_block: the plane")
    # the launches' scratch: GEMM 1's and GEMM 2's operands and, in the
    # dynamic mode, the rows' LN scales, GELU abs-max and GELU scales
    r, c = x.numel() // x.shape[-1], x.shape[-1]
    n = torch.empty(r, c, dtype=_operand_dtype(pb), device=x.device)
    hid = torch.empty(r, 4 * c, dtype=n.dtype, device=x.device)
    rs = torch.empty(3, r, dtype=torch.float32, device=x.device) \
        if pb["dynamic"] else None
    out = torch.empty_like(x)
    code = _cuda.library().cpt_fused_block(
        x.data_ptr(), out.data_ptr(), int(dw_bf16), *block_args(x, pb),
        float(eps), n.data_ptr(), hid.data_ptr(), _cuda.ptr(rs),
        _cuda.stream_ptr(x.device))
    _cuda.check(code, "fused_block")
    name = "fused_block_int8_dyn" if pb["dynamic"] else "fused_block"
    _cuda.count_launch(name + "_dwbf16" if dw_bf16 else name, x.shape[-1])
    return out


def block_prologue(x, pb, eps: float = 1e-6, dw_bf16: bool = False,
                   tile=None):
    """Kernel A's stage a alone (CUDA), or :func:`block_prologue_plain`
    (CPU). ``tile``: a halo tile (tr, cs) in place of the
    chosen one (ops/cuda/block.cuh: ``DwPlan``; the tile sweep,
    scripts/dw_tiles.py); every tile computes the same bits."""
    if x.device.type == "cpu":
        return block_prologue_plain(x, pb, eps, dw_bf16)
    check_block_inputs(x, pb)
    _aligned(x, "block_prologue: the plane")  # the TMA's plane
    b, h, w, c = x.shape
    n = torch.empty(x.shape, dtype=_operand_dtype(pb), device=x.device)
    nsc = torch.empty(b, h, w, 1, dtype=torch.float32, device=x.device) \
        if pb["dynamic"] else None
    p = _cuda.ptr
    code = _cuda.library().cpt_block_prologue(
        x.data_ptr(), n.data_ptr(), p(nsc), None, None, int(dw_bf16),
        int(x.dtype == torch.bfloat16), _mode(pb), b, h, w, c, p(pb["dwk"]),
        p(pb["dwb"]), p(pb["lns"]), p(pb["lnb"]), p(pb["i1"]), float(eps),
        *(tile or (0, 0)), _cuda.stream_ptr(x.device))
    _cuda.check(code, "block_prologue")
    return (n, nsc) if pb["dynamic"] else n


def _up_launch(n, pb, passes, tile, amax=None):
    """One call of kernel A's GEMM 1 entry on ``n`` (in the dynamic mode
    ``(nq, nsc)``; ``passes`` 1 the scan into ``amax``, 2 the quantize
    pass from it, 3 both): (hidden, row scales or None, amax or None)."""
    nq, nsc = n if pb["dynamic"] else (n, None)
    c = nq.shape[-1]
    nf = _rows(nq, c, "block_up", (_operand_dtype(pb),), tma=True)
    r = nf.shape[0]
    h = asc = None
    if passes & 2 or not pb["dynamic"]:
        h = torch.empty(*nq.shape[:-1], 4 * c, dtype=nq.dtype,
                        device=nq.device)
    if pb["dynamic"]:
        nsc = _row_vector(nsc, r, "block_up: nsc")
        if amax is None:
            amax = torch.zeros(*nq.shape[:-1], 1, dtype=torch.float32,
                               device=nq.device)
        amax = _row_vector(amax, r, "block_up: amax")
        if passes & 2:
            asc = torch.empty(*nq.shape[:-1], 1, dtype=torch.float32,
                              device=nq.device)
    p = _cuda.ptr
    code = _cuda.library().cpt_block_up(
        p(nf), p(pb["w1"]), p(pb["s1"]), p(pb["b1"]), p(pb["i2"]), p(h),
        p(nsc), p(amax), p(asc), _mode(pb), passes, r, c, int(tile),
        _cuda.stream_ptr(nq.device))
    _cuda.check(code, "block_up")
    return h, asc, amax


def block_up_scan(n, pb):
    """The dynamic mode's GEMM 1 scan pass alone on ``n = (nq, nsc)``
    (CUDA): each row's GELU abs-max, f32 [..., 1]; or
    :func:`block_up_scan_plain` (CPU)."""
    if not pb["dynamic"]:
        raise ValueError("block_up_scan: only the dynamic int8 mode scans")
    if n[0].device.type == "cpu":
        return block_up_scan_plain(n, pb)
    amax = _up_launch(n, pb, 1, 0)[2]
    return amax.reshape(*n[0].shape[:-1], 1)


def block_up(n, pb, tile: int = 0, amax=None):
    """Kernel A's stage b (GEMM 1 and its epilogue) alone (CUDA), or
    :func:`block_up_plain` (CPU). In the dynamic mode ``n = (nq, nsc)``,
    and the result ``(aq, asc)``: the scan pass, then the quantize pass;
    with the rows' GELU abs-max ``amax`` given, the quantize pass alone.
    ``tile`` (int8): 0 the tile kernel A takes, 1-5 the candidates it was
    chosen from (ops/cuda/block.cuh: gemm_tiled)."""
    first = n[0] if pb["dynamic"] else n
    if first.device.type == "cpu":
        return block_up_plain(n, pb, amax)
    h, asc, _ = _up_launch(n, pb, 3 if amax is None else 2, tile, amax)
    return (h, asc) if pb["dynamic"] else h


def block_down(h, x, pb, tile: int = 0):
    """Kernel A's stage c (GEMM 2, layer scale and residual ``x``) alone
    (CUDA), or :func:`block_down_plain` (CPU); in the dynamic mode ``h =
    (aq, asc)``; ``tile`` as for :func:`block_up`."""
    hq, asc = h if pb["dynamic"] else (h, None)
    if hq.device.type == "cpu":
        return block_down_plain(h, x, pb)
    c = x.shape[-1]
    hf = _rows(hq, 4 * c, "block_down", (_operand_dtype(pb),), tma=True)
    xf = _rows(x, c, "block_down: the residual", tma=True)
    if hf.shape[0] != xf.shape[0]:
        raise ValueError(f"block_down: {hf.shape[0]} hidden rows, "
                         f"{xf.shape[0]} residual rows")
    if pb["dynamic"]:
        asc = _row_vector(asc, xf.shape[0], "block_down: asc")
    out = torch.empty_like(x)
    p = _cuda.ptr
    code = _cuda.library().cpt_block_down(
        p(hf), p(pb["w2"]), p(pb["s2"]), p(pb["b2"]), p(pb["g"]), p(asc),
        p(xf), int(x.dtype == torch.bfloat16), p(out), _mode(pb),
        xf.shape[0], c, int(tile), _cuda.stream_ptr(x.device))
    _cuda.check(code, "block_down")
    return out


def sm90_gemm_s8(a, b):
    """The GEMM core's s8 mode alone: ``a [M, K] . b [N, K]^T`` with int8
    operands, exact int32 out, with the tile kernel A's GEMM 1 (N = 4K) or
    else its GEMM 2 takes (CUDA); on the CPU the same sums in float64."""
    if a.device.type == "cpu":
        return (a.double() @ b.double().t()).to(torch.int32)
    k = a.shape[-1]
    if a.dim() != 2 or b.dim() != 2 or k % 16 or b.shape[0] % 8:
        raise ValueError(f"sm90_gemm_s8 takes [M, K], [N, K] with K % 16 == "
                         f"0 and N % 8 == 0, not {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    af = _rows(a, k, "sm90_gemm_s8: a", (torch.int8,), tma=True)
    bf = _rows(b, k, "sm90_gemm_s8: b", (torch.int8,), tma=True)
    d = torch.empty(a.shape[0], b.shape[0], dtype=torch.int32,
                    device=a.device)
    code = _cuda.library().cpt_sm90_gemm_s8(
        _cuda.ptr(af), _cuda.ptr(bf), _cuda.ptr(d), a.shape[0], b.shape[0],
        k, _cuda.stream_ptr(a.device))
    _cuda.check(code, "sm90_gemm_s8")
    return d


def block_body_plain(x, dw_weight, dw_bias, ln_weight, ln_bias, pw1_weight,
                     pw1_bias, pw2_weight, pw2_bias, layer_scale,
                     eps: float = 1e-6):
    """The whole block in PyTorch ops, differentiable, as the JAX package's
    ``_block_body_xla``: the depthwise conv and the LayerNorm in f32, the
    two GEMMs on bf16 operands (f32 sums, the result rounded to bf16),
    tanh-GELU, the output in ``x.dtype``. Torch-layout parameters
    (``dw_weight`` [C, 1, 7, 7], ``pw1_weight`` [4C, C], ``pw2_weight``
    [C, 4C], ``layer_scale`` [C]). The depthwise conv is ``dwconv7_ad``:
    its weight gradient is K8 for a CUDA tensor, the plain tap sums for a
    CPU tensor."""
    bf = torch.bfloat16
    x32 = x.float()
    c = x.shape[-1]
    d = dwconv7_ad(x32, dw_weight.float(), dw_bias.float(), torch.float32)
    mu = d.mean(dim=-1, keepdim=True)
    var = (d - mu).square().mean(dim=-1, keepdim=True)
    n = (d - mu) * torch.rsqrt(var + eps) * ln_weight.float() \
        + ln_bias.float()
    h = (n.to(bf) @ pw1_weight.to(bf).t()).float() + pw1_bias.float()
    a = F.gelu(h, approximate="tanh")
    y = (a.to(bf) @ pw2_weight.to(bf).t()).float() + pw2_bias.float()
    return (x32 + y * layer_scale.float().reshape(c)).to(x.dtype)


class FusedBlock(torch.autograd.Function):
    """Kernel A forward (bf16 GEMMs), backward by recomputing
    :func:`block_body_plain` with autocast off, its depthwise conv through
    ``dwconv7_ad`` (the K8 weight gradient). Saves only ``x`` and the
    parameters."""

    @staticmethod
    def forward(ctx, x, dw_weight, dw_bias, ln_weight, ln_bias, pw1_weight,
                pw1_bias, pw2_weight, pw2_bias, layer_scale, eps):
        params = (dw_weight, dw_bias, ln_weight, ln_bias, pw1_weight,
                  pw1_bias, pw2_weight, pw2_bias, layer_scale)
        with torch.autocast(x.device.type, enabled=False):
            out = fused_block(x.contiguous(), prepare_block(*params), eps)
        ctx.save_for_backward(x, *params)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:10]
        ins = [t.detach().requires_grad_(n)
               for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad(), \
                torch.autocast(g.device.type, enabled=False):
            out = block_body_plain(*ins, ctx.eps)
            wanted = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(out, wanted, g)
                       if wanted else ())
        return tuple(next(got) if n else None for n in need) + (None,)


def fused_block_ad(x, dw_weight, dw_bias, ln_weight, ln_bias, pw1_weight,
                   pw1_bias, pw2_weight, pw2_bias, layer_scale,
                   eps: float = 1e-6):
    """Differentiable whole ConvNeXt block on a compact NHWC plane ``x``
    [B, H, W, C] (f32 or bf16; the output in ``x.dtype``). CUDA tensor:
    kernel A forward; CPU tensor: its plain version."""
    return FusedBlock.apply(x, dw_weight, dw_bias, ln_weight, ln_bias,
                            pw1_weight, pw1_bias, pw2_weight, pw2_bias,
                            layer_scale, eps)
