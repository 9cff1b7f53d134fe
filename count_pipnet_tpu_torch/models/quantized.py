"""ConvNeXt serving backbones: one CUDA kernel per block, the int8
pointwise GEMMs, and the fused block-MLP.

Port of count_pipnet_tpu/models/quantized.py. The stem and downsample convs
and their LayerNorms stay PyTorch ops (the JAX package leaves them to XLA).

* :func:`fused_block_convnext_apply` (:209): every ConvNeXt block runs
  kernel A (ops/fused_block.py) on compact NHWC planes, and with
  ``gumbel_head`` the last block runs kernel C (ops/gumbel_head.py), which
  returns [B, C] counts instead of a plane. Stages whose width is >=
  ``int8_min_dim`` run their pointwise GEMMs in int8: with calibrated
  static scales (:func:`calibrate_act_scales`, :152) or, without them, with
  dynamic per-row scales. ``int8_downsample`` runs every stride-1
  downsample of width >= ``int8_min_dim`` as a 2x2 im2col and K10
  (ops/int8_gemm.py). ``dw_bf16`` runs every kernel A launch with bf16
  depthwise taps. Not carried from the TPU path: the padded-plane layout
  (``padded_planes``, ``padded_max_dim``, ``inkernel_pad``: TPU tiling
  only).
* :func:`quant_convnext_apply` (:386) on :func:`quantize_convnext_params`
  (:57): the plain blocks with each pointwise GEMM through
  :func:`int8_rowwise_matmul` (:42), a library int8 product
  (``torch._int_mm`` on the card, float64 on the CPU), erf-GELU.
* :func:`fused_convnext_apply` (:102): the depthwise conv as a PyTorch op
  and the rest of each block through K5 (ops/fused_mlp.py), tanh-GELU.

Parameters come from a ``ConvNeXtFeatures`` module; kernel and int8
weights are prepared once and reused across calls.
"""

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.fused_block import fused_block, prepare_block
from ..ops.fused_mlp import fused_ln_mlp_residual
from ..ops.gumbel_head import fused_block_gumbel_counts
from ..ops.int8_gemm import int8_quant_gemm, prepare_gemm

__all__ = ["calibrate_act_scales", "prepare_fused_blocks",
           "fused_block_convnext_apply", "block_scopes",
           "int8_rowwise_matmul", "quantize_convnext_params",
           "quant_convnext_apply", "prepare_fused_mlp",
           "fused_convnext_apply", "im2col_2x2"]


def _layer_norm(x, weight, bias, eps=1e-6):
    """LayerNorm over the last axis in f32 (NHWC)."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * weight + bias


def _conv(x, weight, bias, stride, dtype):
    """VALID conv of an NHWC plane with an OIHW kernel, in ``dtype``."""
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), weight.to(dtype),
                 bias.to(dtype), stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


def _dwconv7(x, weight, bias, dtype):
    """Depthwise 7x7 SAME conv of an NHWC plane, in ``dtype``."""
    c = x.shape[-1]
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), weight.to(dtype),
                 bias.to(dtype), padding=3, groups=c)
    return y.permute(0, 2, 3, 1)


def block_scopes(backbone):
    """[(scope, feat_idx, j, dim)] of every block, in execution order; scope
    names are the JAX package's (``features_{i}_block_{j}``)."""
    return [(f"features_{e[1]}_block_{j}", e[1], j, e[2])
            for e in backbone.layout if e[0] == "blocks"
            for j in range(e[3])]


def _stem(backbone, x, dtype):
    stem = backbone.features[0]
    h = _conv(x, stem[0].weight, stem[0].bias, 4, dtype)
    return _layer_norm(h, stem[1].weight, stem[1].bias).to(dtype)


def _downsample(backbone, entry, h, dtype, gemm=None):
    """LayerNorm + the 2x2 conv; with ``gemm`` (from :func:`prepare_gemm`)
    the conv is the 2x2 im2col and K10 (stride 1 only)."""
    _, feat_idx, _, dim, stride = entry
    ds = backbone.features[feat_idx]
    hn = _layer_norm(h, ds[0].weight, ds[0].bias).to(dtype)
    if gemm is None:
        return _conv(hn, ds[1].weight, ds[1].bias, stride, dtype)
    b, ih, iw, _ = hn.shape
    cols = im2col_2x2(hn)
    y = int8_quant_gemm(cols.reshape(-1, cols.shape[-1]), gemm,
                        out_dtype=dtype)
    return y.reshape(b, ih - 1, iw - 1, dim)


def im2col_2x2(x):
    """[B, H, W, C] -> [B, H-1, W-1, 4C]: the four taps of a stride-1 2x2
    window, in the order of the HWIO kernel's rows (dy, dx) = (0, 0),
    (0, 1), (1, 0), (1, 1)."""
    return torch.cat([x[:, :-1, :-1], x[:, :-1, 1:], x[:, 1:, :-1],
                      x[:, 1:, 1:]], dim=-1)


def _im2col_weight(conv):
    """OIHW [out, in, 2, 2] -> the [4 in, out] matrix of :func:`im2col_2x2`
    columns (the JAX package's HWIO kernel reshaped)."""
    w = conv.weight.detach().to(torch.float32)
    return w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])


@torch.no_grad()
def calibrate_act_scales(backbone, x, *, margin: float = 1.0) -> Dict:
    """Per-block activation calibration for the static int8 mode.

    An f32 forward mirroring :func:`fused_block_convnext_apply` (tanh-GELU)
    records, for every block, the per-channel abs-max of the two int8 GEMM
    inputs: the LayerNorm output [C] and the GELU output [4C]. Returns
    ``{scope: (amax_ln, amax_gelu)}``; ``margin`` scales the maxima.
    """
    scales = {}
    h = _stem(backbone, x, torch.float32)
    for entry in backbone.layout:
        if entry[0] == "down":
            h = _downsample(backbone, entry, h, torch.float32)
            continue
        _, feat_idx, _, n_blocks = entry
        for j in range(n_blocks):
            blk = backbone.features[feat_idx][j]
            dw, ln, pw1, pw2 = (blk.block[i] for i in (0, 2, 3, 5))
            y = _dwconv7(h, dw.weight, dw.bias, torch.float32)
            n = _layer_norm(y, ln.weight, ln.bias)
            a = F.gelu(n @ pw1.weight.t() + pw1.bias, approximate="tanh")
            out = a @ pw2.weight.t() + pw2.bias
            h = h + out * blk.layer_scale.reshape(-1)
            scales[f"features_{feat_idx}_block_{j}"] = (
                n.abs().amax(dim=(0, 1, 2)) * margin,
                a.abs().amax(dim=(0, 1, 2)) * margin)
    return scales


def prepare_fused_blocks(backbone, act_scales: Optional[Dict] = None,
                         int8_min_dim: Optional[int] = None,
                         fused_head: bool = True,
                         int8_downsample: bool = False) -> Dict:
    """Kernel-ready weights of every block, ``{scope: prepared}``, and with
    ``int8_downsample`` the K10 weights of every stride-1 downsample whose
    input width is >= ``int8_min_dim`` (``{"features_{i}": prepared}``).

    ``int8_min_dim`` defaults as on the TPU path: 96 with ``act_scales``,
    384 without (the dynamic per-row int8 mode breaks even only there on
    the TPU). With ``fused_head`` the last block runs bf16 when it has no
    scales, like the TPU's fused head.
    """
    if int8_min_dim is None:
        int8_min_dim = 96 if act_scales else 384
    scopes = block_scopes(backbone)
    prepared = {}
    for entry in backbone.layout:
        if (int8_downsample and entry[0] == "down" and entry[4] == 1
                and entry[2] >= int8_min_dim):
            conv = backbone.features[entry[1]][1]
            prepared[f"features_{entry[1]}"] = prepare_gemm(
                _im2col_weight(conv), conv.bias)
    for k, (scope, feat_idx, j, dim) in enumerate(scopes):
        blk = backbone.features[feat_idx][j]
        dw, ln, pw1, pw2 = (blk.block[i] for i in (0, 2, 3, 5))
        scales = (act_scales or {}).get(scope)
        int8 = dim >= int8_min_dim
        if fused_head and k == len(scopes) - 1:
            int8 = int8 and scales is not None
        prepared[scope] = prepare_block(
            dw.weight, dw.bias, ln.weight, ln.bias, pw1.weight, pw1.bias,
            pw2.weight, pw2.bias, blk.layer_scale, int8=int8,
            act_scales=scales if int8 else None)
    return prepared


@torch.no_grad()
def fused_block_convnext_apply(backbone, x, *,
                               dtype=torch.bfloat16,
                               int8_min_dim: Optional[int] = None,
                               int8_downsample: bool = False,
                               dw_bf16: bool = False,
                               act_scales: Optional[Dict] = None,
                               gumbel_head: Optional[Dict] = None,
                               prepared: Optional[Dict] = None):
    """Serving forward of ``backbone`` on NHWC images ``x`` [B, H, W, 3].

    Returns the [B, H', W', C] features in ``dtype``, or with
    ``gumbel_head={"seed": int, "noise": optional [B, H', W', C]}`` the
    [B, C] f32 gumbel-hard counts of the last block's output (kernel C;
    meaningful when the prototypes are the backbone channels,
    ``num_features=0``). ``prepared``: from :func:`prepare_fused_blocks`
    (built here from ``act_scales``, ``int8_min_dim`` and
    ``int8_downsample`` when omitted); a downsample runs through K10 when
    ``prepared`` holds its weights. ``dw_bf16``: every kernel A launch runs
    its depthwise taps in bf16; kernel C, which has only f32 taps as on the
    TPU, does not take it.
    """
    if prepared is None:
        prepared = prepare_fused_blocks(backbone, act_scales, int8_min_dim,
                                        fused_head=gumbel_head is not None,
                                        int8_downsample=int8_downsample)
    last = block_scopes(backbone)[-1][0]
    h = _stem(backbone, x, dtype)
    for entry in backbone.layout:
        if entry[0] == "down":
            h = _downsample(backbone, entry, h, dtype,
                            prepared.get(f"features_{entry[1]}"))
            continue
        _, feat_idx, _, n_blocks = entry
        for j in range(n_blocks):
            scope = f"features_{feat_idx}_block_{j}"
            if gumbel_head is not None and scope == last:
                return fused_block_gumbel_counts(
                    h, prepared[scope], seed=gumbel_head.get("seed", 0),
                    noise=gumbel_head.get("noise"))
            h = fused_block(h, prepared[scope], dw_bf16=dw_bf16)
    return h


def _quantize_weight(kernel):
    """[in, out] float -> (int8 [in, out], f32 scale [out]), symmetric per
    output channel (the JAX package's ``_quantize_weight``)."""
    amax = kernel.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(kernel / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_rowwise_matmul(x, wq, wscale):
    """Dynamic per-row int8 ``x`` [..., K] times static per-channel int8
    ``wq`` [K, N] -> f32 [..., N]: ``ascale = where(amax > 0, amax / 127,
    1)``, ``clip(round(x / ascale), +-127)``, int32 sums (``torch._int_mm``
    on a CUDA tensor, float64 on the CPU: both exact), ``acc * ascale *
    wscale``."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=-1, keepdim=True)
    ascale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                         torch.ones_like(amax))
    xq = torch.clamp(torch.round(x32 / ascale), -127, 127)
    k = x.shape[-1]
    if x.device.type == "cuda":
        acc = torch._int_mm(xq.to(torch.int8).reshape(-1, k), wq).float()
    else:
        acc = (xq.reshape(-1, k).double() @ wq.double()).float()
    acc = acc.reshape(*x.shape[:-1], -1)
    return acc * ascale * wscale


def quantize_convnext_params(backbone) -> Dict:
    """Every block's pw1/pw2 as int8: ``{scope: {"pw1": {"q": int8 [in,
    out], "scale": [out], "bias": [out]}, "pw2": ...}}`` (the JAX package's
    quantize_convnext_params, :57, on a ``ConvNeXtFeatures`` module)."""
    out = {}
    for scope, feat_idx, j, _ in block_scopes(backbone):
        blk = backbone.features[feat_idx][j]
        layers = {}
        for name, lin in (("pw1", blk.block[3]), ("pw2", blk.block[5])):
            q, scale = _quantize_weight(lin.weight.detach().float().t())
            layers[name] = {"q": q.contiguous(), "scale": scale,
                            "bias": lin.bias.detach().float()}
        out[scope] = layers
    return out


@torch.no_grad()
def quant_convnext_apply(backbone, qparams: Dict, x, *,
                         dtype=torch.bfloat16):
    """Forward of ``backbone`` with the int8 pointwise GEMMs of
    ``qparams`` (:func:`quantize_convnext_params`) on NHWC images ``x``:
    the stem, depthwise and downsample convs in ``dtype``, LayerNorm and
    erf-GELU in f32, the block output cast to ``dtype`` before the
    residual add (the JAX package's :386)."""
    h = _stem(backbone, x, dtype)
    for entry in backbone.layout:
        if entry[0] == "down":
            h = _downsample(backbone, entry, h, dtype)
            continue
        _, feat_idx, _, n_blocks = entry
        for j in range(n_blocks):
            blk = backbone.features[feat_idx][j]
            q = qparams[f"features_{feat_idx}_block_{j}"]
            dw, ln = blk.block[0], blk.block[2]
            y = _dwconv7(h, dw.weight, dw.bias, dtype)
            y = _layer_norm(y, ln.weight, ln.bias)
            y = int8_rowwise_matmul(y, q["pw1"]["q"], q["pw1"]["scale"])
            y = F.gelu(y + q["pw1"]["bias"])
            y = int8_rowwise_matmul(y, q["pw2"]["q"], q["pw2"]["scale"])
            y = (y + q["pw2"]["bias"]) * blk.layer_scale.reshape(-1)
            h = h + y.to(dtype)
    return h


def prepare_fused_mlp(backbone) -> Dict:
    """K5's weights of every block, ``{scope: kwargs}``: bf16 GEMM
    operands and f32 vectors, made once (the wrapper then casts
    nothing)."""
    def f32(t):
        return t.detach().to(torch.float32).reshape(-1).contiguous()

    def bf16(t):
        return t.detach().to(torch.bfloat16).contiguous()

    out = {}
    for scope, feat_idx, j, _ in block_scopes(backbone):
        blk = backbone.features[feat_idx][j]
        ln, pw1, pw2 = blk.block[2], blk.block[3], blk.block[5]
        out[scope] = dict(ln_scale=f32(ln.weight), ln_bias=f32(ln.bias),
                          w1=bf16(pw1.weight), b1=f32(pw1.bias),
                          w2=bf16(pw2.weight), b2=f32(pw2.bias),
                          gamma=f32(blk.layer_scale))
    return out


@torch.inference_mode()
def fused_convnext_apply(backbone, x, *, dtype=torch.bfloat16,
                         prepared: Optional[Dict] = None):
    """Forward of ``backbone`` on NHWC images ``x`` with every block body
    after the depthwise conv through K5 (``fused_ln_mlp_residual``,
    tanh-GELU, bf16 GEMM operands), planes in ``dtype`` (the JAX package's
    :102). ``prepared``: from :func:`prepare_fused_mlp`."""
    if prepared is None:
        prepared = prepare_fused_mlp(backbone)
    h = _stem(backbone, x, dtype)
    for entry in backbone.layout:
        if entry[0] == "down":
            h = _downsample(backbone, entry, h, dtype)
            continue
        _, feat_idx, _, n_blocks = entry
        for j in range(n_blocks):
            dw = backbone.features[feat_idx][j].block[0]
            y = _dwconv7(h, dw.weight, dw.bias, dtype)
            h = fused_ln_mlp_residual(
                y, h, **prepared[f"features_{feat_idx}_block_{j}"])
    return h
