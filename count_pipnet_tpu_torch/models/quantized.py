"""ConvNeXt serving forward with one CUDA kernel per block.

Port of count_pipnet_tpu/models/quantized.py:calibrate_act_scales (:152)
and :fused_block_convnext_apply (:209). The stem and downsample convs and
their LayerNorms stay PyTorch ops (the JAX package leaves them to XLA);
every ConvNeXt block runs kernel A (ops/fused_block.py) on compact NHWC
planes, and with ``gumbel_head`` the last block runs kernel C
(ops/gumbel_head.py), which returns [B, C] counts instead of a plane.

Stages whose width is >= ``int8_min_dim`` run their pointwise GEMMs in
int8 with calibrated static scales. Not carried from the TPU path
(ROADMAP Queue 1): the padded-plane layout (``padded_planes``,
``padded_max_dim``, ``inkernel_pad``), ``int8_downsample`` and ``dw_bf16``;
int8 without ``act_scales`` (the dynamic per-row mode) raises.

Parameters come from a ``ConvNeXtFeatures`` module; kernel weights are
prepared once (:func:`prepare_fused_blocks`) and reused across calls.
"""

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.fused_block import fused_block, prepare_block
from ..ops.gumbel_head import fused_block_gumbel_counts

__all__ = ["calibrate_act_scales", "prepare_fused_blocks",
           "fused_block_convnext_apply", "block_scopes"]


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


def _downsample(backbone, entry, h, dtype):
    _, feat_idx, _, _, stride = entry
    ds = backbone.features[feat_idx]
    hn = _layer_norm(h, ds[0].weight, ds[0].bias).to(dtype)
    return _conv(hn, ds[1].weight, ds[1].bias, stride, dtype)


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
                         fused_head: bool = True) -> Dict:
    """Kernel-ready weights of every block, ``{scope: prepared}``.

    ``int8_min_dim`` defaults as on the TPU path: 96 with ``act_scales``,
    384 without (where int8 would need the unported dynamic mode, so
    :func:`ops.fused_block.prepare_block` raises). With ``fused_head`` the
    last block falls back to bf16 without scales, like the TPU's fused head.
    """
    if int8_min_dim is None:
        int8_min_dim = 96 if act_scales else 384
    scopes = block_scopes(backbone)
    prepared = {}
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
                               act_scales: Optional[Dict] = None,
                               gumbel_head: Optional[Dict] = None,
                               prepared: Optional[Dict] = None):
    """Serving forward of ``backbone`` on NHWC images ``x`` [B, H, W, 3].

    Returns the [B, H', W', C] features in ``dtype``, or with
    ``gumbel_head={"seed": int, "noise": optional [B, H', W', C]}`` the
    [B, C] f32 gumbel-hard counts of the last block's output (kernel C;
    meaningful when the prototypes are the backbone channels,
    ``num_features=0``). ``prepared``: from :func:`prepare_fused_blocks`
    (built here from ``act_scales`` and ``int8_min_dim`` when omitted).
    """
    if prepared is None:
        prepared = prepare_fused_blocks(backbone, act_scales, int8_min_dim,
                                        fused_head=gumbel_head is not None)
    last = block_scopes(backbone)[-1][0]
    h = _stem(backbone, x, dtype)
    for entry in backbone.layout:
        if entry[0] == "down":
            h = _downsample(backbone, entry, h, dtype)
            continue
        _, feat_idx, _, n_blocks = entry
        for j in range(n_blocks):
            scope = f"features_{feat_idx}_block_{j}"
            if gumbel_head is not None and scope == last:
                return fused_block_gumbel_counts(
                    h, prepared[scope], seed=gumbel_head.get("seed", 0),
                    noise=gumbel_head.get("noise"))
            h = fused_block(h, prepared[scope])
    return h
