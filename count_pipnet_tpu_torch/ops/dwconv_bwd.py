"""Gradients of the depthwise 7x7 convolution: K8 (the weight and bias
gradient), its plain version, and the two autograd Functions.

Port of count_pipnet_tpu/ops/pallas/dwconv_bwd.py:

* :func:`dwconv7_wgrad` (``dwconv7_wgrad``, the Pallas kernel; here K8 in
  ops/cuda/dwconv_wgrad.cu): from the conv input ``x`` and the output's
  cotangent ``g`` (both [B, H, W, C]),
  ``dK[c, ky, kx] = sum_{b,y,x} x[b, y+ky-3, x+kx-3, c] * g[b, y, x, c]``
  and ``db = sum g``, in f32, as ([C, 1, 7, 7], [C]); :func:`wgrad_plan`
  says which halo tile a launch of K8 takes;
* :func:`dwconv7_ad` (``dwconv7_ad``): the conv forward and its data
  gradient (the conv of ``g`` with the flipped kernel) through PyTorch's
  conv, the weight gradient through K8; the ``--fused_whole_blocks``
  backward recomputes its depthwise conv through it, in f32;
* :func:`dwconv7_pfwd_ad` (``dwconv7_pfwd_ad``, the ``--fused_dwconv``
  block opener): the forward through K7 (ops/dwconv.py) on ``x`` cast to
  the compute dtype, both gradients from PyTorch's conv autograd.

``dtype`` is the compute dtype (the JAX package's module dtype; the port
passes the autocast dtype). As in the Pallas branch of the JAX package, x
and g are rounded to ``dtype`` before K8's f32 sums; the plain version
sums whatever it is given, so the caller rounds for both alike.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import cuda as _cuda
from .dwconv import K, PAD, check_plane, dwconv7

__all__ = ["dwconv7_wgrad", "dwconv7_wgrad_plain", "wgrad_plan", "dw_conv",
           "dwconv7_ad", "dwconv7_pfwd_ad", "Dwconv7Ad", "Dwconv7PfwdAd"]

_ROWS = K * K + 1   # 49 taps + the bias row


def dw_conv(x, weight, bias, dtype):
    """The depthwise conv as the JAX package's ``_dw_conv`` runs it: NHWC
    ``x`` and the [C, 1, 7, 7] weight cast to ``dtype``, then the bias in
    ``dtype`` added."""
    c = x.shape[-1]
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), weight.to(dtype),
                 padding=PAD, groups=c).permute(0, 2, 3, 1)
    return y + bias.to(dtype)


def dwconv7_wgrad_plain(x, g):
    """Plain version of K8: the tap / row-sum of the JAX package's jnp
    branch (dwconv_bwd.py:153-164), f32 sums of ``x`` and ``g`` as
    given."""
    b, h, w, c = x.shape
    xs = F.pad(x.float(), (0, 0, PAD, PAD, PAD, PAD))
    g32 = g.float()
    taps = [(xs[:, ky:ky + h, kx:kx + w] * g32).sum(dim=(0, 1, 2))
            for ky in range(K) for kx in range(K)]
    dk = torch.stack(taps).t().reshape(c, 1, K, K)
    return dk, g32.sum(dim=(0, 1, 2))


def wgrad_plan(b, h, w, c, elt, tile=None, device=None):
    """The plan that a launch of K8 on [b, h, w, c] planes of ``elt``-byte
    values takes (ops/cuda/dwconv_wgrad.cu: ``WgPlan``), as (tr, cs, segs,
    bufs, ctas, shared memory bytes): image rows a strip, channels a slab,
    pieces a row, tile buffers a CTA, CTAs a slab. ``tile`` (tr, cs, segs,
    bufs, ctas), in part or whole, in place of the chosen one (tr 0: the
    chosen tile; ctas 0: enough CTAs to fill the card). Raises where no
    tile fits. Needs the kernel library and a CUDA card (its SM count)."""
    req = tuple(tile or ())
    plan = (ctypes.c_int * 6)(*req, *(0,) * (6 - len(req)))
    sms = torch.cuda.get_device_properties(
        device or torch.cuda.current_device()).multi_processor_count
    _cuda.library().cpt_dwconv7_wgrad_plan(b, h, w, c, elt, sms, plan)
    if plan[0] == 0:
        raise ValueError(f"no K8 tile {tile} fits {b}x{h}x{w}x{c} planes "
                         f"of {elt}-byte values")
    return tuple(plan)


def dwconv7_wgrad(x, g, *, tile=None):
    """dK [C, 1, 7, 7] and db [C] (f32) of a depthwise 7x7 with input ``x``
    and output cotangent ``g``, [B, H, W, C] each, both f32 or both bf16.
    CUDA tensor: K8; CPU tensor: the plain version. ``tile``: a plan
    (tr, cs, segs, bufs, ctas) in place of the chosen one (the tile sweep,
    scripts/dw_tiles.py); each plan sums in its own order."""
    if x.device.type == "cpu":
        return dwconv7_wgrad_plain(x, g)
    if x.device.type != "cuda":
        raise ValueError(f"dwconv7_wgrad: unsupported device {x.device}")
    check_plane(x, "dwconv7_wgrad")
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} on {g.device} does "
                         f"not match x {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    b, h, w, c = x.shape
    elt = x.element_size()
    if c * elt % 16 or w > 250:
        raise ValueError(f"dwconv7_wgrad copies the planes as TMA boxes: C "
                         f"times the element size must be a multiple of 16 "
                         f"bytes and W at most 250, got C={c} of {elt} "
                         f"bytes, W={w}")
    xc, gc = x.detach().contiguous(), g.detach().contiguous()
    if xc.data_ptr() % 16 or gc.data_ptr() % 16:
        raise ValueError("dwconv7_wgrad: the planes must start on a 16-byte "
                         "boundary")
    tr, cs, segs, bufs, ctas, _ = wgrad_plan(b, h, w, c, elt, tile, x.device)
    part = torch.empty(ctas, _ROWS, c, dtype=torch.float32, device=x.device)
    out = torch.empty(_ROWS, c, dtype=torch.float32, device=x.device)
    code = _cuda.library().cpt_dwconv7_wgrad(
        xc.data_ptr(), gc.data_ptr(), int(x.dtype == torch.bfloat16), b, h,
        w, c, tr, cs, segs, bufs, ctas, part.data_ptr(), out.data_ptr(),
        _cuda.stream_ptr(x.device))
    _cuda.check(code, "dwconv7_wgrad")
    _cuda.count_launch("dwconv7_wgrad", c)
    return out[:K * K].t().reshape(c, 1, K, K), out[K * K]


class Dwconv7Ad(torch.autograd.Function):
    """PyTorch conv forward and data gradient, K8 weight gradient (the JAX
    package's ``dwconv7_ad``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, dtype):
        with torch.autocast(x.device.type, enabled=False):
            y = dw_conv(x, weight, bias, dtype)
        ctx.save_for_backward(x, weight)
        ctx.dtype, ctx.bias_dtype = dtype, bias.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dt, c = ctx.dtype, x.shape[-1]
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        gd = g.to(dt)
        dx = dk = db = None
        with torch.autocast(x.device.type, enabled=False):
            if need_x:
                dx = F.conv2d(gd.permute(0, 3, 1, 2),
                              weight.flip(-2, -1).to(dt), padding=PAD,
                              groups=c).permute(0, 2, 3, 1).to(x.dtype)
            if need_w or need_b:
                dk, db = dwconv7_wgrad(x.to(dt), gd)
                dk = dk.to(weight.dtype) if need_w else None
                db = db.to(ctx.bias_dtype) if need_b else None
        return dx, dk, db, None


class Dwconv7PfwdAd(torch.autograd.Function):
    """K7 forward, PyTorch conv autograd backward (the JAX package's
    ``dwconv7_pfwd_ad``). Only ``x`` and the parameters are saved."""

    @staticmethod
    def forward(ctx, x, weight, bias, dtype):
        with torch.autocast(x.device.type, enabled=False):
            y = dwconv7(x.to(dtype), weight, bias, out_dtype=dtype)
        ctx.save_for_backward(x, weight, bias)
        ctx.dtype = dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, bias = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        ins = [t.detach().requires_grad_(n)
               for t, n in zip((x, weight, bias), need)]
        with torch.enable_grad(), \
                torch.autocast(x.device.type, enabled=False):
            y = dw_conv(*ins, ctx.dtype)
            wanted = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(y, wanted, g.to(ctx.dtype))
                       if wanted else ())
        return tuple(next(got).to(t.dtype) if n else None
                     for t, n in zip(ins, need)) + (None,)


def dwconv7_ad(x, weight, bias, dtype):
    """Differentiable depthwise 7x7 with the K8 weight gradient."""
    return Dwconv7Ad.apply(x, weight, bias, dtype)


def dwconv7_pfwd_ad(x, weight, bias, dtype):
    """Differentiable depthwise 7x7 with the K7 forward."""
    return Dwconv7PfwdAd.apply(x, weight, bias, dtype)
