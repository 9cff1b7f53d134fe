"""Depthwise 7x7 convolution forward (the ConvNeXt block opener), for
``--fused_dwconv``: K7 and its plain version.

Port of count_pipnet_tpu/ops/pallas/dwconv.py (``dwconv7``). Stride 1,
SAME padding (3) on a compact NHWC plane [B, H, W, C] of any H and of W up
to 250 (the CUDA kernel copies each strip of rows with its halo into
shared memory as one TMA box, which reads zeros outside the image; the
TPU's padded-plane layout is not carried). f32 or bf16 input, f32 sums, the output in ``out_dtype``
(default: the input's). The weight is in the port's (torch) layout [C, 1,
7, 7], the bias [C].

:func:`dwconv7` launches the CUDA kernel (ops/cuda/dwconv.cu) for a CUDA
tensor and runs :func:`dwconv7_plain` for a CPU tensor. :func:`tile_plan`
says which halo tile (ops/cuda/block.cuh: ``DwPlan``) a launch of K7 or of
kernel A's prologue takes.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import cuda as _cuda

__all__ = ["dwconv7", "dwconv7_plain", "check_plane", "tile_plan"]

K = 7
PAD = 3


def dwconv7_plain(x, weight, bias, *, out_dtype=None):
    """Plain version of K7: ``F.conv2d(groups=C)`` in f32. On a GPU, set
    ``torch.backends.cudnn.allow_tf32 = False`` first: the conv would
    otherwise run in TF32."""
    c = x.shape[-1]
    y = F.conv2d(x.float().permute(0, 3, 1, 2), weight.float(),
                 bias.float(), padding=PAD, groups=c)
    return y.permute(0, 2, 3, 1).to(out_dtype or x.dtype)


def check_plane(x, what):
    """Raise on a plane the depthwise kernels do not take."""
    if x.dim() != 4:
        raise ValueError(f"{what}: expected a [B, H, W, C] plane, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} takes f32 or bf16 planes, not {x.dtype}")


def tile_plan(prologue, h, w, c, elt, dw_bf16=False, tile=None):
    """The halo tile that a launch on an [., h, w, c] plane of ``elt``-byte
    values takes, as (tr, cs, segs, shared memory bytes): kernel A's
    prologue (``prologue``, ``dw_bf16``: bf16 taps; ``tile`` (tr, cs)) or
    K7 (``tile`` (tr, cs, segs)); ``tile`` None: the chosen one. Raises
    where no tile fits. Needs the kernel library (a CUDA machine)."""
    req = tuple(tile or ())
    plan = (ctypes.c_int * 4)(*req, *(0,) * (4 - len(req)))
    _cuda.library().cpt_dw_plan(int(prologue), h, w, c, elt, int(dw_bf16),
                                plan)
    if plan[0] == 0:
        raise ValueError(f"no halo tile {tile} fits a {h}x{w}x{c} plane of "
                         f"{elt}-byte values "
                         f"({'prologue' if prologue else 'K7'})")
    return tuple(plan)


def dwconv7(x, weight, bias, *, out_dtype=None, tile=None):
    """Depthwise 7x7 + bias on NHWC ``x``. CUDA tensor: K7; CPU tensor:
    the plain version. No autograd: see ops/dwconv_bwd.py. ``tile``: a
    halo tile (tr, cs, segs) in place of the chosen one (the tile
    sweep, scripts/dw_tiles.py); every tile computes the same bits."""
    if x.device.type == "cpu":
        return dwconv7_plain(x, weight, bias, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"dwconv7: unsupported device {x.device}")
    check_plane(x, "dwconv7")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dwconv7 writes f32 or bf16, not {out_dtype}")
    b, h, w, c = x.shape
    if tuple(weight.shape) != (c, 1, K, K) or tuple(bias.shape) != (c,):
        raise ValueError(f"weight {tuple(weight.shape)} / bias "
                         f"{tuple(bias.shape)} are not [C, 1, 7, 7] / [C] "
                         f"for C={c}")
    for t in (weight, bias):
        if t.device != x.device:
            raise ValueError(f"a parameter is on {t.device}, x on {x.device}")
    if c % 8 or w > 250:
        raise ValueError(f"dwconv7 copies the plane as TMA boxes: C must be "
                         f"a multiple of 8 and W at most 250, got C={c}, "
                         f"W={w}")
    xc = x.detach().contiguous()
    if xc.data_ptr() % 16:
        raise ValueError("dwconv7: the plane must start on a 16-byte "
                         "boundary")
    wk = weight.detach().to(torch.float32).contiguous()
    bs = bias.detach().to(torch.float32).contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    bf = torch.bfloat16
    code = _cuda.library().cpt_dwconv7(
        xc.data_ptr(), out.data_ptr(), int(x.dtype == bf),
        int(out_dtype == bf), b, h, w, c, wk.data_ptr(), bs.data_ptr(),
        *(tile or (0, 0, 0)), _cuda.stream_ptr(x.device))
    _cuda.check(code, "dwconv7")
    _cuda.count_launch("dwconv7", c)
    return out
