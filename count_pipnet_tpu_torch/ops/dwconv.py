"""Depthwise 7x7 convolution forward (the ConvNeXt block opener), for
``--fused_dwconv``: K7 and its plain version.

Port of count_pipnet_tpu/ops/pallas/dwconv.py (``dwconv7``). Stride 1,
SAME padding (3) on a compact NHWC plane [B, H, W, C] of any H and W (the
CUDA kernel handles the halo with bounds checks; the TPU's padded-plane
layout is not carried). f32 or bf16 input, f32 sums, the output in
``out_dtype`` (default: the input's). The weight is in the port's (torch)
layout [C, 1, 7, 7], the bias [C].

:func:`dwconv7` launches the CUDA kernel (ops/cuda/dwconv.cu) for a CUDA
tensor and runs :func:`dwconv7_plain` for a CPU tensor.
"""

import torch
import torch.nn.functional as F

from . import cuda as _cuda

__all__ = ["dwconv7", "dwconv7_plain", "check_plane"]

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


def dwconv7(x, weight, bias, *, out_dtype=None):
    """Depthwise 7x7 + bias on NHWC ``x``. CUDA tensor: K7; CPU tensor:
    the plain version. No autograd: see ops/dwconv_bwd.py."""
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
    xc = x.detach().contiguous()
    wk = weight.detach().to(torch.float32).contiguous()
    bs = bias.detach().to(torch.float32).contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    bf = torch.bfloat16
    code = _cuda.library().cpt_dwconv7(
        xc.data_ptr(), out.data_ptr(), int(x.dtype == bf),
        int(out_dtype == bf), b, h, w, c, wk.data_ptr(), bs.data_ptr(),
        _cuda.stream_ptr(x.device))
    _cuda.check(code, "dwconv7")
    _cuda.count_launch("dwconv7", c)
    return out
