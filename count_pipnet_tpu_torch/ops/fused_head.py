"""The softmax counting head of Count-PIPNet's serving path: K9 and its
plain version.

    counts[b, p] = sum_patch softmax_p(features[b, patch, :] . w[p, :] + b[p])

Port of count_pipnet_tpu/ops/pallas/fused_head.py (``fused_count_head``
and its ``fused_count_head_reference``): the add-on 1x1 conv, the
per-patch softmax over the prototypes and the spatial sum in one kernel
(ops/cuda/fused_head.cu), so the [B, H, W, P] prototype maps are never
stored. Logits, softmax and sums are f32, as on the TPU. The weight is in
the port's layout, the 1x1 conv's ``[P, C]`` (or ``[P, C, 1, 1]``).

A CUDA tensor goes to the kernel, a CPU tensor to
:func:`fused_count_head_plain`.
"""

import torch

from . import cuda as _cuda

__all__ = ["fused_count_head", "fused_count_head_plain"]

ROWS = 32      # patch rows per CTA (ops/cuda/fused_head.cu: kHeadRows)
MAX_P = 1024   # the [32, P] f32 logits tile lives in shared memory


def fused_count_head_plain(features, weight, bias):
    """Plain version of K9: [B, H, W, C] -> [B, P] f32 counts."""
    b, h, w, c = features.shape
    x = features.reshape(b, h * w, c).to(torch.float32)
    wt = weight.reshape(-1, c).to(torch.float32)
    logits = x @ wt.t() + bias.to(torch.float32)
    return torch.softmax(logits, dim=-1).sum(dim=1)


def fused_count_head(features, weight, bias):
    """Counts [B, P] (f32) from features [B, H, W, C] (f32 or bf16), the
    add-on weight [P, C] and bias [P]. CUDA tensor: K9 (``C % 32 == 0``,
    ``P <= 1024``); CPU tensor: the plain version."""
    if features.device.type == "cpu":
        return fused_count_head_plain(features, weight, bias)
    if features.device.type != "cuda":
        raise ValueError(f"fused_count_head: unsupported device "
                         f"{features.device}")
    if features.dim() != 4 or features.dtype not in (torch.float32,
                                                     torch.bfloat16):
        raise ValueError(f"fused_count_head takes f32 or bf16 [B, H, W, C] "
                         f"features, got {features.dtype} "
                         f"{tuple(features.shape)}")
    b, h, w, c = features.shape
    wt = weight.detach().reshape(-1, c).to(torch.float32).contiguous()
    p = wt.shape[0]
    bf = bias.detach().reshape(-1).to(torch.float32).contiguous()
    if c % 32 or p > MAX_P or bf.numel() != p:
        raise ValueError(f"fused_count_head needs C % 32 == 0, P <= {MAX_P} "
                         f"and a [P] bias; got C={c}, P={p}, bias "
                         f"{tuple(bias.shape)}")
    for t in (wt, bf):
        if t.device != features.device:
            raise ValueError(f"a weight is on {t.device}, features on "
                             f"{features.device}")
    x = features.contiguous()
    tiles = -(-(h * w) // ROWS)
    part = torch.empty(b, tiles, p, dtype=torch.float32, device=x.device)
    counts = torch.empty(b, p, dtype=torch.float32, device=x.device)
    ptr = _cuda.ptr
    code = _cuda.library().cpt_fused_count_head(
        ptr(x), int(x.dtype == torch.bfloat16), ptr(wt), ptr(bf), ptr(part),
        ptr(counts), b, h * w, c, p, _cuda.stream_ptr(x.device))
    _cuda.check(code, "fused_count_head")
    _cuda.count_launch("fused_count_head", c)
    return counts
