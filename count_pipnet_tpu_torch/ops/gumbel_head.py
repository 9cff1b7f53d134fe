"""Gumbel-hard prototype counting: kernels B and C and their plain versions.

Count-PIPNet's inference head with ``gumbel_softmax(hard=True)`` is

    counts[b, p] = #patches where argmax(logits[b, patch, :] + gumbel) == p

(the temperature cancels inside the argmax). Port of
count_pipnet_tpu/ops/pallas/gumbel_head.py:

* :func:`gumbel_hard_counts` — the standalone head (kernel B,
  ops/cuda/gumbel_head.cu);
* :func:`fused_block_gumbel_counts` — the last ConvNeXt block and the head
  in one kernel (kernel C), so the last feature plane is never stored.

Noise: the TPU kernels draw from the TPU's on-core PRNG; the port draws
Philox4x32-10 keyed by ``seed`` with counter (channel // 4, patch, image),
the uniform made from the top 24 bits as on the TPU. :func:`gumbel_noise`
is the same draw in plain PyTorch, so the plain versions and the kernels
see the same noise for the same seed. Either takes injected ``noise``
instead (the parity checks against the JAX package).
"""

import torch

from . import cuda as _cuda
from .fused_block import block_args, block_residual_plain, \
    check_block_inputs

__all__ = ["philox4x32_10", "gumbel_noise", "gumbel_hard_counts",
           "gumbel_hard_counts_plain", "fused_block_gumbel_counts",
           "fused_block_gumbel_counts_plain"]

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b):
    """(hi, lo) 32-bit halves of a * b for a 32-bit constant ``a`` and an
    int64 tensor ``b`` in [0, 2^32), without overflowing int64."""
    x = (a >> 16) * b            # < 2^48
    y = (a & 0xFFFF) * b         # < 2^48
    hi = (x + (y >> 16)) >> 16
    lo = (((x & 0xFFFF) << 16) + y) & _MASK
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, seed: int):
    """Philox4x32-10 on int64 tensors holding 32-bit counters; the mirror of
    ops/cuda/common.cuh:philox4x32_10. Returns the four output words."""
    k0, k1 = seed & _MASK, (seed >> 32) & _MASK
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def gumbel_noise(seed: int, b: int, hw: int, c: int, device=None):
    """[b, hw, c] f32 Gumbel(0, 1) noise, as kernels B and C draw it."""
    if c % 4:
        raise ValueError(f"channels must be a multiple of 4, got {c}")
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    q = ar(c // 4).view(1, 1, -1)
    patch = ar(hw).view(1, -1, 1)
    image = ar(b).view(-1, 1, 1)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    shape = (b, hw, c // 4)
    words = philox4x32_10(q.expand(shape), patch.expand(shape),
                          image.expand(shape), zero.expand(shape), int(seed))
    bits = torch.stack(words, dim=-1).reshape(b, hw, c)
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) + 1e-12
    return -torch.log(-torch.log(u))


def _histogram(res, noise):
    """counts [B, P] of argmax(res + noise) over the last axis of
    [B, HW, P] f32 tensors (ties to the lowest index)."""
    winner = torch.argmax(res + noise, dim=-1)
    counts = torch.zeros(res.shape[0], res.shape[-1], dtype=torch.float32,
                         device=res.device)
    return counts.scatter_add_(1, winner,
                               torch.ones_like(winner, dtype=torch.float32))


def _noise_for(noise, seed, b, hw, c, device):
    if noise is None:
        return gumbel_noise(seed, b, hw, c, device)
    return noise.reshape(b, hw, c).to(torch.float32)


def _noise_arg(noise, b, hw, c, device):
    """Injected noise as the kernels read it: contiguous f32 [b, hw, c] on
    ``device``, 16-byte aligned (one float4 load per channel quad)."""
    if noise is None:
        return None
    nz = noise.reshape(b, hw, c).to(device=device, dtype=torch.float32)
    nz = nz.contiguous()
    return nz if nz.data_ptr() % 16 == 0 else nz.clone()


def gumbel_hard_counts_plain(feats, seed: int = 0, noise=None):
    """Plain version of kernel B: [B, H, W, P] logits -> [B, P] counts."""
    b, h, w, c = feats.shape
    x = feats.reshape(b, h * w, c).to(torch.float32)
    return _histogram(x, _noise_for(noise, seed, b, h * w, c, feats.device))


def gumbel_hard_counts(feats, seed: int = 0, noise=None):
    """[B, H, W, P] logits (f32 or bf16) -> [B, P] f32 gumbel-hard counts.

    ``noise``: optional pre-drawn Gumbel noise of shape [B, H, W, P] or
    [B, H*W, P]; else Philox noise from ``seed``. CUDA tensor: kernel B;
    CPU tensor: :func:`gumbel_hard_counts_plain`.
    """
    if feats.device.type == "cpu":
        return gumbel_hard_counts_plain(feats, seed, noise)
    if feats.device.type != "cuda":
        raise ValueError(f"gumbel_hard_counts: unsupported device "
                         f"{feats.device}")
    b, h, w, c = feats.shape
    if not feats.is_contiguous() or feats.dtype not in (torch.float32,
                                                        torch.bfloat16):
        raise ValueError("gumbel_hard_counts takes a contiguous f32 or bf16 "
                         f"[B, H, W, P] tensor, got {feats.dtype} "
                         f"strides {feats.stride()}")
    if c % 4:
        raise ValueError(f"gumbel_hard_counts needs P % 4 == 0, got {c}")
    nz = _noise_arg(noise, b, h * w, c, feats.device)
    counts = torch.zeros(b, c, dtype=torch.float32, device=feats.device)
    code = _cuda.library().cpt_gumbel_hard_counts(
        feats.data_ptr(), int(feats.dtype == torch.bfloat16), _cuda.ptr(nz),
        counts.data_ptr(), b, h * w, c, int(seed) & (2**64 - 1),
        _cuda.stream_ptr(feats.device))
    _cuda.check(code, "gumbel_hard_counts")
    _cuda.count_launch("gumbel_hard_counts", c)
    return counts


def fused_block_gumbel_counts_plain(x, pb, seed: int = 0, noise=None,
                                    eps: float = 1e-6):
    """Plain version of kernel C: the block's f32 output (not cast to
    ``x.dtype``) goes straight into the histogram."""
    b, h, w, c = x.shape
    res = block_residual_plain(x, pb, eps).reshape(b, h * w, c)
    return _histogram(res, _noise_for(noise, seed, b, h * w, c, x.device))


def fused_block_gumbel_counts(x, pb, seed: int = 0, noise=None,
                              eps: float = 1e-6):
    """Last ConvNeXt block + gumbel-hard head: NHWC ``x`` [B, H, W, C] and
    weights from :func:`ops.fused_block.prepare_block` -> [B, C] f32
    counts. CUDA tensor: kernel C, which carries the bf16 and int8-static
    modes as the TPU's fused head does; CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return fused_block_gumbel_counts_plain(x, pb, seed, noise, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_gumbel_counts: unsupported device "
                         f"{x.device}")
    check_block_inputs(x, pb)
    if pb["dynamic"]:
        raise ValueError("kernel C carries the bf16 and int8-static modes, "
                         "not the dynamic per-row int8 mode")
    b, h, w, c = x.shape
    nz = _noise_arg(noise, b, h * w, c, x.device)
    counts = torch.zeros(b, c, dtype=torch.float32, device=x.device)
    code = _cuda.library().cpt_fused_block_gumbel_counts(
        x.data_ptr(), *block_args(x, pb), float(eps), _cuda.ptr(nz),
        counts.data_ptr(), int(seed) & (2**64 - 1),
        _cuda.stream_ptr(x.device))
    _cuda.check(code, "fused_block_gumbel_counts")
    _cuda.count_launch("fused_block_gumbel_counts", c)
    return counts
