"""Gumbel-hard prototype counting: kernels B and C and their plain versions.

Count-PIPNet's inference head with ``gumbel_softmax(hard=True)`` is

    counts[b, p] = #patches where argmax(logits[b, patch, :] + gumbel) == p

(the temperature cancels inside the argmax). Port of
count_pipnet_tpu/ops/pallas/gumbel_head.py:

* :func:`gumbel_hard_counts` — the standalone head (kernel B,
  ops/cuda/gumbel_head.cu);
* :func:`fused_block_gumbel_counts` — the last ConvNeXt block and the head
  (kernel C), so the last feature plane is never stored.

Kernel C is four launches (ops/cuda/gumbel_head.cu): kernel A's prologue
and GEMM 1 (ops/fused_block.py: :func:`block_prologue`,
:func:`block_up`), GEMM 2 with the head in its epilogue, which leaves each
row's argmax as one 64-bit key (:func:`block_head_keys`), and a count
kernel that turns the keys into counts (:func:`counts_from_keys`). Its
plain version :func:`fused_block_gumbel_counts_plain` takes the argmax of
the block's f32 output; the stages' plain versions
(:func:`block_head_keys_plain`, :func:`counts_from_keys_plain`) compute
the kernels' bits and compose to the same counts. :func:`block_down_f32`
is GEMM 2 with that f32 output stored, the plane the head's argmax sees,
for the checks. The stage wrappers count no launch; a call of
:func:`fused_block_gumbel_counts` counts one.

Noise: the TPU kernels draw from the TPU's on-core PRNG; the port draws
Philox4x32-10 keyed by ``seed`` with counter (channel // 4, patch, image),
the uniform made from the top 24 bits as on the TPU. :func:`gumbel_noise`
is the same draw in plain PyTorch, so the plain versions and the kernels
see the same noise for the same seed. Either takes injected ``noise``
instead (the parity checks against the JAX package).
"""

import torch

from . import cuda as _cuda
from .fused_block import _block_down_f32, _mode, _operand_dtype, \
    block_args, block_residual_plain, check_block_inputs
from .fused_mlp import _aligned
from .fused_mlp_bwd import _rows

__all__ = ["philox4x32_10", "gumbel_noise", "gumbel_hard_counts",
           "gumbel_hard_counts_plain", "fused_block_gumbel_counts",
           "fused_block_gumbel_counts_plain", "block_head_keys",
           "block_head_keys_plain", "counts_from_keys",
           "counts_from_keys_plain", "block_down_f32",
           "block_down_f32_plain"]

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


def _kernel_c_mode(pb, what):
    if pb["dynamic"]:
        raise ValueError(f"{what}: kernel C carries the bf16 and int8-static "
                         f"modes, not the dynamic per-row int8 mode")


def fused_block_gumbel_counts(x, pb, seed: int = 0, noise=None,
                              eps: float = 1e-6):
    """Last ConvNeXt block + gumbel-hard head: NHWC ``x`` [B, H, W, C] and
    weights from :func:`ops.fused_block.prepare_block` -> [B, C] f32
    counts. CUDA tensor: kernel C, which carries the bf16 and int8-static
    modes as the TPU's fused head does; CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return fused_block_gumbel_counts_plain(x, pb, seed, noise, eps)
    _kernel_c_mode(pb, "fused_block_gumbel_counts")
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_gumbel_counts: unsupported device "
                         f"{x.device}")
    check_block_inputs(x, pb)
    _aligned(x, "fused_block_gumbel_counts: the plane")
    b, h, w, c = x.shape
    r = b * h * w
    nz = _noise_arg(noise, b, h * w, c, x.device)
    # the launches' scratch: GEMM 1's and GEMM 2's operands, the rows' keys
    n = torch.empty(r, c, dtype=_operand_dtype(pb), device=x.device)
    hid = torch.empty(r, 4 * c, dtype=n.dtype, device=x.device)
    keys = torch.empty(r, dtype=torch.int64, device=x.device)
    counts = torch.empty(b, c, dtype=torch.float32, device=x.device)
    code = _cuda.library().cpt_fused_block_gumbel_counts(
        x.data_ptr(), *block_args(x, pb), float(eps), _cuda.ptr(nz),
        counts.data_ptr(), int(seed) & (2**64 - 1), n.data_ptr(),
        hid.data_ptr(), keys.data_ptr(), _cuda.stream_ptr(x.device))
    _cuda.check(code, "fused_block_gumbel_counts")
    _cuda.count_launch("fused_block_gumbel_counts", c)
    return counts


_SIGN = -(1 << 63)  # the top bit of an int64


def block_head_keys_plain(res, noise):
    """Plain version of kernel C's head GEMM from the block's f32 output
    ``res`` [..., C]: each row's argmax of ``res + noise`` (``noise``: the
    same values in any shape) as the 64-bit key of ops/cuda/common.cuh:
    argmax_key, int64 [...] holding the unsigned word's bits: the high word
    the value's bits mapped so that unsigned order is float order (-0 as
    +0), the low word 0xFFFFFFFF - channel, the row's largest key in
    unsigned order. NaN is key 0 and never wins; a row of NaN gives 0
    (torch.argmax would take its first NaN)."""
    v = res.float() + noise.reshape(res.shape).float()
    c = v.shape[-1]
    u = v.contiguous().view(torch.int32).to(torch.int64) & _MASK
    u = torch.where(u == 0x80000000, 0, u)
    hi = torch.where(u >= 0x80000000, u ^ _MASK, u | 0x80000000)
    lo = _MASK - torch.arange(c, dtype=torch.int64, device=v.device)
    # the key less 2^63, which orders as a signed int64 as the key does
    # unsigned; NaN at the bottom
    signed = (hi - (1 << 31)) * (1 << 32) + lo
    signed = torch.where(torch.isnan(v), _SIGN, signed)
    return signed.amax(dim=-1) ^ _SIGN


def counts_from_keys_plain(keys, b: int, hw: int, c: int):
    """Plain version of kernel C's count kernel: ``keys`` (``b`` images of
    ``hw`` rows) -> [b, c] f32 counts of the channels they name; a key 0
    (a row of NaN) counts nowhere."""
    k = keys.reshape(b, hw)
    ch = _MASK - (k & _MASK)
    ok = (k != 0) & (ch < c)
    counts = torch.zeros(b, c, dtype=torch.float32, device=keys.device)
    return counts.scatter_add_(1, torch.where(ok, ch, 0), ok.float())


def block_down_f32_plain(h, x, pb):
    """GEMM 2 of the block on the hidden operand ``h`` and its epilogue,
    the f32 block output ``x + (sum * s2 + b2) * g`` (int8: exact sums;
    bf16: ``s2`` = 1), before any cast to ``x.dtype``."""
    return _block_down_f32(h, x, pb)


def _head_operands(h, x, pb, what):
    """Kernel C's GEMM 2 operands checked: (hidden [R, 4C], plane)."""
    _kernel_c_mode(pb, what)
    c = x.shape[-1]
    if h.shape[-1] != 4 * c or h.numel() // (4 * c) != x.numel() // c:
        raise ValueError(f"{what}: hidden {tuple(h.shape)} for a plane "
                         f"{tuple(x.shape)}: expected one row of 4C per "
                         f"plane row")
    if h.dtype != _operand_dtype(pb):
        raise TypeError(f"{what}: the hidden operand is {h.dtype}, the "
                        f"mode's operand {_operand_dtype(pb)}")
    check_block_inputs(x, pb)
    hf = _rows(h, 4 * c, f"{what}: the hidden operand", tma=True,
               dtypes=(h.dtype,))
    return hf, _aligned(x, f"{what}: the plane")


def block_head_keys(h, x, pb, seed: int = 0, noise=None, tile: int = 0):
    """Kernel C's GEMM 2 with the head epilogue alone (CUDA): hidden ``h``
    [B, H, W, 4C] (bf16 or int8, as :func:`ops.fused_block.block_up`
    gives it) and the plane ``x`` [B, H, W, C] -> each row's argmax key of
    the block output plus the noise, int64 [B, H, W]; or
    :func:`block_head_keys_plain` of :func:`block_down_f32_plain` (CPU).
    ``tile``: 0 the tile kernel C takes, 1-5 the candidates
    (ops/cuda/block.cuh: gemm_tiled)."""
    _kernel_c_mode(pb, "block_head_keys")
    b, hh, w, c = x.shape
    if x.device.type == "cpu":
        nz = _noise_for(noise, seed, b, hh * w, c, x.device)
        return block_head_keys_plain(block_down_f32_plain(h, x, pb), nz)
    hf, x = _head_operands(h, x, pb, "block_head_keys")
    nz = _noise_arg(noise, b, hh * w, c, x.device)
    keys = torch.zeros(b, hh, w, dtype=torch.int64, device=x.device)
    p = _cuda.ptr
    code = _cuda.library().cpt_block_head_keys(
        p(hf), p(pb["w2"]), p(pb["s2"]), p(pb["b2"]), p(pb["g"]), p(x),
        int(x.dtype == torch.bfloat16), p(nz), p(keys), _mode(pb),
        hf.shape[0], hh * w, c, int(seed) & (2**64 - 1), int(tile),
        _cuda.stream_ptr(x.device))
    _cuda.check(code, "block_head_keys")
    return keys


def counts_from_keys(keys, b: int, hw: int, c: int):
    """Kernel C's count kernel alone (CUDA): ``keys`` of ``b`` images of
    ``hw`` rows -> [b, c] f32 counts; or :func:`counts_from_keys_plain`
    (CPU)."""
    if keys.device.type == "cpu":
        return counts_from_keys_plain(keys, b, hw, c)
    if keys.dtype != torch.int64 or keys.numel() != b * hw:
        raise ValueError(f"counts_from_keys: expected {b * hw} int64 keys, "
                         f"got {tuple(keys.shape)} {keys.dtype}")
    if keys.device.type != "cuda":
        raise ValueError(f"counts_from_keys: unsupported device "
                         f"{keys.device}")
    kf = keys.reshape(-1).contiguous()
    counts = torch.empty(b, c, dtype=torch.float32, device=keys.device)
    code = _cuda.library().cpt_count_keys(
        kf.data_ptr(), counts.data_ptr(), b, hw, c,
        _cuda.stream_ptr(keys.device))
    _cuda.check(code, "counts_from_keys")
    return counts


def block_down_f32(h, x, pb):
    """Kernel C's GEMM 2 with the f32 block output stored (CUDA), the plane
    its head takes the argmax of: [B, H, W, C] f32; or
    :func:`block_down_f32_plain` (CPU)."""
    _kernel_c_mode(pb, "block_down_f32")
    if x.device.type == "cpu":
        return block_down_f32_plain(h, x, pb)
    hf, x = _head_operands(h, x, pb, "block_down_f32")
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    p = _cuda.ptr
    code = _cuda.library().cpt_block_down_f32(
        p(hf), p(pb["w2"]), p(pb["s2"]), p(pb["b2"]), p(pb["g"]), p(x),
        int(x.dtype == torch.bfloat16), p(out), _mode(pb), hf.shape[0],
        x.shape[-1], _cuda.stream_ptr(x.device))
    _cuda.check(code, "block_down_f32")
    return out
