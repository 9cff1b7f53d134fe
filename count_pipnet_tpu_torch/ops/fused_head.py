"""The softmax counting head of Count-PIPNet's serving path: K9 and its
plain versions.

    counts[b, p] = sum_patch softmax_p(features[b, patch, :] . w[p, :] + b[p])

Port of count_pipnet_tpu/ops/pallas/fused_head.py (``fused_count_head``
and its ``fused_count_head_reference``): the add-on 1x1 conv, the
per-patch softmax over the prototypes and the spatial sum, without storing
the [B, H, W, P] prototype maps. The weight is in the port's layout, the
1x1 conv's ``[P, C]`` (or ``[P, C, 1, 1]``).

K9 (ops/cuda/fused_head.cu) computes the logits on the tensor cores from a
split of each operand into two bf16 halves (:func:`prepare_count_head`
splits the weight once, :func:`split_features` f32 features), so that the
counts stay within the head's 1e-4 of f32 logits: a GEMM stores the logits
and the rows' softmax statistics per column tile
(:func:`head_logits_stats`), a row kernel sums the normalized
probabilities per column over 64-row subtiles of one image
(:func:`head_partial_counts`), and a last launch adds each image's partial
rows in order. Each launch has a plain version here, and
:func:`fused_count_head_split_plain` composes them.

A CUDA tensor goes to the kernel, a CPU tensor to
:func:`fused_count_head_plain`.
"""

import torch

from . import cuda as _cuda

__all__ = ["fused_count_head", "fused_count_head_plain", "prepare_count_head",
           "split_features", "split_features_plain", "head_logits_stats",
           "head_logits_plain", "head_row_stats_plain", "head_partial_counts",
           "head_partial_counts_plain", "fused_count_head_split_plain",
           "SUBTILE", "TILE_BN"]

SUBTILE = 64  # rows of a partial row of counts (ops/cuda/fused_head.cu: kSub)
# BN of the GEMM's tiles by ``tile`` (ops/cuda/fused_head.cu: kTileBN); 0
# is K9's
TILE_BN = (256, 128, 128, 256, 64)


def fused_count_head_plain(features, weight, bias, prepared=None):
    """Plain version of K9: [B, H, W, C] -> [B, P] f32 counts, from f32
    logits (``prepared`` is not read)."""
    b, h, w, c = features.shape
    x = features.reshape(b, h * w, c).to(torch.float32)
    wt = weight.reshape(-1, c).to(torch.float32)
    logits = x @ wt.t() + bias.to(torch.float32)
    return torch.softmax(logits, dim=-1).sum(dim=1)


def prepare_count_head(weight, bias):
    """K9's operands, made once: ``{"w": bf16 [Pp, 2C] = [w_hi | w_lo],
    "b": f32 [Pp], "p": P}`` with w_hi = bf16(w), w_lo = bf16(w - w_hi) and
    P padded to Pp, a multiple of 8, by zero rows with a bias of -inf (their
    exp is 0), on ``weight``'s device."""
    w = weight.detach().reshape(weight.shape[0], -1).to(torch.float32)
    p, c = w.shape
    pp = -(-p // 8) * 8
    hi = w.to(torch.bfloat16)
    wcat = torch.zeros(pp, 2 * c, dtype=torch.bfloat16, device=w.device)
    wcat[:p, :c] = hi
    wcat[:p, c:] = (w - hi.float()).to(torch.bfloat16)
    b = torch.full((pp,), float("-inf"), dtype=torch.float32, device=w.device)
    b[:p] = bias.detach().reshape(-1).to(torch.float32)
    return {"w": wcat, "b": b, "p": p}


def split_features_plain(x):
    """f32 ``x`` -> (bf16(x), bf16(x - bf16(x)))."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def head_logits_plain(x, prepared, hi_only=False):
    """The logits K9 computes, [M, Pp] f32: ``x`` [M, C] f32 or bf16 times
    the split weight (bf16 x: x w_hi + x w_lo; f32: x_hi w_hi + x_lo w_hi
    + x_hi w_lo), summed exactly (float64) and rounded once, plus the bias.
    ``hi_only``: the single bf16 product x_hi w_hi that the split
    replaces."""
    c = x.shape[-1]
    wh, wl = (t.double() for t in prepared["w"].split(c, dim=1))
    xh, xl = ((x, None) if x.dtype == torch.bfloat16
              else split_features_plain(x))
    xh = xh.double()
    acc = xh @ wh.t()
    if not hi_only:
        acc = acc + xh @ wl.t()
        if xl is not None:
            acc = acc + xl.double() @ wh.t()
    return acc.float() + prepared["b"]


def head_row_stats_plain(logits, bn=TILE_BN[0]):
    """Plain version of the row statistics of K9's GEMM: ``logits`` [M, Pp]
    -> [M, nt, 2] f32, each row's max and sum of exp(l - max) over each
    ``bn``-column tile."""
    m, pp = logits.shape
    nt = -(-pp // bn)
    t = torch.nn.functional.pad(logits, (0, nt * bn - pp),
                                value=float("-inf")).reshape(m, nt, bn)
    mx = t.amax(dim=-1)
    return torch.stack([mx, torch.exp(t - mx[..., None]).sum(-1)], dim=-1)


def _combine(stats):
    """Each row's max and softmax sum from its tile pairs [M, nt, 2]."""
    mx = stats[..., 0].amax(dim=-1, keepdim=True)
    s = (stats[..., 1] * torch.exp(stats[..., 0] - mx)).sum(-1, keepdim=True)
    return mx, s


def head_partial_counts_plain(logits, stats, b, hw):
    """Plain version of K9's row kernel: each row's probabilities exp(l -
    max) / sum from ``stats`` (:func:`head_row_stats_plain`), summed per
    column over each 64-row subtile of an image -> [B, ceil(HW / 64), Pp]
    f32."""
    mx, s = _combine(stats)
    prob = (torch.exp(logits - mx) / s).reshape(b, hw, -1)
    n64 = -(-hw // SUBTILE)
    prob = torch.nn.functional.pad(prob, (0, 0, 0, n64 * SUBTILE - hw))
    return prob.reshape(b, n64, SUBTILE, -1).sum(2)


def fused_count_head_split_plain(features, prepared, hi_only=False):
    """K9's launches composed in their plain versions: [B, H, W, C] features
    and the operands of :func:`prepare_count_head` -> [B, P] f32 counts.
    ``hi_only``: with the single bf16 product in place of the split."""
    b, h, w, c = features.shape
    logits = head_logits_plain(features.reshape(-1, c), prepared, hi_only)
    part = head_partial_counts_plain(
        logits, head_row_stats_plain(logits), b, h * w)
    return part.sum(1)[:, :prepared["p"]]


# ---- the kernel ----

def _check_features(x, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} takes f32 or bf16 features, got {x.dtype}")
    if x.shape[-1] % 32:
        raise ValueError(f"{what} needs C % 32 == 0, got C={x.shape[-1]}")
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check_prepared(prepared, c, device, what):
    w, bias = prepared["w"], prepared["b"]
    if (w.dtype != torch.bfloat16 or w.dim() != 2 or w.shape[1] != 2 * c
            or w.shape[0] % 8 or bias.shape != (w.shape[0],)):
        raise ValueError(f"{what}: prepared operands w {tuple(w.shape)} "
                         f"{w.dtype}, b {tuple(bias.shape)} do not fit C={c} "
                         f"(prepare_count_head)")
    for t in (w, bias):
        if t.device != device:
            raise ValueError(f"{what}: a weight is on {t.device}, features "
                             f"on {device}")
    return w, bias


def split_features(x):
    """K9's feature split on its own: f32 ``x`` [M, C] -> (x_hi, x_lo) bf16.
    CUDA tensor: the kernel; CPU tensor: :func:`split_features_plain`."""
    if x.device.type == "cpu":
        return split_features_plain(x)
    if x.dtype != torch.float32:
        raise ValueError(f"split_features takes f32, got {x.dtype}")
    x = _check_features(x, "split_features")
    hi = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    lo = torch.empty_like(hi)
    code = _cuda.library().cpt_head_split(
        _cuda.ptr(x), _cuda.ptr(hi), _cuda.ptr(lo), x.numel(),
        _cuda.stream_ptr(x.device))
    _cuda.check(code, "split_features")
    return hi, lo


def head_logits_stats(x, prepared, tile=0):
    """K9's GEMM on its own: features ``x`` [M, C] (f32 or bf16) times the
    split weight of :func:`prepare_count_head`, plus the bias -> (logits
    [M, Pp] f32, stats [M, nt, 2] f32 over BN = ``TILE_BN[tile]`` column
    tiles; ``tile``: 0 K9's, 1-4 a candidate of
    ops/cuda/fused_head.cu:head_gemm). CUDA tensor: the kernel (f32
    features split by :func:`split_features` first); CPU tensor: the plain
    versions."""
    if x.device.type == "cpu":
        logits = head_logits_plain(x, prepared)
        return logits, head_row_stats_plain(logits, TILE_BN[tile])
    x = _check_features(x, "head_logits_stats")
    w, bias = _check_prepared(prepared, x.shape[-1], x.device,
                              "head_logits_stats")
    xh, xl = (x, None) if x.dtype == torch.bfloat16 else split_features(x)
    (m, c), pp = x.shape, w.shape[0]
    logits = torch.empty(m, pp, dtype=torch.float32, device=x.device)
    stats = torch.empty(m, -(-pp // TILE_BN[tile]), 2, dtype=torch.float32,
                        device=x.device)
    p = _cuda.ptr
    code = _cuda.library().cpt_head_gemm(
        p(xh), p(xl), p(w), p(bias), p(stats), p(logits), m, c, pp,
        int(tile), _cuda.stream_ptr(x.device))
    _cuda.check(code, "head_logits_stats")
    return logits, stats


def head_partial_counts(logits, stats, b, hw):
    """K9's row kernel on its own: the ``logits`` [B HW, Pp] and their
    ``stats`` -> [B, ceil(HW / 64), Pp] f32 partial counts. CUDA tensor:
    the kernel; CPU tensor: :func:`head_partial_counts_plain`."""
    if logits.device.type == "cpu":
        return head_partial_counts_plain(logits, stats, b, hw)
    pp = logits.shape[1]
    if (logits.dtype != torch.float32 or stats.dtype != torch.float32
            or logits.shape[0] != b * hw or stats.shape[0] != b * hw):
        raise ValueError(f"head_partial_counts: logits {tuple(logits.shape)}"
                         f" {logits.dtype}, stats {tuple(stats.shape)} "
                         f"{stats.dtype} for B={b}, HW={hw}")
    logits, stats = logits.contiguous(), stats.contiguous()
    part = torch.empty(b, -(-hw // SUBTILE), pp, dtype=torch.float32,
                       device=logits.device)
    code = _cuda.library().cpt_head_rows(
        _cuda.ptr(logits), _cuda.ptr(stats), _cuda.ptr(part), b, hw, pp,
        stats.shape[1], _cuda.stream_ptr(logits.device))
    _cuda.check(code, "head_partial_counts")
    return part


def fused_count_head(features, weight, bias, prepared=None):
    """Counts [B, P] (f32) from features [B, H, W, C] (f32 or bf16), the
    add-on weight [P, C] and bias [P]; ``prepared``: their
    :func:`prepare_count_head` (made here if not given). CUDA tensor: K9
    (``C % 32 == 0``); CPU tensor: the plain version."""
    if features.device.type == "cpu":
        return fused_count_head_plain(features, weight, bias)
    if features.dim() != 4:
        raise ValueError(f"fused_count_head takes [B, H, W, C] features, "
                         f"got {tuple(features.shape)}")
    b, h, w, c = features.shape
    if prepared is None:
        if bias.numel() != weight.shape[0]:
            raise ValueError(f"fused_count_head needs a [P] bias, got "
                             f"{tuple(bias.shape)} for P={weight.shape[0]}")
        prepared = prepare_count_head(weight, bias)
    x = _check_features(features, "fused_count_head")
    wc, bc = _check_prepared(prepared, c, x.device, "fused_count_head")
    m, pp, dev = b * h * w, wc.shape[0], x.device
    f32 = x.dtype == torch.float32
    xhi = torch.empty(m, c, dtype=torch.bfloat16, device=dev) if f32 else None
    xlo = torch.empty_like(xhi) if f32 else None
    stats = torch.empty(m, -(-pp // TILE_BN[0]), 2, dtype=torch.float32,
                        device=dev)
    logits = torch.empty(m, pp, dtype=torch.float32, device=dev)
    part = torch.empty(b, -(-(h * w) // SUBTILE), pp, dtype=torch.float32,
                       device=dev)
    counts = torch.empty(b, pp, dtype=torch.float32, device=dev)
    p = _cuda.ptr
    code = _cuda.library().cpt_fused_count_head(
        p(x), int(not f32), p(wc), p(bc), p(xhi), p(xlo), p(stats),
        p(logits), p(part), p(counts), b, h * w, c, pp,
        _cuda.stream_ptr(dev))
    _cuda.check(code, "fused_count_head")
    _cuda.count_launch("fused_count_head", c)
    return counts if pp == prepared["p"] else counts[:, :prepared["p"]]
