"""Straight-through estimators of the Count-PIPNet count head.

Port of count_pipnet_tpu/ops/ste.py (reference
pipnet/count_pipnet_utils.py:41-321) as ``torch.autograd.Function``s:

* ``ste_round``: round forward (half to even), identity backward;
* ``ste_clamp``: clamp forward; backward identity, or gated by the in-range
  mask of the pre-clamp input;
* ``modified_onehot_ste``: round, then the modified one-hot encoding;
  backward "follow the minimum gradient", with every
  ``positive_grad_strategy`` and ``respect_active_grad``.

The two reference quirks that the JAX package reproduces
(count_pipnet_tpu/ops/ste.py:14-33) are reproduced here too: zero counts
never receive a gradient, and under ``max_grad`` the batch-global gate
``any(all_pos & ~zero)`` gives rows with a negative entry a zero gradient.
``fixed_zero_grad=True`` selects the intended behaviour instead.
"""

import torch
import torch.nn.functional as F

__all__ = ["ste_round", "ste_clamp", "create_modified_encoding",
           "modified_onehot_ste"]


class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _SteClamp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, min_val, max_val, backward_identity):
        ctx.identity = bool(backward_identity)
        ctx.bounds = (min_val, max_val)
        if not ctx.identity:
            ctx.save_for_backward(x)
        return torch.clamp(x, min_val, max_val)

    @staticmethod
    def backward(ctx, g):
        if ctx.identity:
            return g, None, None, None
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        mask = (x >= lo) & (x <= hi)
        return g * mask.to(g.dtype), None, None, None


def ste_round(x):
    """Round half to even (torch.round == jnp.round); gradient passes."""
    return _SteRound.apply(x)


def ste_clamp(x, min_val, max_val, backward_identity=True):
    """Clamp to [min_val, max_val]; backward identity or gated by
    ``(x >= min_val) & (x <= max_val)`` of the pre-clamp ``x``."""
    return _SteClamp.apply(x, min_val, max_val, backward_identity)


def create_modified_encoding(x, max_count):
    """Counts [B, P] -> modified one-hot [B, P, max_count]: 0 -> zeros,
    k -> e_{k-1}; counts above ``max_count`` map to the last bin, counts
    <= 0.1 to all zeros (reference count_pipnet_utils.py:141-185). Not
    differentiable (see :func:`modified_onehot_ste`)."""
    nonzero = (x > 0.1).to(torch.float32)
    idx = torch.clamp(x.to(torch.int64) - 1, 0, max_count - 1)
    return F.one_hot(idx, max_count).to(torch.float32) * nonzero[..., None]


def _monehot_grad(rounded, g, max_count, respect_active_grad,
                  positive_grad_strategy, fixed_zero_grad):
    """Count gradient [B, P] from the encoding's gradient [B, P, M]
    (count_pipnet_tpu/ops/ste.py:_monehot_bwd)."""
    g = g.float()
    cur = torch.clamp(rounded.to(torch.int64) - 1, 0, max_count - 1)
    zero_mask = rounded < 0.1
    min_val, min_idx = g.min(dim=-1)
    all_pos = min_val > 0.0
    g_cur = torch.gather(g, -1, cur[..., None])[..., 0]
    mag = min_val.abs()
    zeros = torch.zeros_like(mag)
    directional = torch.where(min_idx < cur, mag,
                              torch.where(min_idx > cur, -mag, zeros))
    if positive_grad_strategy == "max_grad":
        max_val = g.max(dim=-1).values
        if fixed_zero_grad:
            grad_nz = torch.where(all_pos, max_val, directional)
        else:
            any_ap = torch.any(all_pos & ~zero_mask)
            grad_nz = torch.where(any_ap, torch.where(all_pos, max_val, zeros),
                                  directional)
    else:
        if positive_grad_strategy == "current_grad":
            mag = torch.where(all_pos, g_cur, mag)
        grad_nz = torch.where(min_idx < cur, mag,
                              torch.where(min_idx > cur, -mag, zeros))
    if respect_active_grad:
        grad_nz = torch.where(g_cur < 0.0, zeros, grad_nz)
    if fixed_zero_grad:
        g0 = g[..., 0]
        zero_grad = torch.where(g0 < 0.0, g0, zeros)
    else:
        zero_grad = zeros
    return torch.where(zero_mask, zero_grad, grad_nz)


class _ModifiedOneHot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, counts, max_count, respect_active_grad,
                positive_grad_strategy, fixed_zero_grad):
        rounded = torch.round(counts)
        ctx.save_for_backward(rounded)
        ctx.opts = (max_count, respect_active_grad, positive_grad_strategy,
                    fixed_zero_grad)
        return create_modified_encoding(rounded, max_count)

    @staticmethod
    def backward(ctx, g):
        (rounded,) = ctx.saved_tensors
        grad = _monehot_grad(rounded, g, *ctx.opts)
        return grad.to(rounded.dtype), None, None, None, None


def modified_onehot_ste(counts, max_count, respect_active_grad=False,
                        positive_grad_strategy=None, fixed_zero_grad=False):
    """Round, then :func:`create_modified_encoding`; the backward pushes
    each count toward the bin with the most negative gradient. Returns
    [B, P, max_count] (not flattened)."""
    return _ModifiedOneHot.apply(counts, max_count, respect_active_grad,
                                 positive_grad_strategy, fixed_zero_grad)
