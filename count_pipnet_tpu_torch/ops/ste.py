"""Forward halves of the Count-PIPNet count straight-through estimators.

Port of count_pipnet_tpu/ops/ste.py (reference
pipnet/count_pipnet_utils.py:41-321) for inference: ``ste_round``,
``ste_clamp`` and ``modified_onehot_ste`` compute their forwards here. Their
custom backwards (identity, gated clamp, "follow the minimum gradient")
come with training as ``torch.autograd.Function``s (ROADMAP Queue 1).
"""

import torch
import torch.nn.functional as F

__all__ = ["ste_round", "ste_clamp", "create_modified_encoding",
           "modified_onehot_ste"]


def ste_round(x):
    """Round half to even (torch.round == jnp.round)."""
    return torch.round(x)


def ste_clamp(x, min_val, max_val, backward_identity=True):
    """Clamp to [min_val, max_val]. ``backward_identity`` selects the
    backward, which is not ported yet."""
    del backward_identity
    return torch.clamp(x, min_val, max_val)


def create_modified_encoding(x, max_count):
    """Counts [B, P] -> modified one-hot [B, P, max_count]: 0 -> zeros,
    k -> e_{k-1}; counts above ``max_count`` map to the last bin, counts
    <= 0.1 to all zeros (reference count_pipnet_utils.py:141-185)."""
    nonzero = (x > 0.1).to(torch.float32)
    idx = torch.clamp(x.to(torch.int64) - 1, 0, max_count - 1)
    return F.one_hot(idx, max_count).to(torch.float32) * nonzero[..., None]


def modified_onehot_ste(counts, max_count, respect_active_grad=False,
                        positive_grad_strategy=None, fixed_zero_grad=False):
    """Forward of the modified one-hot STE: round, then
    :func:`create_modified_encoding`. The backward options are accepted for
    interface parity and take effect once training is ported."""
    del respect_active_grad, positive_grad_strategy, fixed_zero_grad
    return create_modified_encoding(torch.round(counts), max_count)
