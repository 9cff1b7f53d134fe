"""Gumbel-softmax with an explicit ``torch.Generator`` or injected noise.

Port of count_pipnet_tpu/ops/gumbel.py (reference
pipnet/count_pipnet_utils.py:7-38): soft samples in training, hard
(straight-through one-hot) samples at eval. Eval is stochastic, as in the
reference; :func:`hard_deterministic` is the noise-free argmax.
"""

import torch
import torch.nn.functional as F

__all__ = ["gumbel_softmax", "hard_deterministic", "sample_gumbel"]


def sample_gumbel(shape, generator=None, device=None, shard=None):
    """f32 Gumbel(0, 1) noise drawn from ``generator``; with ``shard``
    (parallel/mesh.py: BatchShard) drawn at the world batch's shape, and
    this rank's rows kept."""
    if shard is not None:
        return shard.take(sample_gumbel(shard.world_shape(shape), generator,
                                        device))
    e = torch.empty(shape, dtype=torch.float32, device=device)
    return -e.exponential_(generator=generator).log()


def gumbel_softmax(logits, tau=1.0, hard=False, generator=None, noise=None,
                   dim=-1, shard=None):
    """Sample from the Gumbel-Softmax distribution over ``dim``.

    Args:
      logits: unnormalized log-probabilities.
      tau: temperature.
      hard: straight-through one-hot (forward hard, backward soft).
      generator: ``torch.Generator`` for the noise (ignored with ``noise``).
      noise: optional pre-drawn Gumbel noise of ``logits``' shape.
      shard: a rank's rows of a world batch (see :func:`sample_gumbel`).

    Returns a tensor of ``logits``' shape and dtype.
    """
    if noise is None:
        kw = {} if shard is None else {"shard": shard}
        noise = sample_gumbel(logits.shape, generator, logits.device, **kw)
    y_soft = torch.softmax((logits.float() + noise.float()) / tau, dim=dim)
    if not hard:
        return y_soft.to(logits.dtype)
    index = torch.argmax(y_soft, dim=dim)
    y_hard = F.one_hot(index, logits.shape[dim]).to(y_soft.dtype)
    if dim not in (-1, logits.dim() - 1):
        y_hard = y_hard.movedim(-1, dim)
    y = y_hard + y_soft - y_soft.detach()
    return y.to(logits.dtype)


def hard_deterministic(logits, dim=-1):
    """One-hot argmax without noise (tau -> 0)."""
    index = torch.argmax(logits, dim=dim)
    y = F.one_hot(index, logits.shape[dim]).to(logits.dtype)
    if dim not in (-1, logits.dim() - 1):
        y = y.movedim(-1, dim)
    return y
