"""Intermediate layers mapping clamped counts to the classifier input.

Port of count_pipnet_tpu/models/intermediates.py (reference
pipnet/count_pipnet_utils.py:86-538). This slice carries the default
``onehot`` layer; the other four variants are ROADMAP Queue 1 work.
"""

import torch
import torch.nn as nn

from ..ops.ste import create_modified_encoding, modified_onehot_ste

__all__ = ["OneHotIntermediate", "make_intermediate"]

_NOT_PORTED = ("linear", "linear_full", "bilinear", "identity")


class OneHotIntermediate(nn.Module):
    """Counts -> modified one-hot (0 -> zeros, k -> e_{k-1}), flattened to
    [B, P * max_count]. Parameter-free."""

    def __init__(self, num_prototypes: int, max_count: int,
                 use_ste: bool = True, respect_active_grad: bool = False,
                 positive_grad_strategy=None):
        super().__init__()
        self.num_prototypes = num_prototypes
        self.max_count = max_count
        self.use_ste = use_ste
        self.respect_active_grad = respect_active_grad
        self.positive_grad_strategy = positive_grad_strategy

    @property
    def output_dim(self):
        return self.num_prototypes * self.max_count

    def forward(self, x):
        if self.use_ste:
            enc = modified_onehot_ste(x, self.max_count,
                                      self.respect_active_grad,
                                      self.positive_grad_strategy)
        else:
            enc = create_modified_encoding(x, self.max_count)
        return enc.reshape(enc.shape[0], -1)

    def classifier_input_weight_matrix(self):
        """[P, P * max_count] block indicator: prototype p owns classifier
        inputs [p * M, (p + 1) * M)."""
        eye = torch.eye(self.num_prototypes)
        return eye.repeat_interleave(self.max_count, dim=1)


def make_intermediate(kind: str, num_prototypes: int, max_count: int,
                      use_ste: bool = True, positive_grad_strategy=None,
                      respect_active_grad: bool = False):
    """Intermediate-layer factory (reference count_pipnet.py:392-417)."""
    if kind == "onehot":
        return OneHotIntermediate(
            num_prototypes, max_count, use_ste=use_ste,
            respect_active_grad=respect_active_grad,
            positive_grad_strategy=positive_grad_strategy)
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"intermediate layer {kind!r} is not ported to PyTorch yet "
            f"(ROADMAP Queue 1: the other four intermediates)")
    raise ValueError(f"Unknown intermediate layer type: {kind} (choose "
                     f"from {sorted(('onehot',) + _NOT_PORTED)})")
