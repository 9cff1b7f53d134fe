"""Prototype head: non-negative classifier and add-on layer.

Port of count_pipnet_tpu/models/heads.py (reference pipnet/pipnet.py:54-108,
count_pipnet.py:176-224, 356-381).
"""

import math

import torch
import torch.nn as nn

from ..ops.gumbel import gumbel_softmax

__all__ = ["NonNegLinear", "AddOn"]


class NonNegLinear(nn.Module):
    """``x @ relu(W).T`` with W [out_features, in_features], so prototype
    presence only adds class evidence. Carries the reference's
    ``normalization_multiplier`` (fixed, never trained)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = False):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        bound = 1.0 / math.sqrt(in_features)  # kaiming_uniform(a=sqrt(5))
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features).uniform_(-bound, bound))
        self.normalization_multiplier = nn.Parameter(torch.ones(1),
                                                     requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x):
        y = x @ torch.relu(self.weight).t()
        if self.bias is not None:
            y = y + self.bias
        return y


class AddOn(nn.Module):
    """Optional 1x1 conv (``num_prototypes > 0``; xavier-uniform kernel,
    zero bias, as in the JAX package), then a per-patch softmax or
    Gumbel-softmax over the prototype channels of an NHWC map. Train mode
    gives soft samples, eval hard one-hot samples."""

    def __init__(self, in_channels: int, num_prototypes: int = 0,
                 activation: str = "gumbel_softmax"):
        super().__init__()
        if activation not in ("gumbel_softmax", "softmax"):
            raise ValueError(f"unknown add-on activation {activation!r}")
        self.activation = activation
        self.conv1x1 = (nn.Conv2d(in_channels, num_prototypes, 1)
                        if num_prototypes > 0 else None)
        if self.conv1x1 is not None:
            nn.init.xavier_uniform_(self.conv1x1.weight)
            nn.init.zeros_(self.conv1x1.bias)

    def logits(self, features):
        """[B, H, W, C] -> [B, H, W, P] pre-activation prototype logits."""
        if self.conv1x1 is None:
            return features
        h = self.conv1x1(features.permute(0, 3, 1, 2))
        return h.permute(0, 2, 3, 1)

    def forward(self, features, *, tau=1.0, train: bool = True,
                generator=None, noise=None, shard=None):
        h = self.logits(features)
        if self.activation == "softmax":
            return torch.softmax(h.float(), dim=-1).to(h.dtype)
        return gumbel_softmax(h, tau=tau, hard=not train,
                              generator=generator, noise=noise,
                              shard=shard)
