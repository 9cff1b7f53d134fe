"""Intermediate layers mapping clamped counts to the classifier input.

Port of count_pipnet_tpu/models/intermediates.py (reference
pipnet/count_pipnet_utils.py:86-538): ``onehot`` (the default, STE-backed),
``linear`` (a ramp shared by the prototypes), ``linear_full`` (a full
matrix with a structured init), ``bilinear`` and ``identity``, with the
JAX package's inits and parameter names (``models/convert.py`` maps them).

Each module has ``classifier_input_weight_matrix()``: the
[num_prototypes, classifier_input_dim] attribution of each prototype to
the classifier inputs, from the module's own parameters (virtual weights,
``models/pipnet.py:importance_per_class``).
"""

import numpy as np
import torch
import torch.nn as nn

from ..ops.ste import create_modified_encoding, modified_onehot_ste

__all__ = ["OneHotIntermediate", "LinearIntermediate",
           "LinearFullIntermediate", "BilinearIntermediate",
           "IdentityIntermediate", "make_intermediate"]


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


class LinearIntermediate(nn.Module):
    """A [1 -> max_count] ramp shared by the prototypes: [B, P] ->
    [B, P * max_count] with ``out[b, p * M + i] = x[b, p] * ramp[i]``.
    Init ``ramp[i] = (i + 1) / max_count``."""

    def __init__(self, num_prototypes: int, max_count: int):
        super().__init__()
        self.num_prototypes = num_prototypes
        self.max_count = max_count
        self.ramp = nn.Parameter(
            torch.arange(1, max_count + 1, dtype=torch.float32) / max_count)

    @property
    def output_dim(self):
        return self.num_prototypes * self.max_count

    def forward(self, x):
        return (x[:, :, None] * self.ramp[None, None, :]).reshape(
            x.shape[0], -1)

    def classifier_input_weight_matrix(self):
        eye = torch.eye(self.num_prototypes)
        return eye.repeat_interleave(self.max_count, dim=1) \
            * self.ramp.detach().cpu().repeat(self.num_prototypes)[None, :]


def _linear_full_init(num_prototypes, max_count):
    """Primary weight c + 1 on the own prototype, weak 0.1 (c + 1) / P cross
    terms (reference count_pipnet_utils.py:409-427): [P * M, P]."""
    w = np.zeros((num_prototypes * max_count, num_prototypes), np.float32)
    for p in range(num_prototypes):
        for c in range(max_count):
            w[p * max_count + c, :] = 0.1 * (c + 1) / num_prototypes
            w[p * max_count + c, p] = c + 1
    return torch.from_numpy(w)


class LinearFullIntermediate(nn.Module):
    """A full [P -> P * M] linear map, ``x @ weight.T`` with ``weight``
    [P * M, P] (no bias), structured init."""

    def __init__(self, num_prototypes: int, max_count: int):
        super().__init__()
        self.num_prototypes = num_prototypes
        self.max_count = max_count
        self.weight = nn.Parameter(_linear_full_init(num_prototypes,
                                                     max_count))

    @property
    def output_dim(self):
        return self.num_prototypes * self.max_count

    def forward(self, x):
        return x @ self.weight.t()

    def classifier_input_weight_matrix(self):
        return self.weight.detach().cpu().t()  # [P, P * M]


def _bilinear_embed_init(num_prototypes, max_count):
    """Prototype p maps to max_count consecutive dims scaled by the count
    value (reference count_pipnet_utils.py:349-358): [P * M, P]."""
    w = np.zeros((num_prototypes * max_count, num_prototypes), np.float32)
    for p in range(num_prototypes):
        for c in range(max_count):
            w[p * max_count + c, p] = c + 1
    return torch.from_numpy(w)


class BilinearIntermediate(nn.Module):
    """``e = x @ embed.T``, then ``W(e) * V(e)`` with two bias-free [D, D]
    linear maps (D = P * M) at PyTorch's ``nn.Linear`` init, as the JAX
    package initialises them (reference count_pipnet_utils.py:323-385)."""

    def __init__(self, num_prototypes: int, max_count: int):
        super().__init__()
        self.num_prototypes = num_prototypes
        self.max_count = max_count
        d = num_prototypes * max_count
        self.embed = nn.Parameter(_bilinear_embed_init(num_prototypes,
                                                       max_count))
        self.W = nn.Linear(d, d, bias=False)
        self.V = nn.Linear(d, d, bias=False)

    @property
    def output_dim(self):
        return self.num_prototypes * self.max_count

    def forward(self, x):
        e = x @ self.embed.t()
        return self.W(e) * self.V(e)

    def classifier_input_weight_matrix(self):
        """[P, D]: row p is the output for a unit count of prototype p
        alone, ``W(e_p) * V(e_p)`` with ``e_p = embed[:, p]``."""
        e = self.embed.detach().cpu().t()
        return (e @ self.W.weight.detach().cpu().t()) \
            * (e @ self.V.weight.detach().cpu().t())


class IdentityIntermediate(nn.Module):
    """Pass-through; the classifier input dim is num_prototypes."""

    def __init__(self, num_prototypes: int, max_count: int = 0):
        super().__init__()
        self.num_prototypes = num_prototypes
        self.max_count = max_count

    @property
    def output_dim(self):
        return self.num_prototypes

    def forward(self, x):
        return x

    def classifier_input_weight_matrix(self):
        return torch.eye(self.num_prototypes)


_INTERMEDIATES = {
    "onehot": OneHotIntermediate,
    "linear": LinearIntermediate,
    "linear_full": LinearFullIntermediate,
    "bilinear": BilinearIntermediate,
    "identity": IdentityIntermediate,
}


def make_intermediate(kind: str, num_prototypes: int, max_count: int,
                      use_ste: bool = True, positive_grad_strategy=None,
                      respect_active_grad: bool = False):
    """Intermediate-layer factory (reference count_pipnet.py:392-417)."""
    if kind not in _INTERMEDIATES:
        raise ValueError(f"Unknown intermediate layer type: {kind} (choose "
                         f"from {sorted(_INTERMEDIATES)})")
    if kind == "onehot":
        return OneHotIntermediate(
            num_prototypes, max_count, use_ste=use_ste,
            respect_active_grad=respect_active_grad,
            positive_grad_strategy=positive_grad_strategy)
    return _INTERMEDIATES[kind](num_prototypes, max_count)
