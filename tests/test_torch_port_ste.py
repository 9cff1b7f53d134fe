"""The port's straight-through estimators (count_pipnet_tpu_torch/ops/
ste.py) against the JAX package's custom_vjps: every
``positive_grad_strategy``, ``respect_active_grad`` and
``fixed_zero_grad``, both reference quirks (zero counts get no gradient;
the batch-global ``any_ap`` gate of ``max_grad``), and the gated clamp.
Inputs from numpy seeds; the gradients must be equal."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.ops import ste as jste
from count_pipnet_tpu_torch.ops import ste as tste

M = 3


def _counts(seed):
    """[8, 6] counts with zeros, halves, values above max_count and
    negatives."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.4, 5.0, size=(8, 6)).astype(np.float32)
    c[0, :3] = (0.0, 0.05, 2.5)
    c[1, :3] = (1.0, 3.0, 7.2)
    return c


def _grad_rows(seed, gate):
    """Encoding gradients [8, 6, M]. ``gate`` "on": a nonzero count has an
    all-positive row, so the max_grad gate is on; "off": every row has a
    negative entry; "zero_row": only a zero count's row is all-positive,
    which the gate ignores."""
    rng = np.random.default_rng(seed + 100)
    g = rng.normal(size=(8, 6, M)).astype(np.float32)
    if gate == "on":
        g[2, 1] = np.abs(g[2, 1]) + 0.1   # a nonzero count (see _counts)
    else:
        g[..., 0] = -np.abs(g[..., 0]) - 0.01
    if gate == "zero_row":
        g[0, 0] = np.abs(g[0, 0]) + 0.1   # count 0.0 (see _counts)
    return g


@pytest.mark.parametrize(
    "strategy,respect,fixed,gate",
    list(itertools.product([None, "current_grad", "max_grad"],
                           [False, True], [False, True],
                           ["on", "off", "zero_row"])))
def test_modified_onehot_backward_matches_jax(strategy, respect, fixed, gate):
    counts, g = _counts(1), _grad_rows(1, gate)
    assert counts[2, 1] > 0.5  # the all-positive row has a nonzero count
    _, vjp = jax.vjp(lambda c: jste.modified_onehot_ste(c, M, respect,
                                                        strategy, fixed),
                     jnp.asarray(counts))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    t = torch.from_numpy(counts).requires_grad_(True)
    enc = tste.modified_onehot_ste(t, M, respect, strategy, fixed)
    np.testing.assert_array_equal(
        enc.detach().numpy(),
        np.asarray(jste.modified_onehot_ste(jnp.asarray(counts), M)))
    enc.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(t.grad.numpy(), want)


def test_reference_quirks():
    """Zero counts never get a gradient; under max_grad with the gate on,
    rows with a negative entry get zero."""
    counts, g = _counts(2), _grad_rows(2, "on")
    t = torch.from_numpy(counts).requires_grad_(True)
    tste.modified_onehot_ste(t, M, False, "max_grad").backward(
        torch.from_numpy(g))
    zero = np.round(counts) < 0.1
    assert np.all(t.grad.numpy()[zero] == 0.0)
    has_neg = (g.min(-1) <= 0.0) & ~zero
    assert has_neg.any() and np.all(t.grad.numpy()[has_neg] == 0.0)


@pytest.mark.parametrize("identity", [True, False])
def test_round_and_clamp_backward_match_jax(identity):
    rng = np.random.default_rng(3)
    x = rng.uniform(-2.0, 6.0, size=(5, 7)).astype(np.float32)
    g = rng.normal(size=(5, 7)).astype(np.float32)

    def jf(v):
        return jste.ste_clamp(jste.ste_round(v), 0.0, 3.0, identity)

    out_j, vjp = jax.vjp(jf, jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    out = tste.ste_clamp(tste.ste_round(t), 0.0, 3.0, identity)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(t.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))
    if not identity:  # gated by the in-range mask of the pre-clamp input
        assert (t.grad.numpy() == 0).any()
