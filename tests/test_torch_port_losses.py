"""The port's losses (count_pipnet_tpu_torch/ops/losses.py) against the
JAX package's ops/losses.py: the combined loss, accuracy and components of
every phase, and their gradients with respect to the prototype maps, the
counts and the logits (the align loss's targets are stop-gradient on both
sides). Inputs from numpy seeds; tolerance 1e-5 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.ops import losses as jl
from count_pipnet_tpu_torch.ops import losses as tl

B, H, W, P, C = 4, 3, 3, 6, 5


def _inputs(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(2 * B, H, W, P))
    proto = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    pooled = rng.uniform(0.0, 4.0, size=(2 * B, P))
    out = rng.uniform(0.0, 3.0, size=(2 * B, C))
    ys = rng.integers(0, C, size=B)
    return (proto.astype(np.float32), pooled.astype(np.float32),
            out.astype(np.float32), ys)


# (align_w, tanh_w, class_w, pretrain, finetune)
PHASES = {"pretrain": (0.5, 5.0, 0.0, 1.0, 0.0),
          "finetune": (5.0, 2.0, 2.0, 0.0, 1.0),
          "main": (5.0, 2.0, 2.0, 0.0, 0.0)}


@pytest.mark.parametrize("phase", list(PHASES))
@pytest.mark.parametrize("enforce,weighted", [(True, False), (False, False),
                                              (True, True)])
def test_calculate_loss_and_grads_match_jax(phase, enforce, weighted):
    proto, pooled, out, ys = _inputs(7)
    cw = np.linspace(0.5, 1.5, C).astype(np.float32) if weighted else None
    kw = dict(is_count_pipnet=True, enforce_weight_sparsity=enforce,
              tanh_loss_coeff=0.1)

    def jf(pf, po, o):
        loss, acc, comps = jl.calculate_loss(
            pf, po, o, jnp.asarray(ys), *PHASES[phase][:3], 2.0,
            *PHASES[phase][3:], class_weights=None if cw is None
            else jnp.asarray(cw), **kw)
        return loss, (acc, comps)

    (loss_j, (acc_j, comps_j)), grads_j = jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True)(proto, pooled, out)
    tp, tpo, to = (torch.from_numpy(a).requires_grad_(True)
                   for a in (proto, pooled, out))
    loss_t, acc_t, comps_t = tl.calculate_loss(
        tp, tpo, to, torch.from_numpy(ys), *PHASES[phase][:3],
        torch.tensor(2.0), *PHASES[phase][3:],
        class_weights=None if cw is None else torch.from_numpy(cw), **kw)
    loss_t.backward()
    comps_t = {k: v.detach() for k, v in comps_t.items()}
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(acc_t.item(), float(acc_j), rtol=1e-6)
    for k, v in comps_j.items():
        np.testing.assert_allclose(comps_t[k].item(), float(v), rtol=1e-5,
                                   err_msg=k)
    for t, g in zip((tp, tpo, to), grads_j):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max())
