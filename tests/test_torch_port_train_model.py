"""The port's Count-PIPNet in train mode against the flax model on the same
parameters, inputs, Gumbel noise and stochastic-depth masks (both injected:
``jax.random.gumbel`` and ``jax.random.bernoulli`` patched to return
them): the forward (soft prototype maps, raw counts, logits) and the
gradients of every parameter, for the eager route and the
``--fused_blocks`` route (JAX on the CPU: XLA body forward, manual
backward; the port: the plain versions of K5 and K6). Small widths; inputs
from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.models.convnext import ConvNeXtFeatures as JFeatures
from count_pipnet_tpu.models.pipnet import CountPIPNet as JCountPIPNet
from count_pipnet_tpu_torch.models.convert import (from_jax_params,
                                                   to_jax_params)
from count_pipnet_tpu_torch.models.convnext import ConvNeXtFeatures
from count_pipnet_tpu_torch.models.pipnet import CountPIPNet

STAGES = ((32, 1), (64, 1), (64, 2), (96, 1))
P, NC, M, B = 8, 5, 3, 2


def _layer_scale(params, value):
    """Layer scales at ``value`` instead of the init's 1e-6, so that every
    block's branch shows in the output and the gradients."""
    bb = dict(params["backbone"])
    for k, v in bb.items():
        if "layer_scale" in v:
            bb[k] = dict(v, layer_scale=np.full_like(v["layer_scale"],
                                                     value))
    return dict(params, backbone=bb)


def _setup(fused):
    jm = JCountPIPNet(
        num_classes=NC, num_prototypes=P, max_count=M,
        backbone=JFeatures(stage_settings=STAGES, stride_threshold=40,
                           fused_mlp=fused),
        num_features=P)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, 64, 64, 3)).astype(np.float32)
    params = jax.device_get(jm.init(
        {"params": jax.random.PRNGKey(3), "gumbel": jax.random.PRNGKey(1)},
        jnp.asarray(x[:1]))["params"])
    params = _layer_scale(params, 0.2)
    tm = CountPIPNet(num_classes=NC, num_prototypes=P, max_count=M,
                     backbone=ConvNeXtFeatures(STAGES, 40, 7,
                                               fused_mlp=fused),
                     num_features=P)
    tm.load_state_dict(from_jax_params(params))
    # spatial size after the stem (16) and downsamples at stride 2, 1, 1
    noise = rng.gumbel(size=(B, 6, 6, P)).astype(np.float32)
    probs = [b.sd_prob for b in tm.backbone.blocks()]
    masks = [(rng.random((B, 1, 1, 1)) < 1 - p) for p in probs]
    masks[2][0] = False  # at least one dropped sample
    masks[2][1] = True
    weights = [rng.normal(size=s).astype(np.float32)
               for s in ((B, 6, 6, P), (B, P), (B, NC))]
    return jm, params, tm, x, noise, masks, weights


def _patch(monkeypatch, noise, masks):
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(noise, dtype))
    queue = list(masks[1:])  # block 0 has no stochastic depth
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(queue.pop(0)))


@pytest.mark.parametrize("fused", [False, True])
def test_train_forward_and_grads_match_flax(monkeypatch, fused):
    """Eager route (erf-GELU, f32 on both sides): forward and gradients to
    1e-4 of each tensor's largest value. Fused route: the JAX XLA body
    also rounds its GEMM results to bf16, the port's plain K5 does not:
    2e-2 (forward) and 3e-2 (gradients); the rounded counts that feed the
    one-hot head must agree exactly on both routes."""
    jm, params, tm, x, noise, masks, wts = _setup(fused)
    _patch(monkeypatch, noise, masks)

    def jloss(p):
        proto, pooled, out = jm.apply({"params": p}, jnp.asarray(x),
                                      train=True, tau=0.7,
                                      rngs={"gumbel": jax.random.PRNGKey(2),
                                            "droppath": jax.random.PRNGKey(4)})
        loss = sum(jnp.sum(a * w) for a, w in zip((proto, pooled, out), wts))
        return loss, (proto, pooled, out)

    (_, outs_j), grads_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    outs_t = tm(torch.from_numpy(x), train=True, tau=0.7,
                noise=torch.from_numpy(noise),
                drop_masks=[torch.from_numpy(m.astype(np.float32))
                            for m in masks])
    sum((a * torch.from_numpy(w)).sum()
        for a, w in zip(outs_t, wts)).backward()
    tol_f, tol_g = (2e-2, 3e-2) if fused else (1e-4, 1e-4)
    np.testing.assert_array_equal(np.round(outs_t[1].detach().numpy()),
                                  np.round(np.asarray(outs_j[1])))
    for a, b in zip(outs_t, outs_j):
        b = np.asarray(b)
        err = np.abs(a.detach().numpy() - b).max() / np.abs(b).max()
        assert err < tol_f
    grads_t = to_jax_params({n: p.grad if p.grad is not None
                             else torch.zeros_like(p)
                             for n, p in tm.named_parameters()})
    flat_j = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    assert len(flat_j) == len(list(tm.parameters()))
    for path, gj in flat_j:
        node = grads_t
        for k in path:
            node = node[k.key]
        gj = np.asarray(gj)
        scale = np.abs(gj).max()
        assert np.abs(node - gj).max() <= tol_g * scale + 1e-12, path


def test_droppath_drops_the_branch():
    """A dropped sample leaves the block as the identity; a kept one scales
    the branch by 1/keep (both routes)."""
    torch.manual_seed(0)
    for fused in (False, True):
        fe = ConvNeXtFeatures(STAGES, 40, 7, fused_mlp=fused)
        blk = fe.blocks()[3]
        with torch.no_grad():
            blk.layer_scale.fill_(0.5)
        x = torch.randn(2, 8, 8, 64).permute(0, 3, 1, 2)
        keep = 1.0 - blk.sd_prob
        mask = torch.tensor([0.0, 1.0]).reshape(2, 1, 1, 1)
        with torch.no_grad():
            out = blk(x, mask)
            full = blk(x)
        torch.testing.assert_close(out[0], x[0])
        torch.testing.assert_close(out[1] - x[1], (full[1] - x[1]) / keep)
