"""The port's five intermediate layers (count_pipnet_tpu_torch/models/
intermediates.py) against the flax modules of the JAX package, through the
parameter bridge: forward, ``classifier_input_weight_matrix``, the inits,
and a softmax Count-PIPNet with each layer served by ``make_serving_fn``
against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.models import get_count_network as jax_get_network
from count_pipnet_tpu.models.intermediates import \
    make_intermediate as jax_make_intermediate
from count_pipnet_tpu.models.serving import make_serving_fn as jax_serving
from count_pipnet_tpu_torch.models.convert import (
    from_jax_params, intermediate_from_jax_params, to_jax_params)
from count_pipnet_tpu_torch.models.intermediates import make_intermediate
from count_pipnet_tpu_torch.models.pipnet import get_count_network
from count_pipnet_tpu_torch.models.serving import make_serving_fn

KINDS = ("onehot", "linear", "linear_full", "bilinear", "identity")
P, M = 6, 3


def _counts(seed):
    return np.random.default_rng(seed).integers(0, M + 1, size=(4, P)) \
        .astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_intermediate_matches_flax(kind):
    """Same output (1e-6) and attribution matrix (1e-6) from the bridged
    parameters of a flax init; the port's own init draws the structured
    parameters exactly as flax does (bilinear W/V are random on both
    sides)."""
    x = _counts(1)
    jmod = jax_make_intermediate(kind, P, M, use_ste=True)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0),
                                      jnp.asarray(x))).get("params", {})
    tmod = make_intermediate(kind, P, M, use_ste=True)
    own = {k: v.clone() for k, v in tmod.state_dict().items()}
    sd = intermediate_from_jax_params(params)
    assert set(sd) == set(own)
    for k, v in sd.items():
        if not (kind == "bilinear" and k in ("W.weight", "V.weight")):
            np.testing.assert_array_equal(own[k].numpy(), v.numpy())
    tmod.load_state_dict(sd)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    got = tmod(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (4, tmod.output_dim)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tmod.classifier_input_weight_matrix().numpy(),
        np.asarray(jmod.classifier_input_weight_matrix(params)),
        rtol=1e-6, atol=1e-6)


def test_bilinear_init_is_torch_linear():
    """W and V at nn.Linear's init: U(-1/sqrt(D), 1/sqrt(D))."""
    mod = make_intermediate("bilinear", 16, 4)
    bound = 1.0 / np.sqrt(64)
    for lin in (mod.W, mod.V):
        w = lin.weight.detach()
        assert w.shape == (64, 64) and w.abs().max() <= bound
        assert w.std().item() == pytest.approx(bound / np.sqrt(3), rel=0.1)


class Args:
    net = "convnext_tiny_26"
    num_features = 16
    use_mid_layers = True
    num_stages = 1
    bias = True
    activation = "softmax"
    positive_grad_strategy = None
    backward_clamp_strategy = "Identity"
    disable_pretrained = True


@pytest.mark.parametrize("kind", KINDS)
def test_served_count_pipnet_with_each_intermediate(kind):
    """A softmax Count-PIPNet with the intermediate ``kind`` (and a
    classifier bias): its flax params bridge into the port's model and
    back unchanged, and make_serving_fn gives the JAX make_serving_fn's
    clamped counts exactly and its logits within rtol 1e-3."""
    args = type("A", (Args,), {"intermediate_layer": kind})
    jm, _ = jax_get_network(3, args, max_count=M, use_ste=True)
    x = np.random.default_rng(3).uniform(size=(2, 32, 32, 3)) \
        .astype(np.float32)
    params = jax.device_get(jm.init({"params": jax.random.PRNGKey(4)},
                                    jnp.asarray(x))["params"])
    params["classification"]["bias"] = np.full(3, 0.5, np.float32)
    tm, _ = get_count_network(3, args, max_count=M)
    sd = from_jax_params(params)
    tm.load_state_dict(sd)
    back = to_jax_params(sd)
    for leaf, v in jax.tree_util.tree_leaves_with_path(
            params.get("intermediate", {})):
        node = back["intermediate"]
        for key in leaf:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(v))
    counts_j, out_j = jax_serving(jm, use_pallas=False)(params,
                                                        jnp.asarray(x))
    counts, out = make_serving_fn(tm, device="cpu")(x)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-3,
                               atol=1e-4)
