"""The port's fresh modules take the JAX package's initialisers: the same
small Count-PIPNet is built on both sides and compared tensor by tensor.

* ConvNeXt conv and dense kernels: truncated_normal(0.02), i.e. N(0, 1)
  cut at +-2 times 0.02: |w| <= 0.04, std within 10 % of the JAX tensor's;
* every bias zero, LayerNorms at one, layer scales at 1e-6;
* the add-on 1x1 conv xavier-uniform, the classifier kaiming-uniform
  (a = sqrt(5)): std within 10 % of the JAX tensor's, inside the bound.

Also the stochastic-depth probabilities: ``0.1 * block_id / 17`` over all
18 ConvNeXt-Tiny blocks, whatever ``num_stages`` keeps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from count_pipnet_tpu.models.convnext import ConvNeXtFeatures as JFeatures
from count_pipnet_tpu.models.pipnet import CountPIPNet as JCountPIPNet
from count_pipnet_tpu_torch.models.convert import jax_path
from count_pipnet_tpu_torch.models.convnext import ConvNeXtFeatures
from count_pipnet_tpu_torch.models.pipnet import CountPIPNet

STAGES = ((32, 1), (64, 1), (96, 2), (128, 1))
P, NC = 16, 7


def _models():
    jm = JCountPIPNet(num_classes=NC, num_prototypes=P,
                      backbone=JFeatures(stage_settings=STAGES,
                                         stride_threshold=20),
                      num_features=P)
    params = jax.device_get(jm.init(
        {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 64, 3)))["params"])
    torch.manual_seed(0)
    tm = CountPIPNet(num_classes=NC, num_prototypes=P,
                     backbone=ConvNeXtFeatures(STAGES, 20, 7),
                     num_features=P)
    return params, tm


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def test_init_matches_jax_initialisers():
    params, tm = _models()
    kinds = set()
    for name, p in tm.named_parameters():
        w = p.detach().numpy()
        ref = _leaf(params, jax_path(name))
        assert w.size == ref.size, name
        if name.endswith("layer_scale"):
            np.testing.assert_array_equal(w.reshape(-1), ref)
            np.testing.assert_array_equal(w, np.float32(1e-6))
            kinds.add("layer_scale")
        elif name.endswith("bias"):
            np.testing.assert_array_equal(w, 0.0, err_msg=name)
            kinds.add("bias")
        elif ref.ndim == 1:  # LayerNorm scale
            np.testing.assert_array_equal(w, 1.0, err_msg=name)
            kinds.add("ln")
        else:
            assert abs(w.std() / ref.std() - 1) < 0.10, name
            if name.startswith("backbone"):
                bound = 0.04                      # truncated at 2 x 0.02
                kinds.add("trunc_normal")
            elif name.startswith("add_on"):
                bound = np.sqrt(6.0 / (w.shape[0] + w.shape[1]))  # xavier
                kinds.add(name)
            else:
                bound = 1.0 / np.sqrt(w.shape[1])  # kaiming, a = sqrt(5)
                kinds.add(name)
            assert np.abs(w).max() <= bound, name
            assert np.abs(ref).max() <= bound * (1 + 1e-6), name
    assert kinds == {"layer_scale", "bias", "ln", "trunc_normal",
                     "add_on.conv1x1.weight", "classification.weight"}


def test_stochastic_depth_probabilities():
    with torch.device("meta"):  # structure only, no weights to draw
        nets = {n: ConvNeXtFeatures(num_stages=n) for n in (1, 3, 7)}
    for fe in nets.values():
        probs = [b.sd_prob for b in fe.blocks()]
        assert probs == pytest.approx([0.1 * i / 17
                                       for i in range(len(probs))])
    assert [len(fe.blocks()) for fe in nets.values()] == [3, 6, 18]
