"""Parameter bridge of the port: flax params -> torchvision-named state
dicts (count_pipnet_tpu_torch/models/convert.py), the inverse of
count_pipnet_tpu.models.convnext.convert_torchvision_convnext."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from count_pipnet_tpu.models.convnext import ConvNeXtFeatures as JFeatures
from count_pipnet_tpu.models.convnext import convert_torchvision_convnext
from count_pipnet_tpu.models.pipnet import CountPIPNet as JCountPIPNet
from count_pipnet_tpu_torch.models.convert import (backbone_from_jax_params,
                                                   from_jax_params)
from count_pipnet_tpu_torch.models.convnext import ConvNeXtFeatures
from count_pipnet_tpu_torch.models.pipnet import CountPIPNet
from test_torch_golden import synth_sd

NARROW = ((16, 1), (32, 1), (64, 2), (128, 1))


def test_torchvision_roundtrip_is_exact():
    """synth_sd -> convert_torchvision_convnext -> backbone_from_jax_params
    gives back the torchvision state dict exactly, and it loads strictly
    into the port's ConvNeXtFeatures."""
    sd = synth_sd(np.random.default_rng(0))
    back = backbone_from_jax_params(
        convert_torchvision_convnext(sd, num_stages=7))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    ConvNeXtFeatures().load_state_dict(back, strict=True)


def test_count_pipnet_params_load_strictly():
    """A whole flax CountPIPNet tree (add-on conv included) maps onto the
    port's CountPIPNet module with no missing or extra keys."""
    jb = JFeatures(stage_settings=NARROW, stride_threshold=20, num_stages=5)
    jm = JCountPIPNet(num_classes=5, num_prototypes=8, backbone=jb,
                      num_features=8)
    x = jnp.zeros((1, 32, 32, 3))
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "gumbel": jax.random.PRNGKey(1)}, x)["params"]
    sd = from_jax_params(jax.device_get(params))
    tm = CountPIPNet(num_classes=5, num_prototypes=8,
                     backbone=ConvNeXtFeatures(NARROW, 20, num_stages=5),
                     num_features=8)
    tm.load_state_dict(sd, strict=True)
    k = np.asarray(params["add_on"]["conv1x1"]["kernel"])       # [1,1,C,P]
    np.testing.assert_array_equal(tm.add_on.conv1x1.weight[:, :, 0, 0]
                                  .detach().numpy(), k[0, 0].T)
    np.testing.assert_array_equal(
        tm.classification.weight.detach().numpy(),
        np.asarray(params["classification"]["weight"]))
