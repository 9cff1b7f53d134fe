"""Parameter bridge: the JAX package's flax parameter tree -> a PyTorch
state dict.

The inverse of count_pipnet_tpu/models/convnext.py:convert_torchvision_
convnext (:349), extended to the whole Count-PIPNet. Layouts:

    conv kernel   HWIO [kh, kw, in, out] -> OIHW [out, in, kh, kw]
    depthwise     [7, 7, 1, C]           -> [C, 1, 7, 7]
    dense kernel  [in, out]              -> [out, in]
    layer_scale   [C]                    -> [C, 1, 1]

Leaves may be numpy arrays, jax arrays or anything ``np.asarray`` takes;
the result holds float32 CPU tensors. Loading the flax msgpack checkpoint
files themselves is ROADMAP Queue 1 work.
"""

import re

import numpy as np
import torch

__all__ = ["backbone_from_jax_params", "from_jax_params"]

_BLOCK = re.compile(r"features_(\d+)_block_(\d+)$")
_STAGE = re.compile(r"features_(\d+)$")


def _t(v, perm=None):
    a = np.asarray(v, dtype=np.float32)
    if perm is not None:
        a = np.transpose(a, perm)
    return torch.tensor(a)


def _oihw(k):
    return _t(k, (3, 2, 0, 1))


def backbone_from_jax_params(params) -> dict:
    """ConvNeXtFeatures flax params -> torchvision-named state dict
    (``features.*`` keys, no prefix)."""
    sd = {}
    for scope, sub in params.items():
        m = _BLOCK.match(scope)
        if m:
            pre = f"features.{m.group(1)}.{m.group(2)}"
            sd[f"{pre}.block.0.weight"] = _oihw(sub["dwconv"]["kernel"])
            sd[f"{pre}.block.0.bias"] = _t(sub["dwconv"]["bias"])
            sd[f"{pre}.block.2.weight"] = _t(sub["norm"]["scale"])
            sd[f"{pre}.block.2.bias"] = _t(sub["norm"]["bias"])
            sd[f"{pre}.block.3.weight"] = _t(sub["pw1"]["kernel"], (1, 0))
            sd[f"{pre}.block.3.bias"] = _t(sub["pw1"]["bias"])
            sd[f"{pre}.block.5.weight"] = _t(sub["pw2"]["kernel"], (1, 0))
            sd[f"{pre}.block.5.bias"] = _t(sub["pw2"]["bias"])
            sd[f"{pre}.layer_scale"] = _t(sub["layer_scale"]).reshape(
                -1, 1, 1)
            continue
        m = _STAGE.match(scope)
        if not m:
            raise KeyError(f"unexpected ConvNeXt parameter scope {scope!r}")
        i = int(m.group(1))
        conv, norm = (0, 1) if i == 0 else (1, 0)  # stem: conv then norm
        sd[f"features.{i}.{conv}.weight"] = _oihw(sub["conv"]["kernel"])
        sd[f"features.{i}.{conv}.bias"] = _t(sub["conv"]["bias"])
        sd[f"features.{i}.{norm}.weight"] = _t(sub["norm"]["scale"])
        sd[f"features.{i}.{norm}.bias"] = _t(sub["norm"]["bias"])
    return sd


def from_jax_params(params) -> dict:
    """Whole CountPIPNet flax params -> state dict of
    models.pipnet.CountPIPNet (backbone, add-on conv, classifier)."""
    sd = {f"backbone.{k}": v
          for k, v in backbone_from_jax_params(params["backbone"]).items()}
    add_on = params.get("add_on", {})
    if "conv1x1" in add_on:
        sd["add_on.conv1x1.weight"] = _oihw(add_on["conv1x1"]["kernel"])
        sd["add_on.conv1x1.bias"] = _t(add_on["conv1x1"]["bias"])
    clf = params["classification"]
    sd["classification.weight"] = _t(clf["weight"])
    sd["classification.normalization_multiplier"] = _t(
        clf.get("multiplier", np.ones(1, np.float32))).reshape(1)
    if "bias" in clf:
        sd["classification.bias"] = _t(clf["bias"])
    return sd
