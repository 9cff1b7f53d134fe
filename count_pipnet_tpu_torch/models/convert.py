"""Parameter bridge between the JAX package's flax parameter tree and a
PyTorch state dict, both ways.

The inverse of count_pipnet_tpu/models/convnext.py:convert_torchvision_
convnext (:349), extended to the whole Count-PIPNet. Layouts:

    conv kernel   HWIO [kh, kw, in, out] -> OIHW [out, in, kh, kw]
    depthwise     [7, 7, 1, C]           -> [C, 1, 7, 7]
    dense kernel  [in, out]              -> [out, in]
    layer_scale   [C]                    -> [C, 1, 1]

The same functions carry a PIP-Net tree (``backbone``, ``add_on``,
``classification``, no ``intermediate``) to models.pipnet.PIPNet.
The intermediate layer's leaves keep their names (``ramp``, ``weight``,
``embed``: the JAX package already holds ``weight`` and ``embed`` as
[out, in]); the bilinear layer's ``W``/``V`` are flax ``Dense`` kernels.

Leaves may be numpy arrays, jax arrays or anything ``np.asarray`` takes;
the result holds float32 CPU tensors. :func:`to_jax_params` is the inverse
(state dict -> nested dict of float32 numpy arrays), and :func:`jax_path`
names the flax leaf of one state-dict key. Loading the flax msgpack
checkpoint files themselves is ROADMAP Queue 1: The flax-msgpack
checkpoint loader.
"""

import re

import numpy as np
import torch

__all__ = ["backbone_from_jax_params", "intermediate_from_jax_params",
           "from_jax_params", "to_jax_params", "jax_path"]

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


def intermediate_from_jax_params(params) -> dict:
    """An intermediate layer's flax params -> the state dict of its module
    in models/intermediates.py (no prefix; empty for onehot/identity)."""
    sd = {}
    for name, v in params.items():
        if isinstance(v, dict):  # bilinear W / V: flax Dense [in, out]
            sd[f"{name}.weight"] = _t(v["kernel"], (1, 0))
        else:
            sd[name] = _t(v)
    return sd


def from_jax_params(params) -> dict:
    """Whole CountPIPNet or PIPNet flax params -> state dict of
    models.pipnet.CountPIPNet / PIPNet (backbone, add-on conv,
    intermediate where there is one, classifier)."""
    sd = {f"backbone.{k}": v
          for k, v in backbone_from_jax_params(params["backbone"]).items()}
    sd.update({f"intermediate.{k}": v for k, v in
               intermediate_from_jax_params(
                   params.get("intermediate", {})).items()})
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


# torchvision block child -> flax scope inside a block
_BLOCK_CHILD = {"0": "dwconv", "2": "norm", "3": "pw1", "5": "pw2"}
_LEAF = {"weight": "kernel", "bias": "bias"}


def jax_path(key: str):
    """The flax parameter path (tuple of names) of a CountPIPNet state-dict
    key, e.g. ``backbone.features.1.0.block.3.weight`` ->
    ``("backbone", "features_1_block_0", "pw1", "kernel")``."""
    parts = key.split(".")
    if parts[0] == "backbone":
        i = int(parts[2])
        if len(parts) == 5 and parts[4] == "layer_scale":
            return ("backbone", f"features_{i}_block_{parts[3]}",
                    "layer_scale")
        if parts[4:5] == ["block"]:
            scope = _BLOCK_CHILD[parts[5]]
            leaf = ("scale" if scope == "norm" and parts[6] == "weight"
                    else _LEAF[parts[6]])
            return ("backbone", f"features_{i}_block_{parts[3]}", scope, leaf)
        conv_child = "0" if i == 0 else "1"  # stem: conv then norm
        if parts[3] == conv_child:
            return ("backbone", f"features_{i}", "conv", _LEAF[parts[4]])
        return ("backbone", f"features_{i}", "norm",
                "scale" if parts[4] == "weight" else "bias")
    if parts[0] == "add_on":
        return ("add_on", "conv1x1", _LEAF[parts[2]])
    if parts[0] == "intermediate":
        if len(parts) == 3:  # bilinear W.weight / V.weight
            return ("intermediate", parts[1], "kernel")
        return ("intermediate", parts[1])
    if parts[0] == "classification":
        return ("classification", {"normalization_multiplier": "multiplier"}
                .get(parts[1], parts[1]))
    raise KeyError(f"no flax counterpart for {key!r}")


def to_jax_params(state_dict) -> dict:
    """CountPIPNet state dict -> the JAX package's nested parameter tree
    (float32 numpy), the inverse of :func:`from_jax_params`."""
    tree = {}
    for key, v in state_dict.items():
        a = v.detach().cpu().float().numpy()
        path = jax_path(key)
        if path[-1] == "kernel":
            a = (np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4
                 else np.transpose(a, (1, 0)))
        elif path[-1] == "layer_scale":
            a = a.reshape(-1)
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return tree
