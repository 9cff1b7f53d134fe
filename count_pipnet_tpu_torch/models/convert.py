"""Parameter bridge between the JAX package's flax parameter tree and a
PyTorch state dict, both ways.

The inverse of count_pipnet_tpu/models/convnext.py:convert_torchvision_
convnext (:349), extended to the whole Count-PIPNet. Layouts:

    conv kernel   HWIO [kh, kw, in, out] -> OIHW [out, in, kh, kw]
    depthwise     [7, 7, 1, C]           -> [C, 1, 7, 7]
    dense kernel  [in, out]              -> [out, in]
    layer_scale   [C]                    -> [C, 1, 1]

The same functions carry a PIP-Net tree (``backbone``, ``add_on``,
``classification``, no ``intermediate``) to models.pipnet.PIPNet, and a
ResNet backbone (count_pipnet_tpu/models/resnet.py) to models/resnet.py:

    conv kernel   HWIO -> OIHW (``conv1``, ``layer{i}_block_{b}/conv{c}``,
                  ``downsample_conv`` -> ``layer{i}.{b}.downsample.0``)
    BatchNorm     scale / bias -> weight / bias, and the ``batch_stats``
                  collection's mean / var -> running_mean / running_var
                  (``downsample_bn`` -> ``layer{i}.{b}.downsample.1``)

The intermediate layer's leaves keep their names (``ramp``, ``weight``,
``embed``: the JAX package already holds ``weight`` and ``embed`` as
[out, in]); the bilinear layer's ``W``/``V`` are flax ``Dense`` kernels.

Leaves may be numpy arrays, jax arrays, torch tensors (of any float
dtype, bfloat16 too) or anything ``np.asarray`` takes;
the result holds float32 CPU tensors. :func:`to_jax_params` and
:func:`to_jax_batch_stats` are the inverse (state dict -> nested dicts of
float32 numpy arrays), and :func:`jax_path` names the flax leaf of one
state-dict key (in ``batch_stats`` for a running statistic, see
:func:`is_batch_stat`). :func:`from_torch_resnet` takes a torchvision or
BBN ResNet state dict. The JAX package's checkpoint files are read by
utils/msgpack.py and utils/checkpoint.py.
"""

import re

import numpy as np
import torch

__all__ = ["backbone_from_jax_params", "resnet_from_jax_params",
           "intermediate_from_jax_params", "from_jax_params",
           "to_jax_params", "to_jax_batch_stats", "jax_path",
           "is_batch_stat", "from_torch_resnet"]

_BLOCK = re.compile(r"features_(\d+)_block_(\d+)$")
_STAGE = re.compile(r"features_(\d+)$")
_RES_BLOCK = re.compile(r"layer(\d+)_block_(\d+)$")
_STATS = {"running_mean": "mean", "running_var": "var"}


def _t(v, perm=None):
    a = (v.detach().cpu().float().numpy() if torch.is_tensor(v)
         else np.asarray(v, dtype=np.float32))
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


def resnet_from_jax_params(params, batch_stats=None) -> dict:
    """ResNetFeatures flax params (and its ``batch_stats``, where given) ->
    torchvision-named state dict (no prefix)."""
    stats = batch_stats or {}
    sd = {}

    def bn(pre, p, st):
        sd[f"{pre}.weight"] = _t(p["scale"])
        sd[f"{pre}.bias"] = _t(p["bias"])
        if st:
            sd[f"{pre}.running_mean"] = _t(st["mean"])
            sd[f"{pre}.running_var"] = _t(st["var"])

    for scope, sub in params.items():
        if scope == "conv1":
            sd["conv1.weight"] = _oihw(sub["kernel"])
            continue
        if scope == "bn1":
            bn("bn1", sub, stats.get("bn1"))
            continue
        m = _RES_BLOCK.match(scope)
        if not m:
            raise KeyError(f"unexpected ResNet parameter scope {scope!r}")
        pre = f"layer{m.group(1)}.{m.group(2)}"
        st = stats.get(scope, {})
        for name, leaf in sub.items():
            child = {"downsample_conv": "downsample.0",
                     "downsample_bn": "downsample.1"}.get(name, name)
            if "kernel" in leaf:
                sd[f"{pre}.{child}.weight"] = _oihw(leaf["kernel"])
            else:
                bn(f"{pre}.{child}", leaf, st.get(name))
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


def from_jax_params(params, batch_stats=None) -> dict:
    """Whole CountPIPNet or PIPNet flax params (and, for a ResNet backbone,
    its ``batch_stats`` collection) -> state dict of
    models.pipnet.CountPIPNet / PIPNet (backbone, add-on conv,
    intermediate where there is one, classifier)."""
    bb = params["backbone"]
    if "conv1" in bb:
        bb_sd = resnet_from_jax_params(
            bb, (batch_stats or {}).get("backbone"))
    else:
        bb_sd = backbone_from_jax_params(bb)
    sd = {f"backbone.{k}": v for k, v in bb_sd.items()}
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


def is_batch_stat(key: str) -> bool:
    """Whether a state-dict key is a BatchNorm running statistic (a leaf
    of flax's ``batch_stats`` collection, not of ``params``)."""
    return key.rsplit(".", 1)[-1] in _STATS


def _resnet_path(parts):
    """flax path of a ResNet backbone key (``parts`` after "backbone")."""
    if parts[0] in ("conv1", "bn1"):
        scope, rest = (parts[0],), parts[1:]
        child = parts[0]
    else:
        scope = (f"{parts[0]}_block_{parts[1]}",)
        child = parts[2]
        rest = parts[3:]
        if child == "downsample":
            child = "downsample_conv" if rest[0] == "0" else "downsample_bn"
            rest = rest[1:]
        scope = scope + (child,)
    leaf = rest[0]
    if child.startswith("conv") or child == "downsample_conv":
        return ("backbone",) + scope + ("kernel",)
    if leaf in _STATS:
        return ("backbone",) + scope + (_STATS[leaf],)
    return ("backbone",) + scope + ("scale" if leaf == "weight" else "bias",)


def jax_path(key: str):
    """The flax path (tuple of names) of a CountPIPNet or PIPNet state-dict
    key, e.g. ``backbone.features.1.0.block.3.weight`` ->
    ``("backbone", "features_1_block_0", "pw1", "kernel")``; for a running
    statistic (:func:`is_batch_stat`), its path in ``batch_stats``, e.g.
    ``backbone.layer1.0.bn1.running_var`` ->
    ``("backbone", "layer1_block_0", "bn1", "var")``."""
    parts = key.split(".")
    if parts[0] == "backbone" and parts[1] != "features":
        return _resnet_path(parts[1:])
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
    """CountPIPNet or PIPNet state dict -> the JAX package's nested
    parameter tree (float32 numpy), the inverse of :func:`from_jax_params`
    (the running statistics go to :func:`to_jax_batch_stats`)."""
    return _to_jax(state_dict, stats=False)


def to_jax_batch_stats(state_dict) -> dict:
    """The running statistics of a state dict -> the JAX package's
    ``batch_stats`` collection (float32 numpy; empty for ConvNeXt)."""
    return _to_jax(state_dict, stats=True)


def _to_jax(state_dict, stats):
    tree = {}
    for key, v in state_dict.items():
        if is_batch_stat(key) != stats:
            continue
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


def from_torch_resnet(state_dict, inat: bool = False) -> dict:
    """A torchvision or BBN ResNet state dict -> the state dict of
    models/resnet.py's ResNetFeatures (the counterpart of the JAX
    package's convert_torch_resnet, its models/resnet.py:162-238): ``fc.*``
    and ``num_batches_tracked`` dropped; with ``inat`` (the BBN
    iNaturalist-2017 checkpoint) only the ``module.backbone.`` keys, that
    prefix stripped, ``cb_block`` -> ``layer4.2`` and ``rb_block``
    dropped (reference resnet_features.py:273-301). Values become float32
    CPU tensors."""
    sd = {}
    for k, v in state_dict.items():
        if inat:
            if not k.startswith("module.backbone."):
                continue
            k = k[len("module.backbone."):]
            if "rb_block" in k:
                continue
            k = k.replace("cb_block", "layer4.2")
        if k.startswith("fc.") or k.endswith("num_batches_tracked"):
            continue
        sd[k] = (v.detach().cpu().float() if torch.is_tensor(v)
                 else _t(v))
    return sd
