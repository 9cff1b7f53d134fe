"""Parameter groups, learning-rate schedules and the optimizer.

Port of count_pipnet_tpu/train/optim.py (reference util/args.py:250-402,
main.py:209, 309-314, train.py:116-124). Every parameter gets a *label*
by the JAX package's ``label_params`` rules, applied to the port's
torchvision names; each label becomes one parameter group of
``torch.optim.AdamW`` (betas 0.9/0.999, eps 1e-8) whose learning rate the
trainer sets every step. Weight decay applies to ``cls_weight`` and
``intermediate`` only.

A phase's mask becomes ``requires_grad``: a masked parameter gets no
gradient (``zero_grad(set_to_none=True)``), so AdamW neither moves it nor
advances its step count - what the JAX package's ``adamw_update`` does
with a mask of 0.
"""

import math
from typing import Dict, Optional

import torch

__all__ = ["label_params", "make_optimizer", "set_trainable", "cosine_lr",
           "warm_restart_lr", "masks_of", "load_adamw_by_name",
           "NET_LABELS", "CLASSIFIER_LABELS"]

NET_LABELS = ("backbone", "to_freeze", "to_train", "add_on")
CLASSIFIER_LABELS = ("cls_weight", "cls_bias", "intermediate")


def _convnext_label(key: str, use_mid_layers: bool, num_stages: int) -> str:
    """Label of a backbone parameter ``features.{i}[.{j}]...`` (util/
    args.py:273-279 full net; :333-402 mid-layer nets)."""
    parts = key.split(".")
    stage = int(parts[1])
    if use_mid_layers and num_stages < 7:
        if stage == num_stages:
            return "to_train"
        if stage == num_stages - 1:
            return "to_freeze"
        return "backbone"
    if stage == 7 and parts[2] == "2":
        return "to_train"
    if stage in (6, 7):
        return "to_freeze"
    return "backbone"


def _resnet_label(key: str, net: str) -> str:
    """Label of a ResNet backbone parameter (util/args.py:282-290):
    resnet50 (and its iNat trunk) trains ``layer4.2``, freezes-then-trains
    the rest of layer4 and layer3, gives layer2 the backbone rate and
    never trains the stem and layer1; every other ResNet is all frozen."""
    if "resnet50" not in net:
        return "frozen"
    if key.startswith("layer4.2."):
        return "to_train"
    if key.startswith(("layer4.", "layer3.")):
        return "to_freeze"
    if key.startswith("layer2."):
        return "backbone"
    return "frozen"


def label_of(name: str, net: str, use_mid_layers: bool = False,
             num_stages: int = 2, train_intermediate: bool = True,
             bias: bool = False) -> str:
    """The group of one CountPIPNet parameter (its state-dict name)."""
    scope, _, rest = name.partition(".")
    if scope == "backbone":
        if "convnext" not in net:
            return _resnet_label(rest, net)
        return _convnext_label(rest, use_mid_layers, num_stages)
    if scope == "add_on":
        return "add_on"
    if scope == "intermediate":
        return "intermediate" if train_intermediate else "frozen"
    if scope == "classification":
        if rest == "weight":
            return "cls_weight"
        if rest == "bias":
            return "cls_bias" if bias else "frozen"
    return "frozen"  # normalization multiplier (util/args.py:300-301)


def label_params(model, net: str, use_mid_layers: bool = False,
                 num_stages: int = 2, train_intermediate: bool = True,
                 bias: bool = False) -> Dict[str, str]:
    """{parameter name: label} for every parameter of ``model``."""
    return {name: label_of(name, net, use_mid_layers, num_stages,
                           train_intermediate, bias)
            for name, _ in model.named_parameters()}


def make_optimizer(model, labels: Dict[str, str], weight_decay: float = 0.0,
                   eps: float = 1e-8):
    """AdamW with one group per label (``group["label"]``); the learning
    rates are set per step. ``weight_decay`` is explicit in every group:
    AdamW's own default is 1e-2."""
    params = dict(model.named_parameters())
    groups = []
    for label in NET_LABELS + CLASSIFIER_LABELS:
        members = [params[n] for n, lab in labels.items() if lab == label]
        if members:
            wd = weight_decay if label in ("cls_weight", "intermediate") \
                else 0.0
            groups.append({"params": members, "lr": 0.0,
                           "weight_decay": wd, "label": label})
    return torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=eps,
                             weight_decay=0.0)


def load_adamw_by_name(optimizer, model, by_name: Dict[str, Dict]):
    """Set the AdamW state of ``model``'s parameters from ``{name: {"step",
    "exp_avg", "exp_avg_sq"}}`` (a JAX package checkpoint's, see
    utils/checkpoint.py:from_jax_state); the moments go to each
    parameter's device and dtype, the step stays a CPU float tensor as
    AdamW keeps it."""
    params = dict(model.named_parameters())
    for name, st in by_name.items():
        p = params[name]
        optimizer.state[p] = {
            "step": st["step"].float().cpu(),
            "exp_avg": st["exp_avg"].to(p.device, p.dtype),
            "exp_avg_sq": st["exp_avg_sq"].to(p.device, p.dtype)}


def set_trainable(model, labels: Dict[str, str], masks: Dict[str, float]):
    """``requires_grad`` of every parameter from the phase's masks; the
    ``frozen`` label never trains."""
    for name, p in model.named_parameters():
        label = labels[name]
        p.requires_grad_(label != "frozen" and masks.get(label, 0.0) > 0.0)


def cosine_lr(base_lr: float, step: int, total_steps: int,
              eta_min: float = 0.0) -> float:
    """torch.optim.lr_scheduler.CosineAnnealingLR closed form."""
    if total_steps <= 0:
        return base_lr
    t = min(step, total_steps)
    return eta_min + (base_lr - eta_min) * (
        1 + math.cos(math.pi * t / total_steps)) / 2


def warm_restart_lr(base_lr: float, frac_epoch: float, t_0: int,
                    eta_min: float = 0.001) -> float:
    """torch CosineAnnealingWarmRestarts (T_mult=1) at a fractional epoch."""
    t_cur = math.fmod(frac_epoch, t_0)
    return eta_min + (base_lr - eta_min) * (
        1 + math.cos(math.pi * t_cur / t_0)) / 2


def masks_of(trainable: Optional[set]) -> Dict[str, float]:
    """1.0 for the trainable labels, 0.0 for the others."""
    return {k: (1.0 if k in trainable else 0.0)
            for k in NET_LABELS + CLASSIFIER_LABELS}
