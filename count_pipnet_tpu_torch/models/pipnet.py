"""PIP-Net and Count-PIPNet in PyTorch.

Port of count_pipnet_tpu/models/pipnet.py.

* ``PIPNet`` (reference pipnet/pipnet.py:31-41): backbone -> softmax
  add-on -> spatial MAX -> non-negative classifier; at inference pooled
  values under 0.1 are zeroed before the classifier (abstention).
* ``CountPIPNet`` (reference pipnet/count_pipnet.py:70-110): backbone ->
  add-on (gumbel / softmax) -> spatial SUM (counts) -> round + clamp to
  [0, max_count] -> intermediate -> non-negative classifier. Training
  returns raw counts (for the tanh loss), inference the clamped ones.

Outputs are ``(proto_features [B, H, W, P], pooled [B, P], logits)``.
``--fused_blocks``, ``--fused_dwconv`` and ``--fused_whole_blocks`` build
a ConvNeXt backbone on the kernel block routes (models/convnext.py); the
ResNet backbones (models/resnet.py) take none of them, as in the JAX
package.
"""

from typing import Optional

import torch
import torch.nn as nn

from ..ops.ste import ste_clamp, ste_round
from .convnext import convnext_tiny_13_features, convnext_tiny_26_features
from .heads import AddOn, NonNegLinear
from .intermediates import make_intermediate
from .resnet import (resnet18_features, resnet34_features,
                     resnet50_features, resnet50_features_inat,
                     resnet101_features, resnet152_features)

__all__ = ["PIPNet", "CountPIPNet", "get_pipnet", "get_count_network",
           "build_backbone", "importance_per_class", "BACKBONE_BUILDERS"]

BACKBONE_BUILDERS = {
    "convnext_tiny_26": convnext_tiny_26_features,
    "convnext_tiny_13": convnext_tiny_13_features,
    "resnet18": resnet18_features,
    "resnet34": resnet34_features,
    "resnet50": resnet50_features,
    "resnet50_inat": resnet50_features_inat,
    "resnet101": resnet101_features,
    "resnet152": resnet152_features,
}


def build_backbone(net: str, use_mid_layers: bool = False,
                   num_stages: int = 2, fused_mlp: bool = False,
                   fused_whole_block: bool = False,
                   fused_dwconv: bool = False):
    """Backbone factory (reference pipnet/pipnet.py:44-51); the block-route
    flags and the mid-layer truncation apply to ConvNeXt only."""
    if net not in BACKBONE_BUILDERS:
        raise ValueError(
            f"Network '{net}' is not supported. Supported: "
            f"{sorted(BACKBONE_BUILDERS)}")
    if not net.startswith("convnext"):
        return BACKBONE_BUILDERS[net]()
    return BACKBONE_BUILDERS[net](
        num_stages=num_stages if use_mid_layers else 7, fused_mlp=fused_mlp,
        fused_whole_block=fused_whole_block, fused_dwconv=fused_dwconv)


class PIPNet(nn.Module):
    """Original PIP-Net: softmax add-on (the 1x1 conv when
    ``num_features > 0``) + spatial max pool."""

    def __init__(self, num_classes: int, num_prototypes: int,
                 backbone: nn.Module, num_features: int = 0,
                 bias: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.num_prototypes = num_prototypes
        self.num_features = num_features
        self.backbone = backbone
        self.add_on = AddOn(backbone.out_channels, num_features, "softmax")
        self.classification = NonNegLinear(num_prototypes, num_classes,
                                           bias=bias)

    def forward(self, xs, *, inference: bool = False, train: bool = False,
                tau: float = 1.0, generator=None, noise=None,
                drop_masks=None, shard=None):
        """``xs`` [B, H, W, 3]; ``tau`` and ``noise`` are accepted for the
        Count-PIPNet interface and unused (the add-on is a softmax);
        ``shard``: as in :meth:`CountPIPNet.forward`."""
        features = self.backbone(xs, train=train, generator=generator,
                                 drop_masks=drop_masks, shard=shard)
        proto = self.add_on(features, train=train)
        pooled = proto.float().amax(dim=(1, 2))
        if inference:
            # abstention: ignore prototypes under 0.1 similarity
            # (reference pipnet.py:36)
            pooled = torch.where(pooled < 0.1, 0.0, pooled)
        return proto, pooled, self.classification(pooled)


class CountPIPNet(nn.Module):
    """Count-aware PIP-Net: spatial sum -> count discretization ->
    intermediate expansion -> non-negative classifier."""

    def __init__(self, num_classes: int, num_prototypes: int,
                 backbone: nn.Module, max_count: int = 3,
                 use_ste: bool = True, backward_clamp_identity: bool = True,
                 activation: str = "gumbel_softmax",
                 intermediate_type: str = "onehot",
                 positive_grad_strategy: Optional[str] = None,
                 num_features: int = 0, bias: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.num_prototypes = num_prototypes
        self.max_count = max_count
        self.use_ste = use_ste
        self.backward_clamp_identity = backward_clamp_identity
        self.activation = activation
        self.intermediate_type = intermediate_type
        self.num_features = num_features
        self.backbone = backbone
        self.add_on = AddOn(backbone.out_channels, num_features, activation)
        self.intermediate = make_intermediate(
            intermediate_type, num_prototypes, max_count, use_ste=use_ste,
            positive_grad_strategy=positive_grad_strategy)
        self.classification = NonNegLinear(self.intermediate.output_dim,
                                           num_classes, bias=bias)

    def head(self, counts, inference: bool):
        """counts [B, P] -> (pooled, logits)."""
        if self.use_ste:
            clamped = ste_clamp(ste_round(counts), 0.0,
                                float(self.max_count),
                                self.backward_clamp_identity)
        else:
            rounded = torch.round(counts) if inference else counts
            clamped = torch.clamp(rounded, 0.0, float(self.max_count))
        out = self.classification(self.intermediate(clamped))
        return (clamped if inference else counts), out

    def forward(self, xs, *, inference: bool = False, train: bool = False,
                tau: float = 1.0, generator=None, noise=None,
                drop_masks=None, shard=None):
        """``xs`` [B, H, W, 3]. ``generator``: the stochastic-depth masks
        (train mode) and the Gumbel draw; ``noise`` / ``drop_masks``
        replace them (see ops.gumbel.gumbel_softmax and
        ConvNeXtFeatures.forward). ``shard`` (parallel/mesh.py:
        BatchShard): ``xs`` is a rank's rows of a world batch; the draws
        are the world's, cut to those rows, and BatchNorm reads the
        world's statistics."""
        features = self.backbone(xs, train=train, generator=generator,
                                 drop_masks=drop_masks, shard=shard)
        proto = self.add_on(features, tau=tau, train=train,
                            generator=generator, noise=noise, shard=shard)
        counts = proto.float().sum(dim=(1, 2))
        pooled, out = self.head(counts, inference)
        return proto, pooled, out


def importance_per_class(model: CountPIPNet, classifier_input_scalars=None):
    """Virtual [num_classes, num_prototypes] importance matrix,
    ``sum_d |attribution[p, d] * scalar[d]| * W[c, d]`` (the JAX package's
    models/pipnet.py:importance_per_class; reference
    count_pipnet.py:126-147, 283-321)."""
    w = model.classification.weight.detach().float()
    attribution = model.intermediate.classifier_input_weight_matrix().to(
        w.device)
    if classifier_input_scalars is not None:
        attribution = attribution * classifier_input_scalars[None, :]
    return w @ attribution.abs().t()


def _backbone_of(args):
    """(backbone, num_features, num_prototypes) of the CLI's ``args``: the
    add-on's width when ``num_features > 0``, else the backbone's."""
    backbone = build_backbone(
        args.net, use_mid_layers=getattr(args, "use_mid_layers", False),
        num_stages=getattr(args, "num_stages", 2),
        fused_mlp=getattr(args, "fused_blocks", False),
        fused_whole_block=getattr(args, "fused_whole_blocks", False),
        fused_dwconv=getattr(args, "fused_dwconv", False))
    num_features = getattr(args, "num_features", 0) or 0
    return (backbone, num_features,
            num_features if num_features > 0 else backbone.out_channels)


def get_pipnet(num_classes: int, args):
    """PIPNet factory (reference pipnet/pipnet.py:74-140) on any backbone
    of BACKBONE_BUILDERS. Returns (model, num_prototypes)."""
    backbone, num_features, num_prototypes = _backbone_of(args)
    model = PIPNet(num_classes=num_classes, num_prototypes=num_prototypes,
                   backbone=backbone, num_features=num_features,
                   bias=getattr(args, "bias", False))
    return model, num_prototypes


def get_count_network(num_classes: int, args, max_count: int = 3,
                      use_ste: bool = True):
    """CountPIPNet factory (reference pipnet/count_pipnet.py:324-436);
    ConvNeXt only, like the reference. Returns (model, num_prototypes)."""
    if not args.net.startswith("convnext"):
        raise ValueError(
            f"Network '{args.net}' is not supported. Supported networks: "
            f"{[k for k in BACKBONE_BUILDERS if 'convnext' in k]}")
    backbone, num_features, num_prototypes = _backbone_of(args)
    model = CountPIPNet(
        num_classes=num_classes, num_prototypes=num_prototypes,
        backbone=backbone, max_count=max_count, use_ste=use_ste,
        backward_clamp_identity=(
            getattr(args, "backward_clamp_strategy", "Gated") == "Identity"),
        activation=getattr(args, "activation", "gumbel_softmax"),
        intermediate_type=getattr(args, "intermediate_layer", "onehot"),
        positive_grad_strategy=getattr(args, "positive_grad_strategy", None),
        num_features=num_features, bias=getattr(args, "bias", False))
    return model, num_prototypes
