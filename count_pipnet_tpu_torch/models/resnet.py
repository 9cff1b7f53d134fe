"""ResNet feature extractors in PyTorch, NHWC at the interface.

Port of count_pipnet_tpu/models/resnet.py (reference
features/resnet_features.py): avgpool and fc removed, and layer3 and
layer4 at stride 1, so a 224 input gives a 28x28 latent grid (conv1 s2,
maxpool s2, layer2 s2). The stride of a block sits on its conv2
(Bottleneck) or conv1 (BasicBlock) and on its downsample conv.

Module and parameter names are torchvision's (``conv1``, ``bn1``,
``layer{i}.{b}.conv{c}`` / ``.bn{c}`` / ``.downsample.0|1``; no ``fc``),
so a torchvision state dict loads without torchvision
(models/convert.py:from_torch_resnet). Images come in as [B, H, W, 3] and
features go out as [B, H, W, C]; inside, the convs run on
``channels_last`` tensors, as in models/convnext.py.

Initialisation is the JAX package's: every conv kernel from flax's
``variance_scaling(2.0, "fan_out", "truncated_normal")`` (a normal cut at
two standard deviations, its std sqrt(2 / fan_out) / 0.8796...), the
BatchNorms at one and zero with running statistics at zero and one.

The BatchNorm is flax's (momentum 0.9, eps 1e-5): with ``train=True`` it
normalises with the batch's biased variance and moves the running
statistics toward the batch's mean and *biased* variance (PyTorch's own
BatchNorm moves ``running_var`` toward the unbiased one); with
``train=False`` it uses the running statistics. The running statistics
move in every training forward, whether or not the layer's parameters
train, as flax's mutable ``batch_stats`` do. The module's own
``training`` flag plays no part: the caller's ``train`` decides.

In a data-parallel world (a ``shard``, parallel/mesh.py) a training
forward normalises with the world batch's statistics, as flax's BatchNorm
does under the JAX package's mesh: each layer all-reduces its per-channel
sum, sum of squares and count, and the biased variance is E[x²] - E[x]²
(flax's rule). The gradient runs through the all-reduce, and the running
statistics move alike on every rank.
"""

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["BatchNorm", "BasicBlock", "Bottleneck", "ResNetFeatures",
           "resnet18_features", "resnet34_features", "resnet50_features",
           "resnet50_features_inat", "resnet101_features",
           "resnet152_features", "init_variance_scaling"]

# std of N(0, 1) cut at +-2 (flax's truncated_normal divides by it)
_TRUNC_STD = 0.87962566103423978


def init_variance_scaling(conv: nn.Conv2d) -> nn.Conv2d:
    """flax ``variance_scaling(2.0, "fan_out", "truncated_normal")``:
    N(0, 1) cut at +-2, times sqrt(2 / fan_out) / 0.8796..., fan_out =
    out_channels * kh * kw. ``trunc_normal_``'s bounds are absolute."""
    out_ch, _, kh, kw = conv.weight.shape
    std = math.sqrt(2.0 / (out_ch * kh * kw)) / _TRUNC_STD
    nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std)
    return conv


def _conv(cin, cout, k, stride=1):
    return init_variance_scaling(nn.Conv2d(cin, cout, k, stride=stride,
                                           padding=k // 2, bias=False))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels
    of an NCHW tensor (see the module docstring)."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = float(eps)
        self.momentum = float(momentum)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, train: bool = False, shard=None):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dt = self.running_var.dtype
        if shard is None:
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            # the biased variance
            var = invstd.detach().to(dt).pow(-2) - self.eps
        else:
            y, mean, var = self._world_forward(x, shard)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.to(dt), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.to(dt), alpha=m)
        return y

    def _world_forward(self, x, shard):
        """Normalise with the world batch's statistics: (y, mean, biased
        variance), the statistics from one all-reduce of [sum, sum of
        squares, count] per channel."""
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        n = torch.full_like(xf[0, :, 0, 0], xf.numel() / xf.shape[1])
        stats = shard.all_reduce(torch.stack([
            xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)), n]))
        mean = stats[0] / stats[2]
        var = (stats[1] / stats[2] - mean * mean).clamp(min=0.0)
        scale = self.weight * torch.rsqrt(var + self.eps)
        shape = (1, -1, 1, 1)
        y = (xf - mean.view(shape)) * scale.view(shape) + \
            self.bias.view(shape)
        return y.to(x.dtype), mean.detach(), var.detach()


class BasicBlock(nn.Module):
    """Two 3x3 convs (the stride on the first), residual."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm(planes)
        self.downsample = (nn.Sequential(_conv(inplanes, planes, 1, stride),
                                         BatchNorm(planes))
                           if downsample else None)

    def forward(self, x, train: bool = False, shard=None):
        h = F.relu(self.bn1(self.conv1(x), train, shard))
        h = self.bn2(self.conv2(h), train, shard)
        return F.relu(_shortcut(self.downsample, x, train, shard) + h)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (the stride) -> 1x1 x4 expansion, residual."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        width = planes * self.expansion
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = BatchNorm(planes)
        self.conv3 = _conv(planes, width, 1)
        self.bn3 = BatchNorm(width)
        self.downsample = (nn.Sequential(_conv(inplanes, width, 1, stride),
                                         BatchNorm(width))
                           if downsample else None)

    def forward(self, x, train: bool = False, shard=None):
        h = F.relu(self.bn1(self.conv1(x), train, shard))
        h = F.relu(self.bn2(self.conv2(h), train, shard))
        h = self.bn3(self.conv3(h), train, shard)
        return F.relu(_shortcut(self.downsample, x, train, shard) + h)


def _shortcut(downsample, x, train, shard=None):
    if downsample is None:
        return x
    return downsample[1](downsample[0](x), train, shard)


class ResNetFeatures(nn.Module):
    """ResNet trunk without avgpool and fc; per-layer strides
    ``layer_strides`` (the reference's (1, 2, 1, 1))."""

    def __init__(self, block=BasicBlock, layers: Sequence[int] = (2, 2, 2, 2),
                 layer_strides: Sequence[int] = (1, 2, 1, 1)):
        super().__init__()
        self.block = block
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = BatchNorm(64)
        inplanes = 64
        for i, (planes, n, stride) in enumerate(
                zip((64, 128, 256, 512), layers, layer_strides), start=1):
            blocks = []
            for b in range(n):
                s = stride if b == 0 else 1
                ds = b == 0 and (s != 1 or inplanes != planes *
                                 block.expansion)
                blocks.append(block(inplanes, planes, s, ds))
                inplanes = planes * block.expansion
            setattr(self, f"layer{i}", nn.Sequential(*blocks))

    @property
    def out_channels(self) -> int:
        return 512 * self.block.expansion

    def forward(self, x, *, train: bool = False, generator=None,
                drop_masks=None, shard=None):
        """[B, H, W, 3] -> [B, H', W', C] features. ``generator`` and
        ``drop_masks`` are accepted for the ConvNeXt interface and unused
        (a ResNet has no stochastic depth); ``shard``: the BatchNorms of a
        training forward read the world batch's statistics."""
        h = x.permute(0, 3, 1, 2)
        h = F.relu(self.bn1(self.conv1(h), train, shard))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        for i in range(1, 5):
            for blk in getattr(self, f"layer{i}"):
                h = blk(h, train, shard)
        return h.permute(0, 2, 3, 1)


def resnet18_features():
    return ResNetFeatures(BasicBlock, (2, 2, 2, 2))


def resnet34_features():
    return ResNetFeatures(BasicBlock, (3, 4, 6, 3))


def resnet50_features():
    return ResNetFeatures(Bottleneck, (3, 4, 6, 3))


def resnet101_features():
    return ResNetFeatures(Bottleneck, (3, 4, 23, 3))


def resnet152_features():
    return ResNetFeatures(Bottleneck, (3, 8, 36, 3))


def resnet50_features_inat():
    """The resnet50 trunk; its pretrained weights are the BBN
    iNaturalist-2017 checkpoint, remapped by
    models/convert.py:from_torch_resnet(..., inat=True)."""
    return ResNetFeatures(Bottleneck, (3, 4, 6, 3))
