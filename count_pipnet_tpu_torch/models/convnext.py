"""ConvNeXt-Tiny feature extractor in PyTorch, NHWC at the interface.

Port of count_pipnet_tpu/models/convnext.py (reference
features/convnext_features.py): stride surgery (a downsample conv whose
``in_channels`` exceeds ``stride_threshold`` runs at stride 1: threshold 100
gives 26x26 latents at 224 input, 300 gives 13x13) and mid-layer truncation
to the stem plus the first ``num_stages`` of the 7 feature stages.

Module and parameter names are torchvision's (``features.{i}.{j}.block.
{0,2,3,5}``, ``layer_scale``), so a torchvision ``convnext_tiny`` state dict
loads without torchvision. Images come in as [B, H, W, 3] and features go
out as [B, H, W, C]; inside, the convs run on ``channels_last`` tensors
(an NHWC tensor viewed as NCHW is exactly that layout).

Eval forward only: no stochastic depth (training is a later slice). The
block uses erf-GELU like torchvision and the flax module; the serving
kernels use tanh-GELU, as the TPU kernels do.
"""

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["CONVNEXT_TINY_STAGES", "LayerNorm2d", "Stem", "CNBlock",
           "Downsample", "ConvNeXtFeatures", "convnext_tiny_26_features",
           "convnext_tiny_13_features", "get_feature_dimensions",
           "stage_layout"]

# (out_channels, num_blocks) per ConvNeXt-Tiny stage.
CONVNEXT_TINY_STAGES = ((96, 3), (192, 3), (384, 9), (768, 3))


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW tensor (torchvision's)."""

    def forward(self, x):
        x = x.permute(0, 2, 3, 1)
        x = F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                         self.eps)
        return x.permute(0, 3, 1, 2)


class Permute(nn.Module):
    def __init__(self, dims):
        super().__init__()
        self.dims = tuple(dims)

    def forward(self, x):
        return x.permute(*self.dims)


class Stem(nn.Sequential):
    """4x4 stride-4 patchify conv + LayerNorm2d (``features.0``)."""

    def __init__(self, dim: int):
        super().__init__(nn.Conv2d(3, dim, 4, stride=4),
                         LayerNorm2d(dim, eps=1e-6))


class CNBlock(nn.Module):
    """dw-conv7x7 -> LN -> Linear 4d -> GELU -> Linear d, layer scale,
    residual (torchvision CNBlock, eval)."""

    def __init__(self, dim: int, layer_scale: float = 1e-6):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv2d(dim, dim, 7, padding=3, groups=dim),
            Permute((0, 2, 3, 1)),
            nn.LayerNorm(dim, eps=1e-6),
            nn.Linear(dim, 4 * dim),
            nn.GELU(),
            nn.Linear(4 * dim, dim),
            Permute((0, 3, 1, 2)),
        )
        self.layer_scale = nn.Parameter(torch.full((dim, 1, 1),
                                                   float(layer_scale)))

    def forward(self, x):
        return x + self.layer_scale * self.block(x)


class Downsample(nn.Sequential):
    """LayerNorm2d + 2x2 conv; stride 2 unless surgically reduced to 1."""

    def __init__(self, in_dim: int, dim: int, stride: int):
        super().__init__(LayerNorm2d(in_dim, eps=1e-6),
                         nn.Conv2d(in_dim, dim, 2, stride=stride))


def stage_layout(stage_settings, num_stages, stride_threshold):
    """The kept feature stages in order: ``("blocks", feat_idx, dim, n)``
    and ``("down", feat_idx, in_dim, dim, stride)`` tuples, the same index
    arithmetic as the JAX package's ConvNeXtFeatures.__call__."""
    out = []
    feat_idx = 1
    for k, (dim, n_blocks) in enumerate(stage_settings):
        if k > 0:
            if feat_idx > num_stages:
                break
            in_ch = stage_settings[k - 1][0]
            stride = 1 if in_ch > stride_threshold else 2
            out.append(("down", feat_idx, in_ch, dim, stride))
            feat_idx += 1
        if feat_idx > num_stages:
            break
        out.append(("blocks", feat_idx, dim, n_blocks))
        feat_idx += 1
    return out


class ConvNeXtFeatures(nn.Module):
    """ConvNeXt feature extractor (classifier and pooling stripped).

    ``features[0]`` is the stem, ``features[2k-1]`` block stage k and
    ``features[2k]`` the downsample into stage k+1, truncated to the stem
    plus ``num_stages`` of the 7.
    """

    def __init__(self, stage_settings: Sequence = CONVNEXT_TINY_STAGES,
                 stride_threshold: int = 100, num_stages: int = 7):
        super().__init__()
        self.stage_settings = tuple(tuple(s) for s in stage_settings)
        self.stride_threshold = int(stride_threshold)
        self.num_stages = int(num_stages)
        self.layout = stage_layout(self.stage_settings, self.num_stages,
                                   self.stride_threshold)
        mods = [Stem(self.stage_settings[0][0])]
        for entry in self.layout:
            if entry[0] == "down":
                _, _, in_ch, dim, stride = entry
                mods.append(Downsample(in_ch, dim, stride))
            else:
                _, _, dim, n_blocks = entry
                mods.append(nn.Sequential(
                    *[CNBlock(dim) for _ in range(n_blocks)]))
        self.features = nn.Sequential(*mods)

    @property
    def out_channels(self) -> int:
        """Channels of the last kept stage."""
        last = self.layout[-1] if self.layout else None
        if last is None:
            return self.stage_settings[0][0]
        return last[3] if last[0] == "down" else last[2]

    def forward(self, x):
        """[B, H, W, 3] -> [B, H', W', C] features."""
        h = self.features(x.permute(0, 3, 1, 2))
        return h.permute(0, 2, 3, 1)


def convnext_tiny_26_features(num_stages: int = 7):
    """Stride threshold 100 -> 26x26 latent at 224 input
    (reference convnext_features.py:38-65)."""
    return ConvNeXtFeatures(stride_threshold=100, num_stages=num_stages)


def convnext_tiny_13_features(num_stages: int = 7):
    """Stride threshold 300 -> 13x13 latent at 224 input
    (reference convnext_features.py:67-94)."""
    return ConvNeXtFeatures(stride_threshold=300, num_stages=num_stages)


def get_feature_dimensions(use_mid_layers=False, num_stages=2,
                           input_size=224, stride_threshold=100):
    """Backbone output shape (NHWC, batch 1) in closed form: the stem
    divides by 4; a stride-2 downsample maps s to (s - 2) // 2 + 1, a
    stride-1 one to s - 1 (2x2 VALID conv)."""
    layout = stage_layout(CONVNEXT_TINY_STAGES,
                          num_stages if use_mid_layers else 7,
                          stride_threshold)
    s = input_size // 4
    chans = CONVNEXT_TINY_STAGES[0][0]
    for entry in layout:
        if entry[0] == "down":
            s = s - 1 if entry[4] == 1 else (s - 2) // 2 + 1
            chans = entry[3]
    return (1, s, s, chans)
