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

Under ``torch.autocast`` the residual stream is in the autocast dtype
from the stem on, on every block route, as the JAX trunk's stream is in
its ``dtype``.

Initialisation is the JAX package's: every conv and dense kernel from a
normal of std 0.02 truncated at two standard deviations, zero biases,
LayerNorms at one and zero, layer scales at 1e-6.

Training mode (``train=True``) applies stochastic depth with the JAX rule
``prob = 0.1 * block_id / (total_blocks - 1)``, where ``total_blocks``
counts all 18 blocks even when ``num_stages`` truncates the net: a
per-sample mask [B, 1, 1, 1] drawn from a ``torch.Generator`` (or given as
``drop_masks``), divided by the keep probability. The eager block uses
erf-GELU like torchvision and the flax module. The alternative block
routes, with the JAX package's semantics (its convnext.py:105-165) and the
same parameters, so checkpoints interchange:

* ``fused_mlp`` (``--fused_blocks``): the block body after the depthwise
  conv through K5 forward and K6 backward (ops/fused_mlp.py), tanh-GELU;
* ``fused_dwconv`` (``--fused_dwconv``): the depthwise conv through K7
  forward and PyTorch's conv backward (ops/dwconv_bwd.py), in the autocast
  dtype when autocast is on; it composes with ``fused_mlp``;
* ``fused_whole_block`` (``--fused_whole_blocks``): the whole block through
  kernel A forward and a recompute backward (ops/fused_block.py:
  fused_block_ad), tanh-GELU; it supersedes the other two.

On the fused routes stochastic depth scales the branch:
``z = x + (z - x) * mask / keep``.
"""

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dwconv_bwd import dwconv7_pfwd_ad
from ..ops.fused_block import fused_block_ad
from ..ops.fused_mlp import fused_ln_mlp_residual_ad

__all__ = ["CONVNEXT_TINY_STAGES", "LayerNorm2d", "Stem", "CNBlock",
           "Downsample", "ConvNeXtFeatures", "draw_drop_mask",
           "convnext_tiny_26_features",
           "convnext_tiny_13_features", "get_feature_dimensions",
           "stage_layout", "init_trunc_normal"]

# (out_channels, num_blocks) per ConvNeXt-Tiny stage.
CONVNEXT_TINY_STAGES = ((96, 3), (192, 3), (384, 9), (768, 3))


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW tensor (torchvision's).
    Under autocast the output takes the autocast dtype (the statistics
    stay f32), as flax's ``LayerNorm(dtype=...)`` returns its compute
    dtype: the stem then hands the blocks a bf16 stream, as in the JAX
    package."""

    def forward(self, x):
        x = x.permute(0, 2, 3, 1)
        x = F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                         self.eps)
        return x.to(_compute_dtype(x)).permute(0, 3, 1, 2)


def _compute_dtype(x):
    """The autocast dtype when autocast is on for ``x``'s device, else
    ``x``'s dtype."""
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return x.dtype


class Permute(nn.Module):
    def __init__(self, dims):
        super().__init__()
        self.dims = tuple(dims)

    def forward(self, x):
        return x.permute(*self.dims)


def init_trunc_normal(m):
    """The JAX package's ``truncated_normal(0.02)`` kernel init (N(0, 1)
    cut at +-2, times 0.02) and a zero bias. ``trunc_normal_``'s bounds
    are absolute, hence +-0.04."""
    nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04)
    nn.init.zeros_(m.bias)
    return m


class Stem(nn.Sequential):
    """4x4 stride-4 patchify conv + LayerNorm2d (``features.0``)."""

    def __init__(self, dim: int):
        super().__init__(init_trunc_normal(nn.Conv2d(3, dim, 4, stride=4)),
                         LayerNorm2d(dim, eps=1e-6))


class CNBlock(nn.Module):
    """dw-conv7x7 -> LN -> Linear 4d -> GELU -> Linear d, layer scale,
    stochastic depth (probability ``sd_prob``), residual. ``fused_mlp``,
    ``fused_dwconv``, ``fused_whole_block``: the kernel routes of the
    module docstring."""

    def __init__(self, dim: int, layer_scale: float = 1e-6,
                 sd_prob: float = 0.0, fused_mlp: bool = False,
                 fused_whole_block: bool = False,
                 fused_dwconv: bool = False):
        super().__init__()
        self.block = nn.Sequential(
            init_trunc_normal(nn.Conv2d(dim, dim, 7, padding=3, groups=dim)),
            Permute((0, 2, 3, 1)),
            nn.LayerNorm(dim, eps=1e-6),
            init_trunc_normal(nn.Linear(dim, 4 * dim)),
            nn.GELU(),
            init_trunc_normal(nn.Linear(4 * dim, dim)),
            Permute((0, 3, 1, 2)),
        )
        self.layer_scale = nn.Parameter(torch.full((dim, 1, 1),
                                                   float(layer_scale)))
        self.sd_prob = float(sd_prob)
        self.fused_mlp = bool(fused_mlp)
        self.fused_whole_block = bool(fused_whole_block)
        self.fused_dwconv = bool(fused_dwconv)

    def forward(self, x, drop_mask=None):
        """``x`` NCHW (a view of an NHWC tensor); ``drop_mask`` [B, 1, 1, 1]
        applies stochastic depth."""
        keep = 1.0 - self.sd_prob
        dw, _, ln, pw1, _, pw2, _ = self.block
        xr = x.permute(0, 2, 3, 1)
        if self.fused_whole_block or self.fused_mlp:
            if self.fused_whole_block:
                z = fused_block_ad(
                    xr, dw.weight, dw.bias, ln.weight, ln.bias, pw1.weight,
                    pw1.bias, pw2.weight, pw2.bias,
                    self.layer_scale.reshape(-1), ln.eps)
            else:
                z = fused_ln_mlp_residual_ad(
                    self._dwconv(x, xr), xr, ln.weight, ln.bias,
                    pw1.weight, pw1.bias, pw2.weight, pw2.bias,
                    self.layer_scale.reshape(-1), ln.eps)
            if drop_mask is not None:
                z = xr + (z - xr) * drop_mask.to(z.dtype) / keep
            return z.permute(0, 3, 1, 2)
        if self.fused_dwconv:
            h = self.block[1:](self._dwconv(x, xr).permute(0, 3, 1, 2))
        else:
            h = self.block(x)
        # the layer scale and the residual in the branch's dtype, as flax
        # casts gamma to it: under autocast the stream stays bf16
        h = self.layer_scale.to(h.dtype) * h
        if drop_mask is not None:
            h = h * drop_mask.to(h.dtype) / keep
        return x + h

    def _dwconv(self, x, xr):
        """The depthwise conv's NHWC output: K7 under ``fused_dwconv``
        (in the autocast dtype when autocast is on, as the default route's
        conv), else the module's conv."""
        dw = self.block[0]
        if not self.fused_dwconv:
            return dw(x).permute(0, 2, 3, 1)
        return dwconv7_pfwd_ad(xr, dw.weight, dw.bias, _compute_dtype(x))


class Downsample(nn.Sequential):
    """LayerNorm2d + 2x2 conv; stride 2 unless surgically reduced to 1."""

    def __init__(self, in_dim: int, dim: int, stride: int):
        super().__init__(LayerNorm2d(in_dim, eps=1e-6),
                         init_trunc_normal(
                             nn.Conv2d(in_dim, dim, 2, stride=stride)))


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


def draw_drop_mask(batch, sd_prob, device, generator=None, shard=None):
    """A block's stochastic-depth mask [batch, 1, 1, 1] in f32: 1 with
    probability ``1 - sd_prob``, drawn from ``generator``; with ``shard``
    (a rank's rows of a world batch) drawn at the world's size, this
    rank's rows kept."""
    shape = (batch, 1, 1, 1)
    if shard is not None:
        shape = shard.world_shape(shape)
    keep = torch.full(shape, 1.0 - sd_prob, device=device)
    mask = torch.bernoulli(keep, generator=generator)
    return mask if shard is None else shard.take(mask)


class ConvNeXtFeatures(nn.Module):
    """ConvNeXt feature extractor (classifier and pooling stripped).

    ``features[0]`` is the stem, ``features[2k-1]`` block stage k and
    ``features[2k]`` the downsample into stage k+1, truncated to the stem
    plus ``num_stages`` of the 7.
    """

    def __init__(self, stage_settings: Sequence = CONVNEXT_TINY_STAGES,
                 stride_threshold: int = 100, num_stages: int = 7,
                 stochastic_depth_prob: float = 0.1,
                 fused_mlp: bool = False, fused_whole_block: bool = False,
                 fused_dwconv: bool = False):
        super().__init__()
        self.stage_settings = tuple(tuple(s) for s in stage_settings)
        self.stride_threshold = int(stride_threshold)
        self.num_stages = int(num_stages)
        self.layout = stage_layout(self.stage_settings, self.num_stages,
                                   self.stride_threshold)
        total_blocks = sum(n for _, n in self.stage_settings)
        block_id = 0
        mods = [Stem(self.stage_settings[0][0])]
        for entry in self.layout:
            if entry[0] == "down":
                _, _, in_ch, dim, stride = entry
                mods.append(Downsample(in_ch, dim, stride))
            else:
                _, _, dim, n_blocks = entry
                blocks = []
                for _ in range(n_blocks):
                    prob = stochastic_depth_prob * block_id / max(
                        total_blocks - 1.0, 1.0)
                    blocks.append(CNBlock(
                        dim, sd_prob=prob, fused_mlp=fused_mlp,
                        fused_whole_block=fused_whole_block,
                        fused_dwconv=fused_dwconv))
                    block_id += 1
                mods.append(nn.Sequential(*blocks))
        self.features = nn.Sequential(*mods)

    def blocks(self):
        """The CNBlocks in order (index = block_id)."""
        return [m for m in self.modules() if isinstance(m, CNBlock)]

    @property
    def out_channels(self) -> int:
        """Channels of the last kept stage."""
        last = self.layout[-1] if self.layout else None
        if last is None:
            return self.stage_settings[0][0]
        return last[3] if last[0] == "down" else last[2]

    def forward(self, x, *, train: bool = False, generator=None,
                drop_masks=None, shard=None):
        """[B, H, W, 3] -> [B, H', W', C] features. With ``train``, each
        block with a nonzero drop probability draws its stochastic-depth
        mask from ``generator``, unless ``drop_masks`` (indexed by
        block_id) gives it; with ``shard`` (a rank's rows of a world
        batch, parallel/mesh.py) at the world's size, this rank's rows
        kept."""
        h = x.permute(0, 3, 1, 2)
        block_id = 0
        for mod in self.features:
            if not isinstance(mod[0], CNBlock):
                h = mod(h)
                continue
            for blk in mod:
                mask = None
                if train and blk.sd_prob > 0.0:
                    if drop_masks is not None:
                        mask = drop_masks[block_id]
                    else:
                        mask = draw_drop_mask(h.shape[0], blk.sd_prob,
                                              h.device, generator, shard)
                h = blk(h, mask)
                block_id += 1
        return h.permute(0, 2, 3, 1)


def convnext_tiny_26_features(num_stages: int = 7, fused_mlp: bool = False,
                              fused_whole_block: bool = False,
                              fused_dwconv: bool = False):
    """Stride threshold 100 -> 26x26 latent at 224 input
    (reference convnext_features.py:38-65)."""
    return ConvNeXtFeatures(stride_threshold=100, num_stages=num_stages,
                            fused_mlp=fused_mlp,
                            fused_whole_block=fused_whole_block,
                            fused_dwconv=fused_dwconv)


def convnext_tiny_13_features(num_stages: int = 7, fused_mlp: bool = False,
                              fused_whole_block: bool = False,
                              fused_dwconv: bool = False):
    """Stride threshold 300 -> 13x13 latent at 224 input
    (reference convnext_features.py:67-94)."""
    return ConvNeXtFeatures(stride_threshold=300, num_stages=num_stages,
                            fused_mlp=fused_mlp,
                            fused_whole_block=fused_whole_block,
                            fused_dwconv=fused_dwconv)


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
