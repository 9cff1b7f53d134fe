"""Models of the port: ConvNeXt and ResNet backbones, PIP-Net,
Count-PIPNet, the parameter bridge from the JAX package, and the serving
forwards."""

from .convnext import ConvNeXtFeatures, convnext_tiny_13_features, \
    convnext_tiny_26_features
from .convert import backbone_from_jax_params, from_jax_params
from .pipnet import CountPIPNet, PIPNet, get_count_network, get_pipnet
from .resnet import ResNetFeatures

__all__ = ["ConvNeXtFeatures", "convnext_tiny_26_features",
           "convnext_tiny_13_features", "CountPIPNet", "get_count_network",
           "PIPNet", "get_pipnet", "from_jax_params",
           "backbone_from_jax_params", "ResNetFeatures"]
