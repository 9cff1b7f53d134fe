"""Latent -> pixel patch geometry.

Port of count_pipnet_tpu/utils/func.py:get_patch_size (reference
util/func.py:3-15).
"""

__all__ = ["get_patch_size"]


def get_patch_size(image_size: int, wshape: int, patchsize: int = 32):
    """Patch size and stride of the latent grid in pixel space: patch =
    32, skip = round((image_size - patch) / (wshape - 1))."""
    skip = round((image_size - patchsize) / (wshape - 1))
    return patchsize, skip
