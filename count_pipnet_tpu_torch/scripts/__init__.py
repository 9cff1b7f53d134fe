"""Command-line scripts of the PyTorch port (``python -m
count_pipnet_tpu_torch.scripts.<name>``)."""

import contextlib

import torch


def checked_device(device):
    """``torch.device(device)``; a CUDA device where no card is present
    raises (the tools run on the card unless the caller asks for the
    CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' (or "
                           "--disable_cuda) to run on the CPU")
    return device


@contextlib.contextmanager
def no_tf32():
    """float32 convolutions and matmuls in full float32 (TF32 off) inside
    the block, the previous settings restored after it."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
