"""Gradient-based effective receptive field of the stride-modified ConvNeXt.

The port's copy of the JAX package's scripts/receptive_field_analysis.py
(reference tests/receptive_field_analysis.py): for each stage depth it
backpropagates the centre latent's channel sum to the input over seeded
normal images, accumulates the absolute input gradient, and reports the
height and width that hold 95 % of its mass. Those sizes justify the
shapes generator's object sizes (reference util/generate_shapes_data.py:
34-38). A heatmap PNG a depth is drawn where matplotlib imports; where it
does not, the sizes are printed with a one-line skip message.

    python -m count_pipnet_tpu_torch.scripts.receptive_field_analysis \
        [--stages 3 5 7] [--image_size 192] [--out_dir ./receptive_field_viz]
        [--samples 8] [--disable_cuda]

It runs on the CUDA card unless ``--disable_cuda`` is given, in float32
with TF32 off.
"""

import argparse
import os
import sys

import numpy as np
import torch

from ..models.convnext import convnext_tiny_26_features
from . import checked_device, no_tf32


def mass_width(profile):
    """Width of the centred window that holds 95 % of ``profile``'s mass."""
    profile = profile / (profile.sum() + 1e-12)
    center = len(profile) // 2
    total = 0.0
    r = 0
    while total < 0.95 and r < center:
        lo, hi = center - r, center + r + 1
        total = profile[lo:hi].sum()
        r += 1
    return 2 * r


def effective_receptive_field(num_stages, image_size, n_samples=8, seed=0,
                              state_dict=None, device="cuda"):
    """The normalised effective receptive field [image_size, image_size]
    of ``convnext_tiny_26_features(num_stages)`` and its 95 %-mass
    ``(height, width)``. The weights are ``state_dict`` where given (e.g.
    ``models/convert.py: backbone_from_jax_params`` of a flax tree), else
    the port's initialisation under ``torch.manual_seed(0)``; the images
    are ``n_samples`` normal draws of ``np.random.default_rng(seed)``.
    It runs on the card unless ``device`` is the CPU."""
    device = checked_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = convnext_tiny_26_features(num_stages=num_stages)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model = model.to(device).eval().requires_grad_(False)
    rng = np.random.default_rng(seed)
    acc = np.zeros((image_size, image_size), np.float64)
    with no_tf32():
        for _ in range(n_samples):
            x = torch.from_numpy(rng.normal(
                size=(1, image_size, image_size, 3)).astype(np.float32))
            x = x.to(device).requires_grad_(True)
            y = model(x)
            h, w = y.shape[1] // 2, y.shape[2] // 2
            (g,) = torch.autograd.grad(y[:, h, w, :].sum(), x)
            acc += g.abs()[0].sum(dim=-1).cpu().numpy()
    acc /= acc.max() + 1e-12
    width = mass_width(acc.sum(axis=0))
    height = mass_width(acc.sum(axis=1))
    return acc, (height, width)


def save_heatmap(erf, stages, size, path):
    """The heatmap PNG of one depth; False where matplotlib is missing."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    h, w = size
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.imshow(erf, cmap="inferno")
    ax.set_title(f"ERF @ {stages} stages: ~{h}x{w}px (95% mass)")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def main(argv=None):
    ap = argparse.ArgumentParser("Effective receptive field analysis")
    ap.add_argument("--stages", type=int, nargs="+", default=[3, 5, 7])
    ap.add_argument("--image_size", type=int, default=192)
    ap.add_argument("--out_dir", default="./receptive_field_viz")
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--disable_cuda", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)
    if not args.disable_cuda and not torch.cuda.is_available():
        print("error: no CUDA device; pass --disable_cuda to run on the CPU",
              file=sys.stderr)
        return 2
    device = "cpu" if args.disable_cuda else "cuda"

    os.makedirs(args.out_dir, exist_ok=True)
    for stages in args.stages:
        erf, (h, w) = effective_receptive_field(
            stages, args.image_size, n_samples=args.samples, device=device)
        path = os.path.join(args.out_dir, f"erf_stages_{stages}.png")
        where = (f"-> {path}" if save_heatmap(erf, stages, (h, w), path)
                 else "(heatmap skipped: matplotlib unavailable)")
        print(f"stages={stages}: effective receptive field ~{h}x{w}px "
              f"{where}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
