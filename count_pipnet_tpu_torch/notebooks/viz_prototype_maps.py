"""Prototype-map visualization for a finished run.

The port's copy of notebooks/viz_prototype_maps.py, the script analogue
of the reference's ``notebooks/viz_prototype_maps.ipynb``: reload a
trained run from its saved args and best checkpoint, rebuild the
projection loader, and render the full prototype visualization tree —
top-k patch grids plus the rich feature-map artifacts (original+rect,
side-by-side heatmap, masked overlay, count debug txt). The projection
set is scored on the card unless ``--disable_cuda`` is given.

Usage:
    python -m count_pipnet_tpu_torch.notebooks.viz_prototype_maps \\
        --run_dir ./runs/<run> [--checkpoint net_best] \\
        [--out_folder viz_prototype_maps] [--k 10] [--disable_cuda]
"""

import argparse
import os
import sys
import types


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run_dir", type=str, required=True)
    ap.add_argument("--checkpoint", type=str, default="net_best")
    ap.add_argument("--out_folder", type=str,
                    default="viz_prototype_maps")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--max_maps", type=int, default=3)
    ap.add_argument("--disable_cuda", action="store_true",
                    help="run on the CPU; without it a CUDA device is "
                         "required")
    args = ap.parse_args(argv)

    import torch

    from ..data.registry import get_dataloaders
    from ..interpret.interpret_idg import load_model_for_interpretation
    from ..interpret.vis_pipnet import vizualize_network

    if not args.disable_cuda and not torch.cuda.is_available():
        print("error: no CUDA device; pass --disable_cuda to run on the "
              "CPU", file=sys.stderr)
        return 2
    model, run_args = load_model_for_interpretation(
        args.run_dir, args.checkpoint,
        "cpu" if args.disable_cuda else "cuda")
    loaders = get_dataloaders(run_args)
    projectloader, classes = loaders[4], loaders[-1]

    topks = vizualize_network(
        types.SimpleNamespace(model=model), projectloader, len(classes),
        args.out_folder, run_args, k=args.k, are_pretraining_prototypes=False,
        plot_histograms=False, visualize_prototype_maps=True,
        plot_topk=True, max_feature_maps_per_prototype=args.max_maps)
    out = os.path.join(run_args.log_dir, args.out_folder)
    print(f"{len(topks)} prototypes rendered under {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
