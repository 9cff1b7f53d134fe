"""Serving-forward variants of the whole-block int8 backbone: f32 against
bf16 depthwise taps.

Port of scripts/bench_serving_variants.py. Times
``fused_block_convnext_apply`` on the full ``convnext_tiny_26`` (all
stages, 224x224, ``num_features=0``, gumbel, one-hot, ``max_count`` 3, 200
classes, parameters from the port's initialisers under a fixed seed), then
kernel B (``gumbel_hard_counts``, seed 7), for two variants, and prints the
counts agreement between them:

* ``int8+ds_int8``: ``int8_min_dim=384``, f32 taps;
* ``int8+ds_int8+dwbf16``: the same with ``dw_bf16=True``.

The names are the JAX script's. Neither variant sets ``int8_downsample`` or
activation scales: both run kernel A's dynamic per-row int8 mode at
C >= 384 and bf16 GEMMs below.

    python -m count_pipnet_tpu_torch.scripts.bench_serving_variants
    python -m count_pipnet_tpu_torch.scripts.bench_serving_variants \\
        --device cpu --batch 2 --iters 1

Each time is the mean of ``--iters`` calls after one warm-up call, on the
host clock, ended by a device-to-host copy of the last counts.
"""

import argparse
import time

import numpy as np
import torch

from ..models import get_count_network, serving
from ..models.quantized import fused_block_convnext_apply, prepare_fused_blocks

__all__ = ["VARIANTS", "build_model", "variant_backbones", "variant_forwards",
           "time_variants", "main"]

VARIANTS = {"int8+ds_int8": dict(int8_min_dim=384, dw_bf16=False),
            "int8+ds_int8+dwbf16": dict(int8_min_dim=384, dw_bf16=True)}
HEAD_SEED = 7


def build_model(seed: int = 0):
    """The JAX script's model: ``convnext_tiny_26``, 200 classes, its
    parameters drawn by the port's initialisers after
    ``torch.manual_seed(seed)``."""

    class Args:
        net = "convnext_tiny_26"
        num_features = 0
        use_mid_layers = False
        num_stages = 7
        bias = False
        activation = "gumbel_softmax"
        intermediate_layer = "onehot"
        positive_grad_strategy = None
        backward_clamp_strategy = "Identity"

    torch.manual_seed(seed)
    model, _ = get_count_network(200, Args, max_count=3, use_ste=True)
    return model.eval()


def variant_backbones(model):
    """``{name: backbone(x) -> [B, H, W, C] bf16 features}`` for
    :data:`VARIANTS`: ``fused_block_convnext_apply`` with the variant's
    flags (bf16 planes). The kernel weights are prepared once, on the
    model's device."""
    fns = {}
    for name, kw in VARIANTS.items():
        prepared = prepare_fused_blocks(model.backbone, None,
                                        kw["int8_min_dim"], fused_head=False)

        def backbone(x, prepared=prepared, dw_bf16=kw["dw_bf16"]):
            return fused_block_convnext_apply(model.backbone, x,
                                              prepared=prepared,
                                              dw_bf16=dw_bf16)

        fns[name] = backbone
    return fns


def variant_forwards(model):
    """``{name: fwd(x) -> [B, C] counts}`` for :data:`VARIANTS`: the
    variant's backbone (:func:`variant_backbones`), then kernel B at seed
    :data:`HEAD_SEED`, looked up in models/serving.py as the serving
    forwards look it up."""
    return {name: lambda x, backbone=backbone: serving.gumbel_hard_counts(
        backbone(x), HEAD_SEED)
        for name, backbone in variant_backbones(model).items()}


def time_variants(fwds, x, iters: int):
    """``{name: (seconds per call, counts on the host)}``: one warm-up call,
    whose counts are kept, then ``iters`` calls ended by a copy of the last
    counts to the host."""
    out = {}
    for name, fwd in fwds.items():
        counts = fwd(x).cpu()
        t0 = time.perf_counter()
        for _ in range(iters):
            r = fwd(x)
        r.cpu()
        out[name] = ((time.perf_counter() - t0) / iters, counts)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device (use --device cpu for the plain versions)")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu (plain versions of the kernels)"
    print(f"device: {where}; batch {args.batch}, 224x224, {args.iters} "
          f"timed calls", flush=True)
    model = build_model().to(device)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(args.batch, 224, 224, 3)).astype(np.float32)).to(device)
    results = time_variants(variant_forwards(model), x, args.iters)
    for name, (dt, _) in results.items():
        print(f"{name:22s}: {dt * 1e3:7.2f} ms  ({args.batch / dt:6.0f} "
              f"img/s)", flush=True)
    names = list(results)
    for other in names[1:]:
        agree = (results[names[0]][1] == results[other][1]).float().mean()
        print(f"counts agreement {names[0]} vs {other}: {agree.item():.4f}")
    return results


if __name__ == "__main__":
    main()
