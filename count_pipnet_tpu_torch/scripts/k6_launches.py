"""Device time of each kernel that one K6 call (``fused_mlp_bwd``, the
backward of the ConvNeXt block MLP) launches, at a main-phase step's shapes
on one CUDA card: 128 images at the four stage geometries of
convnext_tiny_26, x bf16, the cotangent f32 at C = 96 (stage 1 ends in a
LayerNorm) and bf16 behind the downsample convs. The sums come from
torch.profiler, the whole call from CUDA events.

    python -m count_pipnet_tpu_torch.scripts.k6_launches [--images 128]

It imports ``count_pipnet_tpu_torch`` from the working directory, so run
from a checkout it measures that checkout's K6 (two checkouts compare in
turns with one command each, on one card).
"""

import argparse
import re
import subprocess
import sys

import numpy as np
import torch

GEOMETRIES = ((56, 56, 96), (28, 28, 192), (27, 27, 384), (26, 26, 768))


def mlp_params(c, seed):
    """Random block-body parameters on the card (numpy seed)."""
    rng = np.random.default_rng(seed)

    def n(*s, sc=1.0):
        return torch.from_numpy((rng.normal(size=s) * sc).astype(
            np.float32)).cuda()

    return dict(ln_scale=1 + n(c, sc=0.1), ln_bias=n(c, sc=0.1),
                w1=n(4 * c, c, sc=0.05), b1=n(4 * c, sc=0.05),
                w2=n(c, 4 * c, sc=0.05), b2=n(c, sc=0.05),
                gamma=n(c, sc=0.5))


def short(name):
    """A kernel's name without its namespaces, template arguments and
    parameters."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    name = re.split(r"[<(]", name, maxsplit=1)[0]
    return name.split("::")[-1] or name


def device_us(e):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        t = getattr(e, attr, None)
        if t is not None:
            return t
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k6_launches: no CUDA device", file=sys.stderr)
        return 1
    from count_pipnet_tpu_torch.ops.fused_mlp_bwd import fused_mlp_bwd
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(7)
    for h, w, c in GEOMETRIES:
        p = mlp_params(c, seed=c)
        r = args.images * h * w
        gdt = torch.float32 if c == 96 else torch.bfloat16
        x = torch.randn(r, c, device="cuda", generator=gen).to(torch.bfloat16)
        g = (0.1 * torch.randn(r, c, device="cuda", generator=gen)).to(gdt)

        def call():
            return fused_mlp_bwd(x, g, **p)

        for _ in range(2):
            call()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(args.iters):
            call()
        e1.record()
        torch.cuda.synchronize()
        total = e0.elapsed_time(e1) / args.iters
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                call()
            torch.cuda.synchronize()
        sums = {}
        for e in prof.key_averages():
            t = device_us(e)
            if t > 0:
                k = short(e.key)
                us, n = sums.get(k, (0.0, 0))
                sums[k] = (us + t, n + e.count)
        parts = "; ".join(
            f"{k} {us / 1e3 / args.iters:.3f} ms x{n // args.iters}"
            for k, (us, n) in sorted(sums.items(), key=lambda kv: -kv[1][0]))
        print(f"K6 launches [{args.images}x{h}x{w}x{c} x bf16, g "
              f"{str(gdt)[6:]}]: call {total:.3f} ms (CUDA events); "
              f"profiler per call: {parts} ({card})", flush=True)
        del x, g, p
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
