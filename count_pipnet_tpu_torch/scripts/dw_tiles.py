"""Times each candidate halo tile (ops/cuda/block.cuh: ``DwPlan``: image
rows a CTA, channels a slab, row pieces a thread) of K7
(ops/dwconv.py:dwconv7) and of kernel A's prologue (ops/fused_block.py:
block_prologue, int8-static, f32 and bf16 taps) at the four stage
geometries of convnext_tiny_26, bf16 planes, and of K8 (ops/dwconv_bwd.py:
dwconv7_wgrad; ops/cuda/dwconv_wgrad.cu: ``WgPlan``, the tile with tile
buffers a CTA and CTAs a slab) at 128 images of the same geometries, f32
and bf16 planes, on one CUDA card. Each K7 and prologue candidate's
output is held equal, bit for bit, to the chosen tile's: the per-output
arithmetic does not depend on the tile. Each K8 plan sums in its own
order, so each is held to the plain version (dK and db within 1e-3 of
their largest |value|).

    python -m count_pipnet_tpu_torch.scripts.dw_tiles [--images 32 256]
        [--kernels k7 prologue k8]

Prints one line per kernel, geometry and batch: the ms of each candidate
that fits (CUDA events, 5 calls after 1), the fastest, and the chosen
tile with its ms. A tile is written <tr,cs,segs> as the launch resolves
it (tr evened out over an image's strips; segs 0: one piece a thread and
row where the threads of a unit outnumber the rows; the prologue always
takes 0, so its sweep varies the pixels a thread through tr and cs), a K8
plan <tr,cs,segs,bufs,ctas>; K8's second line times the fastest plan with
other numbers of CTAs a slab.
"""

import argparse
import itertools
import subprocess

import numpy as np
import torch

from count_pipnet_tpu_torch.ops import fused_block as fb
from count_pipnet_tpu_torch.ops.dwconv import dwconv7, tile_plan
from count_pipnet_tpu_torch.ops.dwconv_bwd import (dwconv7_wgrad,
                                                   dwconv7_wgrad_plain,
                                                   wgrad_plan)

GEOMETRIES = ((56, 56, 96), (28, 28, 192), (27, 27, 384), (26, 26, 768))
PROLOGUE_TILES = list(itertools.product((1, 2, 3, 4), (32, 64, 128, 256)))
K7_TILES = list(itertools.product((2, 4, 8, 16), (32, 64, 128), (0, 2)))
K8_TILES = list(itertools.product((1, 2, 4, 7, 9, 13, 14, 16, 28),
                                  (32, 64, 128), (0, 1, 2, 4), (1, 2)))
K8_IMAGES = 128


def cuda_ms(fn, iters=5, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def block_weights(c, seed):
    """Int8-static weights of a random block (numpy seed), activation
    scales of 4 (the prologue's depthwise walk does not see them)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).cuda()
    p = dict(dw_weight=n(c, 1, 7, 7) * 0.1, dw_bias=n(c) * 0.01,
             ln_weight=1 + n(c) * 0.01, ln_bias=n(c) * 0.01,
             pw1_weight=n(4 * c, c) * 0.05, pw1_bias=n(4 * c) * 0.01,
             pw2_weight=n(c, 4 * c) * 0.05, pw2_bias=n(c) * 0.01,
             layer_scale=torch.full((c,), 0.1, device="cuda"))
    scales = (torch.full((c,), 4.0, device="cuda"),
              torch.full((4 * c,), 4.0, device="cuda"))
    return p, fb.prepare_block(**p, int8=True, act_scales=scales)


def fits(prologue, h, w, c, dw_bf16, tiles):
    """{resolved plan: requested tile} of the tiles that fit."""
    out = {}
    for t in tiles:
        try:
            plan = tile_plan(prologue, h, w, c, 2, dw_bf16, t)
        except ValueError:
            continue
        out.setdefault(plan[:3], t)
    return out


def sweep(name, run, cands, chosen, line, card):
    want = run(None)
    times = {}
    for plan, t in cands.items():
        assert torch.equal(run(t), want), (name, plan)
        times[plan] = cuda_ms(lambda: run(t))
    ms = cuda_ms(lambda: run(None))
    fmt = lambda p: "<" + ",".join(map(str, p)) + ">"  # noqa: E731
    best = min(times, key=times.get)
    print(f"dw_tiles {line}: " + ", ".join(f"{fmt(p)} {v:.4f}"
                                         for p, v in times.items())
          + f" ms; fastest {fmt(best)}; chosen {fmt(chosen[:3])} "
          f"{ms:.4f} ms; every tile equal to the chosen one ({card})",
          flush=True)


def sweep_k8(h, w, c, dt, card):
    """K8's plans at K8_IMAGES images: every candidate of K8_TILES that
    fits, each held to the plain version; then the fastest with 1/2, 3/4,
    3/2 and 2 times its number of CTAs a slab."""
    rng = np.random.default_rng(c)
    x, g = (torch.from_numpy(rng.normal(size=(K8_IMAGES, h, w, c))
                             .astype(np.float32)).cuda().to(dt)
            for _ in range(2))
    ref = dwconv7_wgrad_plain(x, g)
    fmt = lambda p: "<" + ",".join(map(str, p)) + ">"  # noqa: E731

    def timed(plans):
        times = {}
        for plan in plans:
            for a, r in zip(dwconv7_wgrad(x, g, tile=plan), ref):
                lim = 1e-3 * r.abs().max().item()
                assert (a - r).abs().max().item() <= lim, plan
            times[plan] = cuda_ms(lambda: dwconv7_wgrad(x, g, tile=plan))
        return times

    cands = {}
    for t in K8_TILES:
        try:
            cands.setdefault(wgrad_plan(K8_IMAGES, h, w, c, x.element_size(),
                                        t)[:5], t)
        except ValueError:
            continue
    times = timed(cands)
    best = min(times, key=times.get)
    chosen = wgrad_plan(K8_IMAGES, h, w, c, x.element_size())[:5]
    ms = cuda_ms(lambda: dwconv7_wgrad(x, g))
    shape = f"[{K8_IMAGES}, {h}, {w}, {c}] {str(dt)[6:]}"
    print(f"dw_tiles K8 {shape}: " + ", ".join(
        f"{fmt(p)} {v:.4f}" for p, v in times.items())
        + f" ms; fastest {fmt(best)}; chosen {fmt(chosen)} {ms:.4f} ms; "
        f"every plan within 1e-3 of the plain version ({card})", flush=True)
    ctas = {best[:4] + (max(1, round(best[4] * f)),)
            for f in (0.5, 0.75, 1, 1.5, 2)}
    times = timed(sorted(ctas))
    print(f"dw_tiles K8 {shape} CTAs a slab: " + ", ".join(
        f"{fmt(p)} {v:.4f}" for p, v in times.items()) + f" ms ({card})",
        flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, nargs="+", default=[32, 256])
    ap.add_argument("--kernels", nargs="+", default=["k7", "prologue", "k8"],
                    choices=["k7", "prologue", "k8"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dw_tiles: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for images in args.images if {"k7", "prologue"} & set(args.kernels) \
            else ():
        for (h, w, c) in GEOMETRIES:
            x = torch.from_numpy(np.random.default_rng(9).normal(
                size=(images, h, w, c)).astype(np.float32)).cuda() \
                .to(torch.bfloat16)
            p, pb = block_weights(c, seed=c)
            shape = f"[{images}, {h}, {w}, {c}]"
            if "k7" in args.kernels:
                sweep("K7", lambda t: dwconv7(x, p["dw_weight"],
                                              p["dw_bias"], tile=t),
                      fits(False, h, w, c, False, K7_TILES),
                      tile_plan(False, h, w, c, 2), f"K7 {shape} bf16",
                      card)
            if "prologue" in args.kernels:
                for taps in (False, True):
                    sweep("prologue",
                          lambda t: fb.block_prologue(x, pb, dw_bf16=taps,
                                                      tile=t),
                          fits(True, h, w, c, taps, PROLOGUE_TILES),
                          tile_plan(True, h, w, c, 2, taps),
                          f"prologue {shape} int8-static, bf16 planes, "
                          f"{'bf16' if taps else 'f32'} taps", card)
            del x, pb
    if "k8" in args.kernels:
        for (h, w, c) in GEOMETRIES:
            for dt in (torch.float32, torch.bfloat16):
                sweep_k8(h, w, c, dt, card)


if __name__ == "__main__":
    main()
