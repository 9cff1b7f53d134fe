"""Prints digests of the depthwise kernels' outputs on one CUDA card, so
that two checkouts can be held equal bit for bit: K7 (ops/dwconv.py:
dwconv7) on f32 and bf16 planes with f32 and bf16 outputs at the four
stage geometries of convnext_tiny_26 and an odd 5x3 plane; kernel A's
prologue (ops/fused_block.py:block_prologue) in its bf16, int8-static and
dynamic int8 modes with f32 and bf16 taps, on bf16 and f32 planes; kernel
C's counts (ops/gumbel_head.py:fused_block_gumbel_counts) in its bf16 and
int8-static modes; and K8 (ops/dwconv_bwd.py:dwconv7_wgrad) on f32 and
bf16 planes at the same geometries. Inputs and weights come from fixed
numpy seeds. It uses only the public wrappers, so it also runs an older
checkout of the package: run it by its path with ``PYTHONPATH`` set to
that checkout.

    python3 count_pipnet_tpu_torch/scripts/dw_digest.py [--times]

Prints one ``digest ...`` line per output (sha256 of its bytes, first 16
hex digits) and an ``all`` line over every output but K8's. K8's lines
and their own ``digest K8 all`` line follow: K8's sums run in the order
its plan fixes, so a checkout with another K8 design prints other bits,
and only two runs of one checkout are expected to agree. ``--times`` then
times, through the same wrappers (CUDA events, 10 calls after 2), K7 at
128 images of each stage geometry (bf16 planes) beside
``F.conv2d(groups=C)``, K8 at 128 images of each geometry on f32 and bf16
planes beside ``aten.convolution_backward`` (its weight and bias
gradients), and the prologue at 32 and 256 images (bf16 planes) in each
mode and tap type, one ``time ...`` line each, so that one call can time
two checkouts alike.
"""

import argparse
import hashlib
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from count_pipnet_tpu_torch.ops.dwconv import dwconv7
from count_pipnet_tpu_torch.ops.dwconv_bwd import dwconv7_wgrad
from count_pipnet_tpu_torch.ops.fused_block import (block_prologue,
                                                    prepare_block)
from count_pipnet_tpu_torch.ops.gumbel_head import fused_block_gumbel_counts

GEOMETRIES = ((56, 56, 96), (28, 28, 192), (27, 27, 384), (26, 26, 768))
ODD = (5, 3, 96)
IMAGES = 4


def digest(t):
    return hashlib.sha256(t.detach().contiguous().cpu().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()[:16]


def block(c, seed, mode):
    """Random block weights (numpy seed) prepared for ``mode``; static
    scales from the plain depthwise conv and LayerNorm of a seeded plane."""
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).cuda()
    p = dict(dw_weight=n(c, 1, 7, 7) * 0.1, dw_bias=n(c) * 0.01,
             ln_weight=1 + n(c) * 0.01, ln_bias=n(c) * 0.01,
             pw1_weight=n(4 * c, c) * 0.05, pw1_bias=n(4 * c) * 0.01,
             pw2_weight=n(c, 4 * c) * 0.05, pw2_bias=n(c) * 0.01,
             layer_scale=torch.full((c,), 0.1, device="cuda"))
    scales = (torch.from_numpy(rng.uniform(2, 6, c).astype(np.float32))
              .cuda(), torch.from_numpy(rng.uniform(2, 6, 4 * c)
                                        .astype(np.float32)).cuda())
    if mode == "bf16":
        return p, prepare_block(**p, int8=False)
    if mode == "int8-static":
        return p, prepare_block(**p, int8=True, act_scales=scales)
    return p, prepare_block(**p, int8=True)


def cuda_ms(fn, iters=10, warmup=2):
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


def times(card):
    """K7 and the prologue timed through their wrappers."""
    bf16 = torch.bfloat16
    for (h, w, c) in GEOMETRIES:
        rng = np.random.default_rng(c)
        x = torch.from_numpy(rng.normal(size=(128, h, w, c))
                             .astype(np.float32)).cuda().to(bf16)
        wt = torch.from_numpy((0.1 * rng.normal(size=(c, 1, 7, 7)))
                              .astype(np.float32)).cuda()
        bs = torch.from_numpy(rng.normal(size=c).astype(np.float32)).cuda()
        xl, wl, bl = x.permute(0, 3, 1, 2), wt.to(bf16), bs.to(bf16)
        ms = cuda_ms(lambda: dwconv7(x, wt, bs))
        lms = cuda_ms(lambda: F.conv2d(xl, wl, bl, padding=3, groups=c))
        print(f"time K7 [128, {h}, {w}, {c}] bf16: kernel {ms:.4f} ms, "
              f"F.conv2d {lms:.4f} ms ({card})", flush=True)
        g = torch.from_numpy(rng.normal(size=(128, h, w, c))
                             .astype(np.float32)).cuda()
        for dt in (torch.float32, bf16):
            xd, gd = x.to(dt), g.to(dt)
            xl, gl = xd.permute(0, 3, 1, 2), gd.permute(0, 3, 1, 2)
            wl = wt.to(dt)
            ms = cuda_ms(lambda: dwconv7_wgrad(xd, gd))
            lms = cuda_ms(lambda: torch.ops.aten.convolution_backward(
                gl, xl, wl, [c], [1, 1], [3, 3], [1, 1], False, [0, 0], c,
                [False, True, True]))
            print(f"time K8 [128, {h}, {w}, {c}] {str(dt)[6:]}: kernel "
                  f"{ms:.4f} ms, convolution_backward {lms:.4f} ms ({card})",
                  flush=True)
        del x, xl, g, xd, gd, gl
    for (h, w, c) in GEOMETRIES:
        for images in (32, 256):
            x = torch.from_numpy(np.random.default_rng(9).normal(
                size=(images, h, w, c)).astype(np.float32)).cuda().to(bf16)
            for mode in ("bf16", "int8-static", "int8-dynamic"):
                _, pb = block(c, seed=c, mode=mode)
                for taps in (False, True):
                    ms = cuda_ms(lambda: block_prologue(x, pb, dw_bf16=taps))
                    print(f"time prologue [{images}, {h}, {w}, {c}] {mode}, "
                          f"{'bf16' if taps else 'f32'} taps: {ms:.4f} ms "
                          f"({card})", flush=True)
            del x


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--times", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dw_digest: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    f32, bf16 = torch.float32, torch.bfloat16
    every = hashlib.sha256()

    def show(what, t):
        d = digest(t)
        every.update(d.encode())
        print(f"digest {what}: {d}", flush=True)

    for (h, w, c) in GEOMETRIES + (ODD,):
        rng = np.random.default_rng(h * 1000 + c)
        x = torch.from_numpy(rng.normal(size=(IMAGES, h, w, c))
                             .astype(np.float32)).cuda()
        wt = torch.from_numpy((0.1 * rng.normal(size=(c, 1, 7, 7)))
                              .astype(np.float32)).cuda()
        bs = torch.from_numpy(rng.normal(size=c).astype(np.float32)).cuda()
        for dt in (f32, bf16):
            for ot in (f32, bf16):
                show(f"K7 {IMAGES}x{h}x{w}x{c} {str(dt)[6:]} plane, "
                     f"{str(ot)[6:]} out",
                     dwconv7(x.to(dt), wt, bs, out_dtype=ot))
        for mode in ("bf16", "int8-static", "int8-dynamic"):
            _, pb = block(c, seed=c, mode=mode)
            for dt in (bf16, f32):
                for taps in (False, True):
                    n = block_prologue(x.to(dt), pb, dw_bf16=taps)
                    what = (f"prologue {mode} {IMAGES}x{h}x{w}x{c} "
                            f"{str(dt)[6:]} plane, "
                            f"{'bf16' if taps else 'f32'} taps")
                    if mode == "int8-dynamic":
                        show(what, n[0])
                        show(what + " row scales", n[1])
                    else:
                        show(what, n)
    h, w, c = GEOMETRIES[-1]
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(8, h, w, c)).astype(np.float32)).cuda().to(bf16)
    for mode in ("bf16", "int8-static"):
        _, pb = block(c, seed=c + 1, mode=mode)
        for seed in (1, 2):
            show(f"kernel C {mode} 8x{h}x{w}x{c} bf16 planes, seed {seed}",
                 fused_block_gumbel_counts(x, pb, seed=seed))
    print(f"digest all: {every.hexdigest()[:16]} ({card})", flush=True)
    k8 = hashlib.sha256()
    for (h, w, c) in GEOMETRIES + (ODD,):
        rng = np.random.default_rng(h * 1000 + c + 1)
        x, g = (torch.from_numpy(rng.normal(size=(IMAGES, h, w, c))
                                 .astype(np.float32)).cuda()
                for _ in range(2))
        for dt in (f32, bf16):
            for name, t in zip(("dK", "db"),
                               dwconv7_wgrad(x.to(dt), g.to(dt))):
                d = digest(t)
                k8.update(d.encode())
                print(f"digest K8 {IMAGES}x{h}x{w}x{c} {str(dt)[6:]} planes "
                      f"{name}: {d} (not expected to equal another K8 "
                      f"design's bits)", flush=True)
    print(f"digest K8 all: {k8.hexdigest()[:16]} ({card})", flush=True)
    if args.times:
        times(card)


if __name__ == "__main__":
    main()
