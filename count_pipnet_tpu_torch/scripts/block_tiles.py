"""Times kernel A's two int8 GEMM launches (ops/fused_block.py:block_up and
block_down, the s8 mode of ops/cuda/sm90.cuh with the int8-static
epilogues) with each candidate tile of ops/cuda/block.cuh:gemm_tiled, at
the four stage geometries of convnext_tiny_26, bf16 planes, on one CUDA
card; each candidate's output is held equal to the chosen tile's (the sums
are exact, so any tile gives the same bits). Then kernel C's head GEMM
(ops/gumbel_head.py:block_head_keys, GEMM 2 with the argmax epilogue) at
26x26x768 in its int8-static and bf16 modes with each tile: int8 keys held
equal, the share of equal bf16 keys printed (a tile may sum in another
order).

    python -m count_pipnet_tpu_torch.scripts.block_tiles [--images 32 256]

Prints one line per GEMM, geometry and batch: the ms of each tile
<BN, stages, CTAs an SM>, and which tile kernels A and C take (tile 0).
"""

import argparse
import subprocess

import numpy as np
import torch

from count_pipnet_tpu_torch.ops import fused_block as fb
from count_pipnet_tpu_torch.ops import gumbel_head as gh

GEOMETRIES = ((56, 56, 96), (28, 28, 192), (27, 27, 384), (26, 26, 768))
# ops/cuda/block.cuh:gemm_tiled, tiles 1-5
TILES = ("<128,3,2>", "<256,4,1>", "<96,3,2>", "<64,4,2>", "<192,3,1>")


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


def prepared(c, x, seed, int8=True):
    """Int8-static weights of a random block (numpy seed), its activation
    scales calibrated on ``x``; ``int8=False``: its bf16 weights."""
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).cuda()
    p = dict(dw_weight=n(c, 1, 7, 7) * 0.1, dw_bias=n(c) * 0.01,
             ln_weight=1 + n(c) * 0.01, ln_bias=n(c) * 0.01,
             pw1_weight=n(4 * c, c) * 0.05, pw1_bias=n(4 * c) * 0.01,
             pw2_weight=n(c, 4 * c) * 0.05, pw2_bias=n(c) * 0.01,
             layer_scale=torch.full((c,), 0.1, device="cuda"))
    d = torch.nn.functional.conv2d(
        x.float().permute(0, 3, 1, 2), p["dw_weight"], p["dw_bias"],
        padding=3, groups=c).permute(0, 2, 3, 1)
    ln = torch.nn.functional.layer_norm(d, (c,), p["ln_weight"],
                                        p["ln_bias"], eps=1e-6)
    a = torch.nn.functional.gelu(ln @ p["pw1_weight"].t() + p["pw1_bias"],
                                 approximate="tanh")
    scales = (ln.abs().amax(dim=(0, 1, 2)), a.abs().amax(dim=(0, 1, 2)))
    return fb.prepare_block(**p, int8=int8,
                            act_scales=scales if int8 else None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, nargs="+", default=[32, 256])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("block_tiles: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for images in args.images:
        for (h, w, c) in GEOMETRIES:
            x = torch.from_numpy(np.random.default_rng(9).normal(
                size=(images, h, w, c)).astype(np.float32)).cuda() \
                .to(torch.bfloat16)
            pb = prepared(c, x[:8], seed=c)
            n = fb.block_prologue(x, pb)
            hid = fb.block_up(n, pb)
            out = fb.block_down(hid, x, pb)
            for name, run, want in (
                    ("GEMM 1", lambda t: fb.block_up(n, pb, t), hid),
                    ("GEMM 2", lambda t: fb.block_down(hid, x, pb, t), out)):
                times = []
                for t in range(1, len(TILES) + 1):
                    assert torch.equal(run(t), want), (name, c, t)
                    times.append(cuda_ms(lambda: run(t)))
                chosen = cuda_ms(lambda: run(0))
                best = min(range(len(TILES)), key=times.__getitem__)
                print(f"block_tiles {name} [{images}, {h}, {w}, {c}] int8: "
                      + ", ".join(f"{tl} {ms:.4f}"
                                  for tl, ms in zip(TILES, times))
                      + f" ms; fastest {TILES[best]}; kernel A's tile "
                      f"{chosen:.4f} ms ({card})", flush=True)
            del n, hid, out, x
        head_tiles(images, card)


def head_tiles(images, card):
    """Kernel C's head GEMM with each tile at ``images`` of 26x26x768."""
    h, w, c = GEOMETRIES[-1]
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(images, h, w, c)).astype(np.float32)).cuda() \
        .to(torch.bfloat16)
    for mode in ("int8", "bf16"):
        pb = prepared(c, x[:8], seed=c, int8=mode == "int8")
        hid = fb.block_up(fb.block_prologue(x, pb), pb)
        run = lambda t: gh.block_head_keys(hid, x, pb, seed=1, tile=t)  # noqa
        want = run(0)
        times, same = [], []
        tiles = TILES if mode == "int8" else TILES[:4]  # no 192-wide bf16
        for t in range(1, len(tiles) + 1):
            same.append((run(t) == want).float().mean().item())
            assert mode == "bf16" or same[-1] == 1.0, (mode, t)
            times.append(cuda_ms(lambda: run(t)))
        chosen = cuda_ms(lambda: run(0))
        best = min(range(len(tiles)), key=times.__getitem__)
        print(f"block_tiles head GEMM [{images}, {h}, {w}, {c}] {mode}: "
              + ", ".join(f"{tl} {ms:.4f}" for tl, ms in zip(tiles, times))
              + f" ms; fastest {tiles[best]}; kernel C's tile {chosen:.4f} "
              f"ms; keys equal to its: "
              + ", ".join(f"{v:.4f}" for v in same) + f" ({card})",
              flush=True)
        del pb, hid


if __name__ == "__main__":
    main()
