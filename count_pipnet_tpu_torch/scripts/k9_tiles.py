"""Times K9's GEMM launch (ops/fused_head.py:head_logits_stats, the
split-bf16 wgmma GEMM of ops/cuda/fused_head.cu that stores the logits and
their row statistics) with each candidate tile of
ops/cuda/fused_head.cu:head_gemm, on 26x26x768 features (bf16 and f32,
the GEMM's time with the split of f32 features), P = 768, on one CUDA
card. Each candidate's logits are held to the chosen tile's (the same
products summed in the same order; the maximum difference is printed).

    python -m count_pipnet_tpu_torch.scripts.k9_tiles [--images 32 256]

Prints one line per batch and feature type: the GEMM's ms with each tile
<BN, stages, CTAs an SM>, and that of the tile K9 takes (tile 0).
"""

import argparse
import subprocess

import torch

from count_pipnet_tpu_torch.ops import fused_head as fh

# ops/cuda/fused_head.cu:head_gemm, tiles 1-4
TILES = ("<128,3,2>", "<128,4,1>", "<256,4,1>", "<64,4,2>")


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, nargs="+", default=[32, 256])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k9_tiles: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(19)
    c = 768
    prep = fh.prepare_count_head(
        5.0 / c ** 0.5 * torch.randn(c, c, device="cuda", generator=gen),
        0.5 * torch.randn(c, device="cuda", generator=gen))
    for images in args.images:
        x32 = torch.randn(images, 26, 26, c, device="cuda", generator=gen)
        for dt in (torch.bfloat16, torch.float32):
            x2 = x32.to(dt).reshape(-1, c)
            want, _ = fh.head_logits_stats(x2, prep)
            gemm, diff = [], 0.0
            for t in range(1, len(TILES) + 1):
                got, _ = fh.head_logits_stats(x2, prep, t)
                diff = max(diff, (got - want).abs().max().item())
                del got
                gemm.append(cuda_ms(lambda: fh.head_logits_stats(x2, prep,
                                                                 t)))
            assert diff <= 1e-5 * want.abs().max().item(), diff
            chosen = cuda_ms(lambda: fh.head_logits_stats(x2, prep))
            best = min(range(len(TILES)), key=gemm.__getitem__)
            print(f"k9_tiles [{images}, 26, 26, {c}] {str(dt)[6:]} -> "
                  f"P={c}: GEMM " + ", ".join(
                      f"{tl} {ms:.4f}" for tl, ms in zip(TILES, gemm))
                  + f" ms; fastest {TILES[best]}; K9's tile {chosen:.4f} ms;"
                  f" logits within {diff:.2e} of tile 0's ({card})",
                  flush=True)
            del want
        del x32, x2


if __name__ == "__main__":
    main()
