"""Times K10's GEMM launch (ops/int8_gemm.py:int8_rowscale_gemm, the s8
mode of ops/cuda/sm90.cuh with the row-scale epilogue) with each candidate
tile of ops/cuda/int8_gemm.cu:rowscale_gemm_as, at the two stride-1
downsample geometries of convnext_tiny_26 (the 2x2 im2col of 28x28x192 ->
384 and of 27x27x384 -> 768), bf16 in and out, on one CUDA card; each
candidate's output is held equal to the chosen tile's (the sums are exact,
so any tile gives the same bits).

    python -m count_pipnet_tpu_torch.scripts.k10_tiles [--images 256]

Prints one line per geometry and batch: the row quantize pass's ms, the ms
of each tile <BN, stages, CTAs an SM>, and which tile K10 takes (tile 0).
"""

import argparse
import subprocess

import torch

from count_pipnet_tpu_torch.models.quantized import im2col_2x2
from count_pipnet_tpu_torch.ops import int8_gemm as g

DOWNSAMPLES = ((28, 28, 192, 384), (27, 27, 384, 768))
# ops/cuda/int8_gemm.cu:rowscale_gemm_as, tiles 1-5
TILES = ("<128,3,2>", "<256,4,1>", "<192,3,1>", "<96,3,2>", "<64,4,2>")


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
    ap.add_argument("--images", type=int, nargs="+", default=[256])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k10_tiles: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(17)
    for images in args.images:
        for (h, w, cin, cout) in DOWNSAMPLES:
            conv = 0.02 * torch.randn(cout, cin, 2, 2, device="cuda",
                                      generator=gen)
            bias = 0.02 * torch.randn(cout, device="cuda", generator=gen)
            prep = g.prepare_gemm(
                conv.permute(2, 3, 1, 0).reshape(4 * cin, cout), bias)
            hn = torch.randn(images, h, w, cin, device="cuda",
                             generator=gen).to(torch.bfloat16)
            cols = im2col_2x2(hn).reshape(-1, 4 * cin)
            xq, asc = g.quant_rows_int8(cols)
            want = g.int8_rowscale_gemm(xq, asc, prep, torch.bfloat16)
            times = []
            for t in range(1, len(TILES) + 1):
                got = g.int8_rowscale_gemm(xq, asc, prep, torch.bfloat16, t)
                assert torch.equal(got, want), (cin, t)
                times.append(cuda_ms(lambda: g.int8_rowscale_gemm(
                    xq, asc, prep, torch.bfloat16, t)))
            chosen = cuda_ms(lambda: g.int8_rowscale_gemm(
                xq, asc, prep, torch.bfloat16))
            qms = cuda_ms(lambda: g.quant_rows_int8(cols))
            best = min(range(len(TILES)), key=times.__getitem__)
            print(f"k10_tiles [{cols.shape[0]}, {4 * cin}] -> {cout} "
                  f"({images} images): quantize pass {qms:.4f} ms; GEMM "
                  + ", ".join(f"{tl} {ms:.4f}"
                              for tl, ms in zip(TILES, times))
                  + f" ms; fastest {TILES[best]}; K10's tile "
                  f"{chosen:.4f} ms ({card})", flush=True)
            del hn, cols, xq, asc


if __name__ == "__main__":
    main()
