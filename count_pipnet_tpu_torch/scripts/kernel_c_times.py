"""Times kernel C (ops/gumbel_head.py:fused_block_gumbel_counts) through its
public wrapper at 32 and 256 images of 26x26x768, bf16 planes, Philox
noise, in its int8-static and bf16 modes, on one CUDA card; random block
weights from a numpy seed, int8 scales calibrated on 8 of the images. It
uses only ``prepare_block`` and ``fused_block_gumbel_counts``, so it also
times an older checkout of the package: run it by its path with
``PYTHONPATH`` set to that checkout.

    python3 count_pipnet_tpu_torch/scripts/kernel_c_times.py

Prints one ``time kernel C ...`` line per batch and mode (CUDA events, 10
calls after 2), with the card's name and power limit.
"""

import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from count_pipnet_tpu_torch.ops.fused_block import prepare_block
from count_pipnet_tpu_torch.ops.gumbel_head import fused_block_gumbel_counts


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("kernel_c_times: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    c = 768
    rng = np.random.default_rng(c)
    n = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).cuda()
    p = dict(dw_weight=n(c, 1, 7, 7) * 0.1, dw_bias=n(c) * 0.01,
             ln_weight=1 + n(c) * 0.01, ln_bias=n(c) * 0.01,
             pw1_weight=n(4 * c, c) * 0.05, pw1_bias=n(4 * c) * 0.01,
             pw2_weight=n(c, 4 * c) * 0.05, pw2_bias=n(c) * 0.01,
             layer_scale=torch.full((c,), 0.1, device="cuda"))
    for images in (32, 256):
        x = torch.from_numpy(np.random.default_rng(9).normal(
            size=(images, 26, 26, c)).astype(np.float32)).cuda()
        d = F.conv2d(x[:8].permute(0, 3, 1, 2), p["dw_weight"],
                     p["dw_bias"], padding=3, groups=c).permute(0, 2, 3, 1)
        ln = F.layer_norm(d, (c,), p["ln_weight"], p["ln_bias"], eps=1e-6)
        a = F.gelu(ln @ p["pw1_weight"].t() + p["pw1_bias"],
                   approximate="tanh")
        scales = (ln.abs().amax(dim=(0, 1, 2)), a.abs().amax(dim=(0, 1, 2)))
        xb = x.to(torch.bfloat16)
        del x, d, ln, a
        for mode in ("int8", "bf16"):
            pb = prepare_block(**p, int8=mode == "int8",
                               act_scales=scales if mode == "int8" else None)
            counts = fused_block_gumbel_counts(xb, pb, seed=1)
            assert (counts.sum(dim=1) == 676).all()
            ms = cuda_ms(lambda: fused_block_gumbel_counts(xb, pb, seed=1))
            print(f"time kernel C [{images}, 26, 26, {c}] {mode}, bf16 "
                  f"planes: {ms:.4f} ms ({card})", flush=True)


if __name__ == "__main__":
    main()
