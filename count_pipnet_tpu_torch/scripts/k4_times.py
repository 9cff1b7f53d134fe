"""Times kernel B (K4, ops/gumbel_head.py:gumbel_hard_counts) through its
public wrapper on one CUDA card, at the add-on widths P = 16, 64, 256 and
768, f32 and bf16 logits, 32 and 256 images of 26x26 (the 224x224 stage-4
plane), Philox noise, beside two PyTorch yardsticks of the same function:
``argmax(logits + noise) -> one_hot -> sum`` with the noise drawn before
the timed call, and the same with its own ``-log(-log(rand))`` draw inside
it (the kernel draws its noise); each as device time (torch.profiler), the
kernel also as CUDA-event time a call, host share included. Logits are
random normal from a seeded CUDA generator. Each reading also prints a
sha256 digest of the counts, and one ``digest K4 all`` line covers them
all. The bound, the event timer, the yardstick and the model come from
the ``chip_smoke.py`` of this script's own tree, loaded by its path; the
kernel is the one of whatever checkout ``PYTHONPATH`` names, so the script
also times an older checkout:

    PYTHONPATH=. python3 count_pipnet_tpu_torch/scripts/k4_times.py \
        [--serve] [--sass DIR]

``--serve``: images/s of the 256-prototype add-on gumbel route
(``make_gumbel_serving_fn``, int8-static scales calibrated on 64 images;
``chip_smoke.build_model``) at batch 32 and 256, host clock around 5
calls after 2. ``--sass DIR``: kernel B's SASS (cuobjdump) into DIR, its
instructions counted by opcode (what the built kernel issues, beside
``chip_smoke.K4_INSTRUCTIONS``, what the function needs). A call's
CUDA-event time is the median of 5 readings, each around 100 calls after
10; device times are over 10 calls (5 for the yardsticks) after 2;
with the card's name and power limit, and K4's bound
(``chip_smoke.k4_bound``).
"""

import argparse
import collections
import hashlib
import importlib.util
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from count_pipnet_tpu_torch.ops.gumbel_head import gumbel_hard_counts

WIDTHS = (16, 64, 256, 768)
# a SASS line's opcode: after its address and an optional predicate
OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)")


def this_trees_smoke():
    """The chip_smoke.py beside this script's package, as a module (it
    imports only the standard library and numpy until a phase runs)."""
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = this_trees_smoke()


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_ms(fn, iters=10):
    """Device time of ``fn`` in ms a call: the self device time of every
    kernel and memset it launches (torch.profiler), over ``iters`` calls
    after 2; free of the host's share, which the CUDA-event time of a call
    of some 0.03 ms carries."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):  # a profile now and then drops device events
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        # every call launches the same kernels: each one ``iters`` times
        if events and all(e.count % iters == 0 for e in events):
            return sum(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
                       for e in events) / 1e3 / iters
    raise RuntimeError("k4_times: the profiler dropped device events")


def own_draw(logits):
    """The yardstick with its own noise: chip_smoke.head_library after a
    ``-log(-log(rand))`` draw."""
    gumbel = -torch.log(-torch.log(torch.rand(logits.shape,
                                              device=logits.device)))
    return smoke.head_library(logits, gumbel)


def digest(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def kernel_times(card, sms, sm_hz):
    gen = torch.Generator(device="cuda").manual_seed(4)
    every = hashlib.sha256()
    for images in (32, 256):
        for p in WIDTHS:
            f32 = torch.randn(images, 26, 26, p, device="cuda",
                              generator=gen)
            gumbel = -torch.log(-torch.log(torch.rand(
                f32.shape, device="cuda", generator=gen)))
            for x in (f32, f32.to(torch.bfloat16)):
                what = f"[{images}, 26, 26, {p}] {str(x.dtype)[6:]}"
                counts = gumbel_hard_counts(x, seed=1)
                assert (counts.sum(dim=1) == 676).all(), what
                dg = digest(counts)
                every.update(dg.encode())
                run = lambda: gumbel_hard_counts(x, seed=1)  # noqa: E731
                # a call's time is mostly the host's: the median of five
                ms = statistics.median(smoke.cuda_ms(run, iters=100,
                                                     warmup=10)
                                       for _ in range(5))
                dev = device_ms(run)
                lib = device_ms(lambda: smoke.head_library(x, gumbel),
                                iters=5)
                own = device_ms(lambda: own_draw(x), iters=5)
                bnd, by = smoke.k4_bound(images, 676, p, x.element_size(),
                                         sms, sm_hz)
                print(f"time K4 {what}: kernel {dev:.4f} ms on the device "
                      f"({ms:.4f} a call), library {lib:.4f} ms, library "
                      f"with its draw {own:.4f} ms, bound {bnd:.4f} ms "
                      f"({by}); digest {dg} ({card})", flush=True)
            del f32, gumbel
    print(f"digest K4 all: {every.hexdigest()[:16]}", flush=True)


def serve_times(card):
    from count_pipnet_tpu_torch.models.quantized import calibrate_act_scales
    from count_pipnet_tpu_torch.models.serving import make_gumbel_serving_fn
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(42)
    model = smoke.build_model(256, seed=1).to(dev)
    scales = calibrate_act_scales(model.backbone, torch.randn(
        64, 224, 224, 3, device=dev, generator=gen))
    infer = make_gumbel_serving_fn(model, act_scales=scales, device=dev)
    for b in (32, 256):
        x = torch.randn(b, 224, 224, 3, device=dev, generator=gen)
        for i in range(2):
            infer(x, i)[1].cpu()
        t0 = time.perf_counter()
        for i in range(5):
            out = infer(x, 100 + i)
        out[1].cpu()
        dt = time.perf_counter() - t0
        print(f"serve K4 batch {b}, gumbel int8-static, 256-prototype "
              f"add-on + kernel B: {b * 5 / dt:.1f} images/s "
              f"({dt / 5 * 1e3:.2f} ms/batch, {card})", flush=True)


def sass(out_dir):
    """cuobjdump's SASS of kernel B's entries in the built library, each
    into ``out_dir``, and their instructions counted by opcode."""
    from count_pipnet_tpu_torch.ops import cuda as kc
    kc.library()
    tool = Path(kc._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", kc.build_info["path"]],
                          capture_output=True, text=True, check=True).stdout
    out_dir.mkdir(parents=True, exist_ok=True)
    for part in text.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if "gumbel_hist_kernel" not in name:
            continue
        ops = re.findall(OPCODE, part)
        (out_dir / f"{name[:120]}.sass").write_text(part)
        hist = collections.Counter(o for o in ops if o != "NOP")
        print(f"sass {name}: {sum(hist.values())} instructions; "
              + ", ".join(f"{k} {v}" for k, v in hist.most_common()),
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--sass", type=Path, default=None,
                    help="write kernel B's SASS here and count its "
                    "instructions by opcode (this tree's build)")
    args = ap.parse_args(argv)
    if args.sass:
        sass(args.sass)
    if not torch.cuda.is_available():
        print("k4_times: no CUDA device", file=sys.stderr)
        return 1
    card = smi("name,power.limit")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    print(f"{card}; {sms} SMs, top SM clock {sm_mhz:g} MHz", flush=True)
    kernel_times(card, sms, sm_mhz * 1e6)
    if args.serve:
        serve_times(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
