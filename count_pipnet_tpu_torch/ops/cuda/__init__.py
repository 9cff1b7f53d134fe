"""Build and bind the port's hand-written Hopper kernels.

The ``.cu`` sources next to this file are compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3``, one nvcc process per
source, all started together, and their objects are linked into one shared
library under ``_build/`` (named by a hash of the sources and flags, so an
edit rebuilds), loaded with ``ctypes``. The kernels have plain C entry
points that take raw device pointers and the CUDA stream; they launch and
return ``cudaGetLastError()``. :func:`check` raises on a non-zero code —
there is no fallback to the plain PyTorch versions.

Nothing here runs at import time: the CPU tests import every module of the
package on machines without ``nvcc``.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["library", "check", "ptr", "stream_ptr", "launch_counts",
           "launch_widths", "count_launch", "reset_launch_counts",
           "build_info", "ptxas_entries"]

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "_build"
SOURCES = ("fused_block.cu", "gumbel_head.cu", "fused_mlp.cu",
           "fused_mlp_bwd.cu", "dwconv.cu", "dwconv_wgrad.cu",
           "fused_head.cu", "int8_gemm.cu")
HEADERS = ("block.cuh", "common.cuh", "sm90.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# Kernel launches, by wrapper name: each wrapper adds one where it launches
# its kernel, and nowhere else.
# Kernel A in its dynamic int8 mode counts as "fused_block_int8_dyn", and
# with bf16 depthwise taps as "fused_block_dwbf16" (bf16 and int8-static
# GEMMs) or "fused_block_int8_dyn_dwbf16"; a call of kernel A (three
# launches, four in the dynamic mode) counts once, and so does a call of
# kernel C (four launches).
launch_counts = {"fused_block": 0, "gumbel_hard_counts": 0,
                 "fused_block_gumbel_counts": 0, "fused_ln_mlp_residual": 0,
                 "fused_mlp_bwd": 0, "dwconv7": 0, "dwconv7_wgrad": 0,
                 "fused_count_head": 0, "int8_quant_gemm": 0,
                 "fused_block_int8_dyn": 0, "fused_block_dwbf16": 0,
                 "fused_block_int8_dyn_dwbf16": 0}
# The same launches by (wrapper name, channel width).
launch_widths = {}

# Set by the first build in this process: seconds spent, library path and
# nvcc's resource report (registers, shared memory, spills per kernel).
build_info = {}

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U64 = ctypes.c_ulonglong
_BLOCK_ARGS = [_I, _I, _I, _I, _I, _I,            # x_bf16 mode B H W C
               _P, _P, _P, _P,                    # dwk dwb lns lnb
               _P, _P, _P, _P, _P, _P, _P, _P,    # w1 s1 b1 i1 w2 s2 b2 i2
               _P, _F]                            # g eps
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # x, out, dw_bf16, x_bf16, mode, B, H, W, C, ..., n (scratch),
    # h (scratch), rs (row-scale scratch, dynamic mode), stream
    "cpt_fused_block": [_P, _P, _I] + _BLOCK_ARGS + [_P, _P, _P, _P],
    # kernel A's launches: x, n, nsc, amax, keys, dw_bf16, x_bf16, mode, B,
    # H, W, C, dwk, dwb, lns, lnb, i1, eps, the halo tile (tr, cs), stream
    "cpt_block_prologue": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P, _P, _P, _F, _I, _I, _P],
    # the halo tile a launch takes: prologue, H, W, C, elt, dw_bf16,
    # plan (int [4], in and out)
    "cpt_dw_plan": [_I, _I, _I, _I, _I, _I, _IP],
    # n, w1, s1, b1, i2, h, nsc, amax, asc, mode, passes, R, C, tile, stream
    "cpt_block_up": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _P],
    # h, w2, s2, b2, g, asc, x, x_bf16, out, mode, R, C, tile, stream
    "cpt_block_down": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                       _P],
    # the GEMM core's s8 mode: a, b, d (s32), M, N, K, stream
    "cpt_sm90_gemm_s8": [_P, _P, _P, _I, _I, _I, _P],
    # logits, x_bf16, noise, counts, B, HW, C, seed, plan, plan taken (int,
    # out, or null), stream
    "cpt_gumbel_hard_counts": [_P, _I, _P, _P, _I, _I, _I, _U64, _I, _IP,
                               _P],
    # mismatches (u64, zeroed), stream
    "cpt_gumbel_log_mismatches": [_P, _P],
    # x, x_bf16, mode, B, H, W, C, ..., noise, counts, seed, n (scratch),
    # h (scratch), keys (scratch), stream
    "cpt_fused_block_gumbel_counts": [_P] + _BLOCK_ARGS + [_P, _P, _U64, _P,
                                                           _P, _P, _P],
    # kernel C's launches: h, w2, s2, b2, g, x, x_bf16, noise, keys, mode,
    # R, HW, C, seed, tile, stream
    "cpt_block_head_keys": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                            _I, _U64, _I, _P],
    # keys, counts, B, HW, C, stream
    "cpt_count_keys": [_P, _P, _I, _I, _I, _P],
    # h, w2, s2, b2, g, x, x_bf16, out (f32), mode, R, C, stream
    "cpt_block_down_f32": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P],
    # x, res, out, x_bf16, res_bf16, R, C, lns, lnb, w1, b1, w2, b2, g,
    # eps, n (scratch), h (scratch), stream
    "cpt_fused_mlp": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                      _P, _F, _P, _P, _P],
    # K5's stages: x, x_bf16, n, R, C, lns, lnb, eps, stream
    "cpt_mlp_ln_rows": [_P, _I, _P, _I, _I, _P, _P, _F, _P],
    # n, w1, b1, h, R, C, stream
    "cpt_mlp_up_gelu": [_P, _P, _P, _P, _I, _I, _P],
    # h, w2, b2, g, res, res_bf16, out, R, C, stream
    "cpt_mlp_down_residual": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _P],
    # the GEMM core: a, b, d (f32), M, N, K, stream
    "cpt_sm90_gemm": [_P, _P, _P, _I, _I, _I, _P],
    # R, C -> grid_rows, splits of dW1, of dW2r
    "cpt_fused_mlp_bwd_plan": [_I, _I, _IP, _IP, _IP],
    # R, M, N -> splits
    "cpt_mlp_wgrad_plan": [_I, _I, _I, _IP],
    # x, g, dx, x_bf16, g_bf16, R, C, lns, lnb, w1, w1t, w2t, b1, gamma,
    # eps, mu, inv, nb, dyb, gb, ab, dhb, dn, part_a, part_b, part_d,
    # grid_rows, ws, splits1, splits2, dw1, dw2r, vec, stream
    "cpt_fused_mlp_bwd": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                          _P, _P, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P, _P, _I, _P, _I, _I, _P, _P, _P, _P],
    # K6's stages: x, x_bf16, g, g_bf16, R, C, lns, lnb, gamma, eps, mu,
    # inv, nb, dyb, gb, part, grid_rows, sg, stream
    "cpt_mlp_bwd_prologue": [_P, _I, _P, _I, _I, _I, _P, _P, _P, _F, _P,
                             _P, _P, _P, _P, _P, _I, _P, _P],
    # nb, dyb, w1, w2t, b1, ab, dhb, part, R, C, db1, stream
    "cpt_mlp_bwd_dual": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    # dhb, w1t, dn, R, C, stream
    "cpt_mlp_bwd_dn": [_P, _P, _P, _I, _I, _P],
    # dn, x, x_bf16, mu, inv, lns, dx, R, C, part, grid_rows, dls_dlb,
    # stream
    "cpt_mlp_bwd_ln": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _I, _P, _P],
    # the MN-major GEMM core: a, b, out, ws, R, M, N, splits, stream
    "cpt_mlp_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, out, x_bf16, out_bf16, B, H, W, C, w, bias, the halo tile (tr,
    # cs, segs), stream
    "cpt_dwconv7": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _P],
    # K8's plan: B, H, W, C, elt, SMs, plan (int [6], in and out)
    "cpt_dwconv7_wgrad_plan": [_I, _I, _I, _I, _I, _I, _IP],
    # x, g, bf16, B, H, W, C, the plan (tr, cs, segs, bufs, ctas), part,
    # out, stream
    "cpt_dwconv7_wgrad": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P, _P, _P],
    # x, x_bf16, w, bias, xhi, xlo, stats, logits, part (scratch), counts,
    # B, HW, C, Pp, stream
    "cpt_fused_count_head": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _P],
    # K9's launches: x, hi, lo, n, stream
    "cpt_head_split": [_P, _P, _P, ctypes.c_longlong, _P],
    # xhi, xlo, w, bias, stats, logits, M, C, Pp, tile, stream
    "cpt_head_gemm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # logits, stats, part, B, HW, Pp, nt, stream
    "cpt_head_rows": [_P, _P, _P, _I, _I, _I, _I, _P],
    # x, x_bf16, wq, ws, bias, out, out_bf16, xq, asc (scratch), M, K, N,
    # stream
    "cpt_int8_quant_gemm": [_P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                            _P],
    # K10's launches: x, x_bf16, xq, asc, M, K, stream
    "cpt_int8_quant_rows": [_P, _I, _P, _P, _I, _I, _P],
    # xq, asc, wq, ws, bias, out, out_bf16, M, K, N, tile, stream
    "cpt_int8_rowscale_gemm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _P],
}


def ptxas_entries(log):
    """nvcc's resource report (``-Xptxas=-v``) of a build log, by kernel
    entry: {C++ name: (registers, stack bytes, spill stores, spill loads)}.
    The names are demangled with ``c++filt`` where the machine has it (else
    they stay mangled); a mangled name of an entry in an unnamed namespace
    differs from build to build."""
    out, name, frame = {}, None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, frame = m.group(1), (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)),) + frame
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(out),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return out
    return dict(zip(names, out.values()))


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0
    launch_widths.clear()


def count_launch(name, width):
    """Add one launch of ``name`` at channel width ``width``."""
    launch_counts[name] += 1
    key = (name, int(width))
    launch_widths[key] = launch_widths.get(key, 0) + 1


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME
        home = CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels of count_pipnet_tpu_torch cannot build")
    return found


def _source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def _build():
    so = BUILD_DIR / f"libcpt_kernels_{_source_hash()}.so"
    log = so.with_suffix(".log")
    t0 = time.perf_counter()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        objs = [tmp.with_suffix(f".{Path(s).stem}.o") for s in SOURCES]
        procs = [subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(SRC_DIR / s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(SOURCES, objs)]
        outs = [p.communicate()[0] for p in procs]
        failed = [f"nvcc {s} failed ({p.returncode}):\n{out[-8000:]}"
                  for s, p, out in zip(SOURCES, procs, outs) if p.returncode]
        if not failed:
            res = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                                  *map(str, objs)],
                                 capture_output=True, text=True)
            outs.append(res.stdout + res.stderr)
            if res.returncode:
                failed.append(f"nvcc link failed ({res.returncode}):\n"
                              f"{outs[-1][-8000:]}")
        log.write_text("".join(outs))
        for o in objs:
            o.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("\n".join(failed))
        os.replace(tmp, so)
    build_info.update(seconds=time.perf_counter() - t0, path=str(so),
                      log=log.read_text() if log.exists() else "")
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library():
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build()
        return _lib


def check(code: int, what: str):
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError_t {code})")


def ptr(t):
    """Device pointer of a tensor (None -> NULL)."""
    return None if t is None else t.data_ptr()


def stream_ptr(device):
    import torch
    return torch.cuda.current_stream(device).cuda_stream
