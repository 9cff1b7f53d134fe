// The ConvNeXt block's device code shared by the port's kernels:
//
//   dwconv7x7 + bias -> LayerNorm -> pw1 (C -> 4C) -> tanh-GELU
//     -> pw2 (4C -> C) -> * layer_scale -> + residual
//
// - the depthwise window walk (dw7_walk, dw7_dot, block_dw_rows), which
//   kernel A's prologue (fused_block.cu), K7 (dwconv.cu) and K8
//   (dwconv_wgrad.cu) use;
// - the arithmetic of each step as __device__ functions with their
//   floating-point contraction pinned (ln_stats, ln_value, quant_scaled,
//   up_static, up_dyn, block_out), so that every launch that computes a
//   step computes the same bits: kernel A's (fused_block.cu) and kernel
//   C's, which runs kernel A's prologue and GEMM 1 and its own GEMM 2 with
//   the noisy argmax in the epilogue (gumbel_head.cu);
// - the tiles of the two kernels' GEMMs on sm90.cuh's TMA-fed wgmma core
//   (gemm_tiled).
#pragma once

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace cpt {

constexpr int kTM = 32;        // patch rows per CTA of the prologue
constexpr int kThreads = 256;  // 8 warps

// GEMM operand modes: bf16, int8 with calibrated static scales, int8 with
// dynamic per-row scales (kernel A only).
enum : int { kQBf16 = 0, kQStatic = 1, kQDyn = 2 };

struct BlockParams {
  const void* x;    // [B*H*W, C] T
  int B, H, W, C;
  const float* dwk;  // [49, C], tap (dy, dx) at row dy * 7 + dx
  const float* dwb;  // [C]
  const float* lns;  // [C]
  const float* lnb;  // [C]
  const void* w1;    // [4C, C] bf16 or int8
  const float* s1;   // [4C] weight scale (int8)
  const float* b1;   // [4C]
  const float* i1;   // [C]  127 / amax of the LN output (int8)
  const void* w2;    // [C, 4C] bf16 or int8
  const float* s2;   // [C]
  const float* b2;   // [C]
  const float* i2;   // [4C] 127 / amax of the GELU output (int8)
  const float* g;    // [C] layer scale
  float eps;
};

__device__ __forceinline__ int8_t quant_static(float v) {
  // round(clip(v, -127, 127)), half to even like jnp.round
  return (int8_t)__float2int_rn(fminf(fmaxf(v, -127.0f), 127.0f));
}

// The steps' arithmetic with its floating-point contraction pinned (the
// __f*_rn intrinsics are never fused or reordered by the compiler); the
// GEMM epilogues round each operation on its own, as the plain version's
// PyTorch operations do.

// Mean and 1 / std of the C values of one row at ``d`` (shared memory), by
// one whole warp: lane-strided sums, a butterfly, two passes; every lane
// gets both.
__device__ __forceinline__ float2 ln_stats(const float* d, int C, float eps,
                                           int lane) {
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s = __fadd_rn(s, d[c]);
  const float mu = __fdiv_rn(warp_sum(s), (float)C);
  float v = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float t = __fsub_rn(d[c], mu);
    v = __fmaf_rn(t, t, v);
  }
  return make_float2(mu, rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(v), (float)C),
                                          eps)));
}

// The LayerNorm output of one value: (d - mu) * rs * scale + bias.
__device__ __forceinline__ float ln_value(float d, float2 st, float scale,
                                          float bias) {
  return __fmaf_rn(__fmul_rn(__fsub_rn(d, st.x), st.y), scale, bias);
}

// The static int8 operand: round(clip(v * 127 / amax)).
__device__ __forceinline__ int8_t quant_scaled(float v, float inv) {
  return quant_static(__fmul_rn(v, inv));
}

// GEMM 1's static int8 epilogue: the GELU output of one s32 sum, quantized.
__device__ __forceinline__ int8_t up_static(int acc, float s1, float b1,
                                           float i2) {
  return quant_scaled(gelu_tanh(__fadd_rn(__fmul_rn((float)acc, s1), b1)),
                      i2);
}

// GEMM 1's dynamic epilogue before quantization: the GELU output of one s32
// sum of a row whose LN output was quantized with the scale ``nsc``, in the
// plain version's order, (sum * nsc) * s1 + b1.
__device__ __forceinline__ float up_dyn(int acc, float nsc, float s1,
                                        float b1) {
  return gelu_tanh(__fadd_rn(__fmul_rn(__fmul_rn((float)acc, nsc), s1), b1));
}

// The block output of one GEMM 2 sum ``v``: x + (v * s + b) * g (s = 1 for
// f32 sums).
__device__ __forceinline__ float block_out(float x, float v, float s,
                                           float b, float g) {
  return __fadd_rn(x, __fmul_rn(__fadd_rn(__fmul_rn(v, s), b), g));
}

// The depthwise 7x7 (stride 1, pad 3) of one channel ``c`` over a run of
// ``n`` consecutive pixels of the flattened [B*H*W, C] plane, from pixel
// ``start`` on, walked in order with the 7x7 input window in registers:
// along an image row the window slides one column, so a pixel costs 7
// loads, not 49. ``visit(i, win)`` is called for each pixel start + i below
// ``total`` with win[dy][dx] = x[y + dy - 3, x + dx - 3] (0 outside the
// image: the halo by bounds checks), ``skip(i)`` for each pixel past it.
// The window holds WT values: f32, or for kernel A's bf16 taps the channel
// pair (c, c + 1) as one bf16x2 (load_tap).
// Kernel A, K5's sibling K7 (dwconv.cu) and K8 (dwconv_wgrad.cu) share it.
template <typename WT, typename T>
__device__ __forceinline__ WT load_tap(const T* p) {
  if constexpr (std::is_same_v<WT, float>) {
    return to_f32(*p);
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return *reinterpret_cast<const __nv_bfloat162*>(p);
  } else {  // round to nearest even, as astype(bfloat16)
    return __float22bfloat162_rn(*reinterpret_cast<const float2*>(p));
  }
}

template <typename WT>
__device__ __forceinline__ WT zero_tap() {
  if constexpr (std::is_same_v<WT, float>) {
    return 0.0f;
  } else {
    return __float2bfloat162_rn(0.0f);
  }
}

template <typename WT = float, typename T, typename Visit, typename Skip>
__device__ __forceinline__ void dw7_walk(const T* x, int H, int W, int C,
                                         int c, int start, int n, int total,
                                         Visit visit, Skip skip) {
  const int HW = H * W;
  int b = start / HW, y = (start - b * HW) / W;
  int xq = start - b * HW - y * W;
  WT win[7][7];
  bool slide = false;  // window holds the previous pixel of this row
  for (int i = 0; i < n; ++i) {
    if (start + i < total) {
      const T* xb = x + (size_t)b * HW * C + c;
      auto ld = [&](int yy, int xx) -> WT {
        return (yy < 0 || yy >= H || xx < 0 || xx >= W)
                   ? zero_tap<WT>()
                   : load_tap<WT>(xb + (size_t)(yy * W + xx) * C);
      };
      if (slide) {
#pragma unroll
        for (int dy = 0; dy < 7; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 6; ++dx) win[dy][dx] = win[dy][dx + 1];
          win[dy][6] = ld(y + dy - 3, xq + 3);
        }
      } else {
#pragma unroll
        for (int dy = 0; dy < 7; ++dy)
#pragma unroll
          for (int dx = 0; dx < 7; ++dx)
            win[dy][dx] = ld(y + dy - 3, xq + dx - 3);
      }
      visit(i, win);
    } else {
      skip(i);
    }
    // next pixel
    slide = xq + 1 < W;
    if (++xq == W) {
      xq = 0;
      if (++y == H) {
        y = 0;
        ++b;
      }
    }
  }
}

// bias + the 49 taps of one window, summed by columns (the order kernel A
// has always used: its readings do not move with the sharing); each column
// as fused multiply-adds in dy order, pinned so that every kernel that
// calls it computes the same bits.
__device__ __forceinline__ float dw7_dot(const float (&win)[7][7],
                                         const float (&wk)[49], float bias) {
  float d = bias;
#pragma unroll
  for (int dx = 0; dx < 7; ++dx) {
    float vs = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 7; ++dy)
      vs = __fmaf_rn(win[dy][dx], wk[dy * 7 + dx], vs);
    d = __fadd_rn(d, vs);
  }
  return d;
}

// The same for a channel pair with bf16 taps, as the TPU kernels'
// tap_dtype=bfloat16 computes it (count_pipnet_tpu/ops/pallas/
// fused_block.py:_dwconv_flat, :_dwconv_pad): window and weights in bf16;
// for each dx the 7 products, each rounded to bf16, summed in bf16 in dy
// order; each per-dx sum then added in f32 to the bias, in dx order. The
// packed __hmul2_rn / __hadd2_rn do both channels in one instruction,
// round every step and are never contracted into an FMA (one rounding),
// so the sums are the plain version's to the bit.
__device__ __forceinline__ float2 dw7_dot(const __nv_bfloat162 (&win)[7][7],
                                          const __nv_bfloat162 (&wk)[49],
                                          float2 d) {
#pragma unroll
  for (int dx = 0; dx < 7; ++dx) {
    __nv_bfloat162 vs = __hmul2_rn(win[0][dx], wk[dx]);
#pragma unroll
    for (int dy = 1; dy < 7; ++dy)
      vs = __hadd2_rn(vs, __hmul2_rn(win[dy][dx], wk[dy * 7 + dx]));
    const float2 f = __bfloat1622float2(vs);
    d.x += f.x;
    d.y += f.y;
  }
  return d;
}

// Step 1a of a CTA that owns the kTM rows from ``row0``: depthwise 7x7 +
// bias into ``accf`` ([kTM, C] f32, row stride ``as``), zeros past the
// plane's end. A thread owns one channel (DWBF: a channel pair, in bf16x2)
// and a run of the CTA's rows (dw7_walk: the 7x7 window and the 49 taps in
// registers). Neighbouring threads read neighbouring channels (coalesced).
// Below 256 channels (pairs) the rows are split into segs runs so more
// threads work. The f32 and bf16 tap branches stay apart: written as one
// loop over 1 or 2 channels a thread, the f32-tap instantiations rose from
// 127-128 to 130-162 registers and ran up to 1.4 times slower (H100).
// Kernel A's prologue (fused_block.cu) runs it.
template <typename T, bool DWBF>
__device__ __forceinline__ void block_dw_rows(const BlockParams& p,
                                              float* accf, int as,
                                              int row0) {
  const int C = p.C, total = p.B * p.H * p.W, tid = threadIdx.x;
  const T* x = static_cast<const T*>(p.x);
  if constexpr (DWBF) {
    const int C2 = C / 2;
    int segs = 1;  // a power of two, so that it divides kTM
    while (2 * segs * C2 <= kThreads && 2 * segs <= 8) segs *= 2;
    const int seg_rows = kTM / segs;
    for (int t = tid; t < C2 * segs; t += kThreads) {
      const int c = 2 * (t % C2), r0 = (t / C2) * seg_rows;
      __nv_bfloat162 wk[49];
#pragma unroll
      for (int i = 0; i < 49; ++i)
        wk[i] = load_tap<__nv_bfloat162>(p.dwk + i * C + c);
      const float2 bias = *reinterpret_cast<const float2*>(p.dwb + c);
      dw7_walk<__nv_bfloat162>(
          x, p.H, p.W, C, c, row0 + r0, seg_rows, total,
          [&](int i, const __nv_bfloat162(&win)[7][7]) {
            *reinterpret_cast<float2*>(accf + (r0 + i) * as + c) =
                dw7_dot(win, wk, bias);
          },
          [&](int i) {
            *reinterpret_cast<float2*>(accf + (r0 + i) * as + c) =
                make_float2(0.0f, 0.0f);
          });
    }
  } else {
    const int segs = C >= kThreads ? 1 : kThreads / C;  // 1, 2, 4 or 8
    const int seg_rows = kTM / segs;
    for (int t = tid; t < C * segs; t += kThreads) {
      const int c = t % C, r0 = (t / C) * seg_rows;
      float wk[49];
#pragma unroll
      for (int i = 0; i < 49; ++i) wk[i] = p.dwk[i * C + c];
      const float bias = p.dwb[c];
      dw7_walk(
          x, p.H, p.W, C, c, row0 + r0, seg_rows, total,
          [&](int i, const float(&win)[7][7]) {
            accf[(r0 + i) * as + c] = dw7_dot(win, wk, bias);
          },
          [&](int i) { accf[(r0 + i) * as + c] = 0.0f; });
    }
  }
}

inline BlockParams make_block_params(
    const void* x, int B, int H, int W, int C, const float* dwk,
    const float* dwb, const float* lns, const float* lnb, const void* w1,
    const float* s1, const float* b1, const float* i1, const void* w2,
    const float* s2, const float* b2, const float* i2, const float* g,
    float eps) {
  BlockParams p;
  p.x = x; p.B = B; p.H = H; p.W = W; p.C = C;
  p.dwk = dwk; p.dwb = dwb; p.lns = lns; p.lnb = lnb;
  p.w1 = w1; p.s1 = s1; p.b1 = b1; p.i1 = i1;
  p.w2 = w2; p.s2 = s2; p.b2 = b2; p.i2 = i2;
  p.g = g; p.eps = eps;
  return p;
}

// The GEMMs' tiles <BN, STAGES, CTAs an SM> by ``tile``: 1-5 the
// candidates (scripts/block_tiles.py times kernel A's int8 GEMMs with each),
// 0 the choice for the GEMM and width (default_tile, from those times and
// K5's: GEMM 1, N = 4C, two 128-wide CTAs an SM; GEMM 2, K = 4C, a
// 256-wide tile where 256 divides C). ``In``: the operand type, int8 (the
// s8 mode) or bf16 (tiles 1-4: the core has no 192-wide bf16 wgmma).
constexpr int kTiles = 5;

inline int default_tile(bool up, int N) {
  if (!up && N % 256 == 0) return 2;
  if (N % 128 == 0) return 1;
  return 3;
}

template <typename In, typename Epi>
cudaError_t gemm_tiled(bool up, int tile, const void* a, const void* b,
                       int M, int N, int K, const Epi& epi,
                       cudaStream_t st) {
  switch (tile == 0 ? default_tile(up, N) : tile) {
    case 1: return sm90::gemm<128, 3, 2, Epi, In>(a, b, M, N, K, epi, st);
    case 2: return sm90::gemm<256, 4, 1, Epi, In>(a, b, M, N, K, epi, st);
    case 3: return sm90::gemm<96, 3, 2, Epi, In>(a, b, M, N, K, epi, st);
    case 4: return sm90::gemm<64, 4, 2, Epi, In>(a, b, M, N, K, epi, st);
    case 5:
      if constexpr (std::is_same_v<In, int8_t>)
        return sm90::gemm<192, 3, 1, Epi, In>(a, b, M, N, K, epi, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace cpt
