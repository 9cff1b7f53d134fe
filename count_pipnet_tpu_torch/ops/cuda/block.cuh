// The ConvNeXt block's device code shared by the port's kernels:
//
//   dwconv7x7 + bias -> LayerNorm -> pw1 (C -> 4C) -> tanh-GELU
//     -> pw2 (4C -> C) -> * layer_scale -> + residual
//
// - the depthwise window walk (dw7_walk, dw7_dot), which kernel A's
//   prologue (fused_block.cu), K7 (dwconv.cu) and K8 (dwconv_wgrad.cu) use;
// - the arithmetic of each step as __device__ functions with their
//   floating-point contraction pinned (ln_stats, ln_value, quant_scaled,
//   up_static, up_dyn, block_out), so that every kernel that computes a
//   step computes the same bits: kernel A's launches (fused_block.cu) and
//   the one-kernel body below;
// - that one-kernel body, fused_block_kernel, for kernel C alone (the
//   block of count_pipnet_tpu/ops/pallas/gumbel_head.py:
//   fused_block_gumbel_counts, :268, in its bf16 and int8-static modes,
//   with the noisy-argmax histogram as its epilogue, so the last plane is
//   never written). It keeps one kernel because the argmax needs a whole
//   row of the block output at once, more than one GEMM tile of kernel A's
//   launches holds. Kernel A runs every mode, the dynamic int8 one
//   included, as launches on the TMA-fed wgmma core (fused_block.cu).
//
// The body keeps the depthwise output and the 4C-wide hidden activation on
// the SM:
//
//   1. A CTA owns TM patch rows. It computes dw7x7 for them (halo by bounds
//      checks, f32 taps), then LayerNorm, and keeps the LN output in shared
//      memory as the GEMM operand (bf16, or int8 with the static scale).
//   2. It walks the hidden dimension in chunks of HC: pw1 chunk -> bias ->
//      GELU -> cast / quantize -> accumulate pw2 into a [TM, C] shared
//      accumulator (int32 in the int8 mode: the static scales are per
//      hidden channel, so chunking is exact).
//   3. Epilogue: dequantize, * gamma, + residual (block_out, as kernel A's
//      GEMM 2 epilogue computes it), and the noisy argmax histogram of each
//      row.
//
// The body's GEMMs run on the tensor cores through mma.sync (m16n8k16
// bf16, m16n8k32 s8) with the weights read from L2 as [out, in] rows.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace cpt {

constexpr int kTM = 32;        // patch rows per CTA
constexpr int kHC = 128;       // hidden chunk
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
  float* counts;       // [B, C] f32, zeroed (HEAD)
  const float* noise;  // [B*H*W, C] f32 or null (HEAD)
  uint2 key;           // Philox key (HEAD, no noise)
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

// Fragment loads shared by both mma shapes: in bytes, the A registers of
// m16n8k16 bf16 and m16n8k32 s8 sit at the same offsets (row g / g + 8,
// byte 4 * tq / 4 * tq + 16 of the 32-byte K slice), and so do B's.
__device__ __forceinline__ void load_frag_a(uint32_t a[4],
                                            const unsigned char* base,
                                            int row_bytes, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  const unsigned char* p0 = base + g * row_bytes + 4 * tq;
  const unsigned char* p1 = p0 + 8 * row_bytes;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 16);
}

__device__ __forceinline__ void load_frag_b(uint32_t b[2],
                                            const unsigned char* base,
                                            int row_bytes, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  const uint32_t* p =
      reinterpret_cast<const uint32_t*>(base + g * row_bytes + 4 * tq);
  b[0] = __ldg(p);
  b[1] = __ldg(p + 4);
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    const uint32_t b[2], __nv_bfloat16) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(int c[4], const uint32_t a[4],
                                    const uint32_t b[2], int8_t) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool INT8>
struct Mode {
  using E = std::conditional_t<INT8, int8_t, __nv_bfloat16>;  // operand
  using Acc = std::conditional_t<INT8, int, float>;
  static constexpr int kK = 32 / (int)sizeof(E);  // mma depth
  static constexpr int kPad = 16 / (int)sizeof(E);  // 16-byte row pad
};

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

template <int Q>
__host__ __device__ inline size_t block_smem_bytes(int C) {
  using M = Mode<Q != kQBf16>;
  return (size_t)kTM * (C + 8) * 4                       // accumulator
         + (size_t)kTM * (C + M::kPad) * sizeof(typename M::E)    // LN out
         + (size_t)kTM * (kHC + M::kPad) * sizeof(typename M::E);  // hidden
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
// Kernel A's prologue (fused_block.cu) and the body below both run it.
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

template <typename T, int Q>
__global__ void __launch_bounds__(kThreads)
    fused_block_kernel(const BlockParams p) {
  constexpr bool INT8 = Q != kQBf16;
  using M = Mode<INT8>;
  using E = typename M::E;
  using Acc = typename M::Acc;
  const int C = p.C, HD = 4 * C, HW = p.H * p.W, total = p.B * HW;
  const int row0 = blockIdx.x * kTM;
  const int as = C + 8;          // accumulator row stride (4-byte words)
  const int xs = C + M::kPad;    // LN-output row stride (elements)
  const int hs = kHC + M::kPad;  // hidden row stride (elements)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, tq = lane & 3;

  extern __shared__ __align__(16) unsigned char smem[];
  float* accf = reinterpret_cast<float*>(smem);
  Acc* acc = reinterpret_cast<Acc*>(smem);
  E* xn = reinterpret_cast<E*>(smem + (size_t)kTM * as * 4);
  E* hb = xn + kTM * xs;
  const T* x = static_cast<const T*>(p.x);
  const unsigned char* w1 = static_cast<const unsigned char*>(p.w1);
  const unsigned char* w2 = static_cast<const unsigned char*>(p.w2);

  block_dw_rows<T, false>(p, accf, as, row0);
  __syncthreads();

  // 1b. LayerNorm per row (one warp a row), cast / quantize into xn
  for (int r = warp; r < kTM; r += kThreads / 32) {
    const float* d = accf + r * as;
    const float2 st = ln_stats(d, C, p.eps, lane);
    for (int c = lane; c < C; c += 32) {
      const float n = ln_value(d[c], st, p.lns[c], p.lnb[c]);
      if constexpr (INT8) {
        xn[r * xs + c] = quant_scaled(n, p.i1[c]);
      } else {
        xn[r * xs + c] = __float2bfloat16_rn(n);
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kTM * as; idx += kThreads) acc[idx] = Acc(0);
  __syncthreads();

  // 2. hidden chunks: pw1 -> GELU -> pw2 accumulate
  for (int j0 = 0; j0 < HD; j0 += kHC) {
    {  // pw1 chunk [kTM, kHC]: warp -> m-tile (warp & 1), 4 n-tiles
      const int mt = warp & 1, nb = (warp >> 1) * 4;
      Acc c4[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) c4[t][e] = Acc(0);
#pragma unroll 4
      for (int k0 = 0; k0 < C; k0 += M::kK) {
        uint32_t a[4];
        load_frag_a(a,
                    reinterpret_cast<const unsigned char*>(
                        xn + (mt * 16) * xs + k0),
                    xs * (int)sizeof(E), lane);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          uint32_t bf[2];
          const int n0 = j0 + (nb + t) * 8;
          load_frag_b(bf, w1 + ((size_t)n0 * C + k0) * sizeof(E),
                      C * (int)sizeof(E), lane);
          mma(c4[t], a, bf, E());
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = mt * 16 + g8 + (e >> 1) * 8;
          const int jl = (nb + t) * 8 + tq * 2 + (e & 1);
          const int j = j0 + jl;
          if constexpr (INT8) {
            hb[r * hs + jl] = up_static(c4[t][e], p.s1[j], p.b1[j], p.i2[j]);
          } else {
            hb[r * hs + jl] =
                __float2bfloat16_rn(gelu_tanh(c4[t][e] + p.b1[j]));
          }
        }
    }
    __syncthreads();
    // pw2 partial [kTM, C] += hidden chunk @ w2[:, j0:j0+kHC]
    const int ntn = C / 8;
#pragma unroll 2
    for (int t = warp; t < 2 * ntn; t += kThreads / 32) {
      const int mt = t & 1, n0 = (t >> 1) * 8;
      Acc c4[4] = {Acc(0), Acc(0), Acc(0), Acc(0)};
#pragma unroll
      for (int k0 = 0; k0 < kHC; k0 += M::kK) {
        uint32_t a[4], bf[2];
        load_frag_a(a,
                    reinterpret_cast<const unsigned char*>(
                        hb + (mt * 16) * hs + k0),
                    hs * (int)sizeof(E), lane);
        load_frag_b(bf, w2 + ((size_t)n0 * HD + j0 + k0) * sizeof(E),
                    HD * (int)sizeof(E), lane);
        mma(c4, a, bf, E());
      }
      Acc* dst = acc + (mt * 16 + g8) * as + n0 + tq * 2;
      dst[0] += c4[0];
      dst[1] += c4[1];
      dst[8 * as] += c4[2];
      dst[8 * as + 1] += c4[3];
    }
    __syncthreads();
  }

  // 3. epilogue: the block output of row r, channel c, from x's value xv
  // (as kernel A's GEMM 2 epilogue computes it: block_out), then each
  // row's noisy argmax into the histogram
  auto out_val = [&](float xv, int r, int c) -> float {
    if constexpr (INT8) {
      return block_out(xv, (float)acc[r * as + c], p.s2[c], p.b2[c], p.g[c]);
    } else {
      return block_out(xv, acc[r * as + c], 1.0f, p.b2[c], p.g[c]);
    }
  };
  for (int r = warp; r < kTM; r += kThreads / 32) {
    const int row = row0 + r;
    if (row >= total) break;
    const int b = row / HW, patch = row - b * HW;
    const T* xr = x + (size_t)row * C;
    const int win = noisy_argmax_row(
        [&](int c) { return out_val(to_f32(xr[c]), r, c); }, C,
        p.noise ? p.noise + (size_t)row * C : nullptr, p.key,
        (uint32_t)patch, (uint32_t)b, lane);
    if (lane == 0) atomicAdd(p.counts + (size_t)b * C + win, 1.0f);
  }
}

// Host side: pick the instantiation (``mode`` kQBf16 or kQStatic, as the
// TPU's fused head takes) and launch on ``stream``.
inline cudaError_t launch_fused_block(const BlockParams& p, int x_bf16,
                                      int mode, cudaStream_t stream) {
  if (p.C % 32 != 0 || (mode != kQBf16 && mode != kQStatic))
    return cudaErrorInvalidValue;
  const int total = p.B * p.H * p.W;
  const dim3 grid((total + kTM - 1) / kTM);
  const size_t smem = mode == kQStatic ? block_smem_bytes<kQStatic>(p.C)
                                       : block_smem_bytes<kQBf16>(p.C);
  auto go = [&](auto kernel) -> cudaError_t {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  };
  using BF = __nv_bfloat16;
  if (x_bf16)
    return mode == kQStatic ? go(fused_block_kernel<BF, kQStatic>)
                            : go(fused_block_kernel<BF, kQBf16>);
  return mode == kQStatic ? go(fused_block_kernel<float, kQStatic>)
                          : go(fused_block_kernel<float, kQBf16>);
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
  p.counts = nullptr; p.noise = nullptr; p.key = make_uint2(0u, 0u);
  return p;
}

}  // namespace cpt
