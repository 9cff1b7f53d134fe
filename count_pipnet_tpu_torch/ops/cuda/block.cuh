// The ConvNeXt block's device code shared by the port's kernels:
//
//   dwconv7x7 + bias -> LayerNorm -> pw1 (C -> 4C) -> tanh-GELU
//     -> pw2 (4C -> C) -> * layer_scale -> + residual
//
// - the depthwise 7x7 as a shared-memory halo tile (DwPlan,
//   make_plane_map, dw_tile_fill, dw7_tile_run, dw_tile_slab), which K7
//   (dwconv.cu), kernel A's prologue (fused_block.cu, block_dw_tile) and
//   K8 use: a CTA copies a rectangle of the NHWC plane, whole image rows with
//   their 3-pixel halo and one slab of channels, into shared memory as one
//   TMA box (the TMA writes zeros past the plane: SAME padding), then every
//   output of the rectangle is computed from shared memory with no bounds
//   check, by a 7x7 window that slides along the row in registers (7
//   shared loads a pixel); K8 (dwconv_wgrad.cu) walks the same tile with
//   the same window (dw7_tile_run), summing window times cotangent;
// - the per-output arithmetic, pinned (dw7_dot);
// - the arithmetic of each step as __device__ functions with their
//   floating-point contraction pinned (ln_stats, ln_value, quant_scaled,
//   up_static, up_dyn, block_out), so that every launch that computes a
//   step computes the same bits: kernel A's (fused_block.cu) and kernel
//   C's, which runs kernel A's prologue and GEMM 1 and its own GEMM 2 with
//   the noisy argmax in the epilogue (gumbel_head.cu);
// - the tiles of the two kernels' GEMMs on sm90.cuh's TMA-fed wgmma core
//   (gemm_tiled).
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace cpt {

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

// The halo tile's tap loads: WT is the window type, f32, or for kernel A's
// bf16 taps the channel pair (c, c + 1) as one bf16x2; T the plane's type
// (global or shared memory).
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

// The depthwise 7x7 as a shared-memory halo tile, K7's (dwconv.cu), kernel
// A's prologue's (block_dw_tile, fused_block.cu) and K8's (dwconv_wgrad.cu,
// which walks it persistently, with a second box of the cotangent and
// sums in place of taps). A CTA owns ``tr``
// whole rows of one image (fewer in the image's last strip) and walks the
// channels in slabs of ``cs``: for each slab it copies the (tr + 6) x
// (W + 6) x cs rectangle of the plane around its rows into shared memory,
// [row][column][channel], channel fastest, in the plane's type, as one TMA
// box that reads zeros past the plane (the halo outside the image, the
// rows past the last, the channels past C: SAME padding), so the walk has
// no bounds check. The threads split the slab into units of one channel (a
// channel pair for bf16 taps), neighbouring threads on neighbouring units
// (conflict-free shared loads), and the rows into ``segs`` pieces a row;
// thread (unit, j) walks pieces j, j + runs, ... with the taps in
// registers. One slab buffer in K7 and the prologue: a second, copying slab
// s + 1 while slab s was summed, was never more than 2 % faster (H100).
struct DwPlan {
  int tr;    // image rows a CTA
  int cs;    // channels a slab: 32, 64, 128 or 256
  int segs;  // pieces a row (0: kThreads / units / tr, at least 1; the
             // prologue always 0, K7's tile sweep varies it)
};

// Elements of the slab buffer, the tile of tr rows [tr + 6][W + 6][cs],
// rounded up so that what follows it starts 128-byte aligned (TMA).
__host__ __device__ inline size_t dw_tile_elems(const DwPlan& pl, int W) {
  return ((size_t)(pl.tr + 6) * (W + 6) * pl.cs + 63) / 64 * 64;
}
// Bytes of one slab's copy, the box.
__host__ __device__ inline int dw_box_bytes(const DwPlan& pl, int W,
                                            int elt) {
  return (pl.tr + 6) * (W + 6) * pl.cs * elt;
}

// The halo tile's copy is one TMA box of the NHWC plane, seen as the 4-D
// tensor [B, H, W, C] (C fastest): the box [1, tr + 6, W + 6, cs] at
// (image b, row y0 - 3, column -3, channel c0). The TMA writes zeros for
// the coordinates past the plane (the SAME padding, and the channels past
// C), so a slab's copy is one instruction of one thread, counted by an
// mbarrier (16-byte cp.async copies, some 1,800 a slab at 26^2 x 768, left
// the prologue 1.4 times slower there; scripts/dw_tiles.py, H100).
// The box's size is the map's: the last strip of an image copies tr + 6
// rows too (its rows past H are zeros). TMA needs a 16-byte aligned plane
// and row strides (C * elt % 16 == 0) and at most 256 in each box
// dimension. ``halo`` 0: the box [1, tr, W, cs] of the rows alone (K8's
// cotangent).
inline cudaError_t make_plane_map(CUtensorMap* map, const void* x, int B,
                                  int H, int W, int C, int elt,
                                  const DwPlan& pl, int halo = 3) {
  const sm90::EncodeTiledFn enc = sm90::encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(x) & 15) || (C * elt) % 16 ||
      W + 2 * halo > 256 || pl.tr + 2 * halo > 256 || pl.cs > 256)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * elt,
                                 (cuuint64_t)W * C * elt,
                                 (cuuint64_t)H * W * C * elt};
  const cuuint32_t box[4] = {(cuuint32_t)pl.cs, (cuuint32_t)(W + 2 * halo),
                             (cuuint32_t)(pl.tr + 2 * halo), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map,
      elt == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(x), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The box of ``map`` at (image b, row y, column xx, channel c0) into
// ``dst`` (128-byte aligned), counted by ``bar``; one thread calls it.
__device__ __forceinline__ void dw_box_copy(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int b, int y,
                                            int xx, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          sm90::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90::smem_addr(bar)),
      "r"(c0), "r"(xx), "r"(y), "r"(b)
      : "memory");
}

// Thread 0 issues the copy of the slab from channel c0 of the strip from
// (b, y0) into ``tile`` (128-byte aligned), counted by ``bar``; the
// threads then wait on ``bar`` (sm90::mbar_wait).
__device__ __forceinline__ void dw_tile_fill(void* tile, const CUtensorMap* map,
                                             uint64_t* bar, int bytes, int b,
                                             int y0, int c0) {
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(bar, bytes);
    dw_box_copy(tile, map, bar, b, y0 - 3, -3, c0);
  }
}

// The slab buffer's mbarrier, one arrival (thread 0's) a phase.
__device__ __forceinline__ void dw_bar_init(uint64_t* bar) {
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The n outputs of one unit along a tile row, from ``t``, the unit's value
// at the top-left of the first output's window (``pix`` elements between
// columns, ``row`` between rows): visit(i, win) with win[dy][dx] the 7x7
// window of output i. The window slides one column a pixel (7 loads); its
// columns sit in a ring unrolled by 7, so the slide moves no register.
template <typename WT, typename TT, typename Visit>
__device__ __forceinline__ void dw7_tile_run(const TT* t, int pix, int row,
                                             int n, Visit visit) {
  WT ring[7][7];
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int dy = 0; dy < 7; ++dy)
      ring[dy][k] = load_tap<WT>(t + dy * row + k * pix);
  for (int i = 0; i < n; i += 7) {
#pragma unroll
    for (int s = 0; s < 7; ++s) {
      if (i + s < n) {
        const TT* q = t + (i + s + 6) * pix;
#pragma unroll
        for (int dy = 0; dy < 7; ++dy)
          ring[dy][(s + 6) % 7] = load_tap<WT>(q + dy * row);
        WT win[7][7];
#pragma unroll
        for (int dy = 0; dy < 7; ++dy)
#pragma unroll
          for (int dx = 0; dx < 7; ++dx) win[dy][dx] = ring[dy][(s + dx) % 7];
        visit(i + s, win);
      }
    }
  }
}

// One slab's outputs from its tile: each thread loads its unit's 49 taps,
// tap k of channel c at w[k * tap_stride + (c - wc0) * ch_stride] (global
// memory, wc0 = 0, or the slab's taps in shared memory, wc0 = c0), and
// bias, then every thread calls ready() (kernel A: waits for the tile, so
// that the taps' loads overlap its copy), then walks its pieces;
// visit(r, x, c, d) for output (row r of the CTA, column x, channel c) with
// d = dw7_dot (float, or float2 for channels c, c + 1).
template <typename WT, typename TT, typename Ready, typename Visit>
__device__ __forceinline__ void dw_tile_slab(const TT* tile, const DwPlan& pl,
                                             int rows, int W, int C, int c0,
                                             const float* w, int wc0,
                                             int tap_stride, int ch_stride,
                                             const float* bias, Ready ready,
                                             Visit visit) {
  constexpr int kU = std::is_same_v<WT, float> ? 1 : 2;  // channels a unit
  using D = std::conditional_t<kU == 1, float, float2>;
  const int units = pl.cs / kU, runs = blockDim.x / units;
  const int u = threadIdx.x % units, j = threadIdx.x / units;
  const int c = c0 + u * kU;
  const bool live = c < C;
  WT wk[49];
  D b;
  if (live) {
#pragma unroll
    for (int k = 0; k < 49; ++k)
      wk[k] = load_tap<WT>(w + k * tap_stride + (c - wc0) * ch_stride);
    b = *reinterpret_cast<const D*>(bias + c);
  }
  ready();
  if (!live) return;
  const int segs = pl.segs ? pl.segs : max(1, runs / pl.tr);
  const int row = (W + 6) * pl.cs;
  for (int k = j; k < rows * segs; k += runs) {
    const int r = k / segs, s = k % segs;
    const int x0 = s * W / segs, x1 = (s + 1) * W / segs;
    if (x1 > x0)
      dw7_tile_run<WT>(tile + r * row + x0 * pl.cs + u * kU, pl.cs, row,
                       x1 - x0, [&](int i, const WT(&win)[7][7]) {
                         visit(r, x0 + i, c, dw7_dot(win, wk, b));
                       });
  }
}

// Kernel A's step 1a for a CTA that owns ``rows`` image rows from (b, y0):
// depthwise 7x7 + bias into ``accf`` ([rows * W, C] f32, row stride
// ``as``), slab by slab through the tile buffer ``tile`` (128-byte
// aligned, its mbarrier ``bar``). DWBF: bf16 taps on channel pairs. The
// f32 and bf16 tap branches stay apart (dw_tile_slab's WT): written as one
// loop over 1 or 2 channels a thread, the older walk's f32-tap
// instantiations rose from 127-128 to 130-162 registers and ran up to 1.4
// times slower (H100).
template <typename T, bool DWBF>
__device__ __forceinline__ void block_dw_tile(const BlockParams& p,
                                              const DwPlan& pl,
                                              const CUtensorMap* map,
                                              float* accf, int as, T* tile,
                                              uint64_t* bar, int b, int y0,
                                              int rows) {
  using WT = std::conditional_t<DWBF, __nv_bfloat162, float>;
  const int C = p.C, W = p.W;
  const int nslab = (C + pl.cs - 1) / pl.cs;
  const int bytes = dw_box_bytes(pl, W, sizeof(T));
  dw_bar_init(bar);
  dw_tile_fill(tile, map, bar, bytes, b, y0, 0);
  for (int s = 0; s < nslab; ++s) {
    dw_tile_slab<WT>(tile, pl, rows, W, C, s * pl.cs, p.dwk, 0, C, 1, p.dwb,
                     [&] { sm90::mbar_wait(bar, s & 1); },
                     [&](int r, int xx, int c, auto d) {
                       *reinterpret_cast<decltype(d)*>(
                           accf + (r * W + xx) * as + c) = d;
                     });
    __syncthreads();  // the buffer is free, and accf whole after the last
    if (s + 1 < nslab)
      dw_tile_fill(tile, map, bar, bytes, b, y0, (s + 1) * pl.cs);
  }
}

// The plans' host side. A CTA takes at most kSmemMax bytes of shared
// memory; two CTAs share an SM at most kSmemTwo each (228 KB an SM, 1 KB of
// it reserved a CTA).
constexpr int kSmemMax = 232448;
constexpr int kSmemTwo = 115712;

inline bool dw_plan_ok(const DwPlan& pl, bool dwbf) {
  const int units = pl.cs / (dwbf ? 2 : 1);
  return pl.tr >= 1 && pl.segs >= 0 &&
         (pl.cs == 32 || pl.cs == 64 || pl.cs == 128 || pl.cs == 256) &&
         kThreads % units == 0;
}

// tr evened out over the strips of an image of H rows (26 rows at tr = 8:
// four strips of 7, 7, 7 and 5, not 8, 8, 8 and 2)
inline int dw_even_rows(int tr, int H) {
  const int strips = (H + tr - 1) / tr;
  return (H + strips - 1) / strips;
}

// Kernel A's prologue: accf [tr * W, C + 8] f32, then from the next
// 128-byte boundary the slab buffer (at least the LayerNorm's three f32
// vectors), then its mbarrier.
__host__ __device__ inline size_t dw_accf_bytes(const DwPlan& pl, int W,
                                                int C) {
  return ((size_t)pl.tr * W * (C + 8) * 4 + 127) / 128 * 128;
}
__host__ __device__ inline size_t dw_slabs_bytes(const DwPlan& pl, int W,
                                                 int C, int elt) {
  const size_t tile = dw_tile_elems(pl, W) * elt;
  return tile > (size_t)12 * C ? tile : (size_t)12 * C;
}
inline size_t dw_prologue_smem(const DwPlan& pl, int W, int C, int elt) {
  return dw_accf_bytes(pl, W, C) + dw_slabs_bytes(pl, W, C, elt) + 8;
}

// ``req`` evened out (segs 0: one piece a thread and row where the threads
// of a unit outnumber the rows), or with req.tr == 0 the chosen plan;
// tr == 0 where none fits. Chosen (scripts/dw_tiles.py, H100): one or two
// rows (three were up to 1.2 times slower at 32 images: fewer CTAs); of
// those plans that leave room for two
// CTAs an SM, the one whose threads sum the most channel outputs a slab,
// up to 14 a thread (longer pieces were no faster), then the most rows
// (less halo), then the narrowest slab: <2,32> at 56^2 x 96, <2,64> at
// 28^2 x 192, <1,128> at 27^2 x 384, with either tap type; no slab wider
// than C needs. Where that leaves a thread fewer than 12 (26^2 x 768: 6.5
// at <1,64>), the same choice among the plans for one CTA an SM (<2,128>,
// 1.1-1.2 times faster there).
inline DwPlan dw_prologue_plan(DwPlan req, int H, int W, int C, int elt,
                               bool dwbf) {
  DwPlan pl{req.tr, req.cs, 0};
  if (req.tr == 0) {
    pl = {1, 32, 0};
    long best = -1;
    for (const size_t room : {(size_t)kSmemTwo, (size_t)kSmemMax}) {
      for (int tr = 1; tr <= 2; ++tr)
        for (int cs = 32; cs <= 256; cs *= 2) {
          const DwPlan c{dw_even_rows(tr, H), cs, 0};
          if (c.tr != tr || cs >= C + 32 ||
              dw_prologue_smem(c, W, C, elt) > room)
            continue;
          const long outs = std::min((long)tr * W * cs, 14L * kThreads);
          const long score = (outs * 4 + tr) * 8 + (8 - __builtin_ctz(cs));
          if (score > best) {
            best = score;
            pl = c;
          }
        }
      if (best >= 12L * kThreads * 32) break;
    }
  }
  pl.tr = dw_even_rows(pl.tr, H);
  if (!dw_plan_ok(pl, dwbf) || dw_prologue_smem(pl, W, C, elt) > kSmemMax)
    pl.tr = 0;
  return pl;
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
