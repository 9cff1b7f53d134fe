// Kernel A: one whole ConvNeXt block on compact NHWC planes [B, H, W, C],
// for serving and for the --fused_whole_blocks forward:
//
//   out = x + gamma * (gelu_tanh(LN(dw7x7(x) + dwb) W1^T + b1) W2^T + b2)
//
// Replaces count_pipnet_tpu/ops/pallas/fused_block.py:fused_block_apply_padded
// (:358) and :fused_block_apply (:499), with the bf16, int8-static and
// dynamic int8 bodies of both (_kernel_int8, :250, and _kernel_int8_pad,
// :313, in the dynamic mode); ``dw_bf16``: the depthwise taps in bf16 (the
// TPU's tap_dtype=bfloat16) in any mode. Bound to Python with ctypes
// (count_pipnet_tpu_torch/ops/fused_block.py).
//
// What bounds it on Hopper: the two pointwise GEMMs, 16 R C^2 operations on
// R = B H W rows, against one read and one write of the plane. The TPU
// kernel keeps the 4C-wide hidden activation in VMEM; on Hopper a 128-row
// wgmma tile's GEMM 2 sums at C = 768 would be a [128, 768] f32
// accumulator, 384 KB, which no SM holds (K5's reasoning, fused_mlp.cu). So
// kernel A is launches on the stream, three in the bf16 and int8-static
// modes:
//   a. block_prologue_kernel: depthwise 7x7 + bias (block.cuh:
//      block_dw_tile, the shared-memory halo tile K7 also runs), LayerNorm
//      (ln_stats, ln_value), then the cast (bf16) or the static
//      quantization (int8: quant_scaled(n, i1)) into n [R, C]. A CTA owns
//      whole image rows, a contiguous range of n's rows.
//   b. GEMM 1, n . W1^T, on sm90.cuh's TMA-fed wgmma core: bf16, K5's
//      up_gelu (fused_mlp.cu) -> bf16 hidden; int8-static, the core's s8
//      mode with the epilogue up_static -> int8 hidden [R, 4C].
//   c. GEMM 2, hidden . W2^T: bf16, K5's down_residual with the block input
//      x as the residual; int8-static, the s8 mode with the epilogue
//      block_out -> out in x's type.
// n and the hidden activation go to device memory and back: 10 R C bytes
// each way in bf16, 5 R C in int8. The int8 sums are exact, and every step
// of the static mode's arithmetic is block.cuh's pinned function. Kernel C
// (gumbel_head.cu) runs launches a and b through this file's entries and
// its own GEMM 2, whose epilogue computes block_out as c does: its argmax
// sees the bits kernel A writes.
//
// The dynamic int8 mode quantizes each row with its own scale: the LN
// output over its C values, the GELU output over its 4C. A GEMM 1 tile
// holds at most 256 of a row's 4C GELU values, so no tile knows the row's
// scale. Four launches, all the s8 GEMMs on the core:
//   a. the prologue with a per-row scale: a warp owns a row, takes the
//      abs-max of its LN values, writes n [R, C] int8 and nsc [R] f32
//      (row_scale, quant_row), and zeroes the row's slot of amax [R];
//   b1. GEMM 1, scan pass: the epilogue up_dyn, and each row's |GELU|
//      maximum over the tile (the threads that hold one row reduce first)
//      atomicMax'ed into amax as float bits; it writes nothing else;
//   b2. GEMM 1 again, quantize pass: up_dyn, then quant_row with the row's
//      scale row_scale(amax) -> int8 hidden [R, 4C], and that scale into
//      asc [R]. The s32 sums are exact and up_dyn is pinned, so both passes
//      compute the same bits; recomputing GEMM 1 (8 R C^2 more operations)
//      keeps the hidden scratch in int8, where an f32 hidden activation and
//      a row-quantize pass would move about 31 R C bytes more;
//   c. GEMM 2, the s8 mode with the epilogue block_out(x, sum * asc, ...).
#include "block.cuh"
#include "sm90.cuh"

// K5's GEMM launches (fused_mlp.cu), kernel A's bf16 GEMMs
extern "C" int cpt_mlp_up_gelu(const void* n, const void* w1, const float* b1,
                               void* h, int R, int C, void* stream);
extern "C" int cpt_mlp_down_residual(const void* h, const void* w2,
                                     const float* b2, const float* g,
                                     const void* res, int res_bf16, void* out,
                                     int R, int C, void* stream);

namespace cpt {
namespace {

// a. the prologue: a CTA owns pl.tr whole image rows of one image (fewer in
// its last strip), rows * W rows of n from row0, and two CTAs share an SM
// (at most 128 registers a thread) where the plan's shared memory allows.
// Unbounded, the bf16-tap instantiations of the older walk took 161-163
// registers and one CTA an SM; kernel A ran 5-17 % slower so (H100).
// Shared memory: accf [pl.tr * W, C + 8] f32, the depthwise sums the
// LayerNorm reads, then the halo tile's slab buffer (block.cuh:
// block_dw_tile), which then holds the LayerNorm's scale, bias and (int8
// static) quantization vectors, C floats each. ``Q``: the operand mode
// (block.cuh: kQ*); ``nsc`` and ``amax`` (kQDyn): each row's scale, and its
// GELU abs-max slot, zeroed here for GEMM 1's scan pass (null: left alone);
// ``keys``: each row's argmax key slot, zeroed here for kernel C's GEMM 2
// (null: left alone).
template <typename T, int Q, bool DWBF>
__global__ void __launch_bounds__(kThreads, 2)
    block_prologue_kernel(const __grid_constant__ CUtensorMap map,
                          const BlockParams p, const DwPlan pl, void* n,
                          float* nsc, int* amax, unsigned long long* keys) {
  extern __shared__ __align__(1024) unsigned char pro_smem[];
  const int C = p.C, W = p.W, as = C + 8;
  const int strips = (p.H + pl.tr - 1) / pl.tr;
  const int b = blockIdx.x / strips, y0 = (blockIdx.x % strips) * pl.tr;
  const int rows = min(pl.tr, p.H - y0);
  const int row0 = (b * p.H + y0) * W, npix = rows * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* accf = reinterpret_cast<float*>(pro_smem);
  unsigned char* slabs = pro_smem + dw_accf_bytes(pl, W, C);
  T* tile = reinterpret_cast<T*>(slabs);
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      slabs + dw_slabs_bytes(pl, W, C, sizeof(T)));
  block_dw_tile<T, DWBF>(p, pl, &map, accf, as, tile, bar, b, y0, rows);
  // The LayerNorm's channel vectors into the slab buffer, which the
  // depthwise sums are done with: read from global memory, each value of
  // the row loop waited on its own loads (a CTA at 26^2 x 768 spent 29 % of
  // its time there, H100).
  float* lns = reinterpret_cast<float*>(tile);
  float* lnb = lns + C;
  float* i1 = lnb + C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    lns[c] = p.lns[c];
    lnb[c] = p.lnb[c];
    if constexpr (Q == kQStatic) i1[c] = p.i1[c];
  }
  __syncthreads();
  // Each row's statistics lane-strided (ln_stats' order); its values, which
  // depend on no order, four channels a lane.
  for (int r = warp; r < npix; r += kThreads / 32) {
    const int row = row0 + r;
    float* d = accf + r * as;
    const float2 st = ln_stats(d, C, p.eps, lane);
    auto value4 = [&](int c) {
      const float4 x = *reinterpret_cast<const float4*>(d + c);
      const float4 s = *reinterpret_cast<const float4*>(lns + c);
      const float4 t = *reinterpret_cast<const float4*>(lnb + c);
      return make_float4(ln_value(x.x, st, s.x, t.x),
                         ln_value(x.y, st, s.y, t.y),
                         ln_value(x.z, st, s.z, t.z),
                         ln_value(x.w, st, s.w, t.w));
    };
    if constexpr (Q == kQDyn) {
      // the row's LN output in place of its depthwise output, its abs-max,
      // then the row quantized with its own scale
      float m = 0.0f;
      for (int c = 4 * lane; c < C; c += 128) {
        const float4 v = value4(c);
        *reinterpret_cast<float4*>(d + c) = v;
        m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                           fmaxf(fabsf(v.z), fabsf(v.w))));
      }
      const float sc = row_scale(warp_max(m));
      int8_t* o = static_cast<int8_t*>(n) + (size_t)row * C;
      for (int c = 4 * lane; c < C; c += 128) {
        const float4 v = *reinterpret_cast<const float4*>(d + c);
        *reinterpret_cast<char4*>(o + c) =
            make_char4(quant_row(v.x, sc), quant_row(v.y, sc),
                       quant_row(v.z, sc), quant_row(v.w, sc));
      }
      if (lane == 0) {
        nsc[row] = sc;
        if (amax != nullptr) amax[row] = 0;
      }
    } else if constexpr (Q == kQStatic) {
      int8_t* o = static_cast<int8_t*>(n) + (size_t)row * C;
      for (int c = 4 * lane; c < C; c += 128) {
        const float4 v = value4(c);
        const float4 q = *reinterpret_cast<const float4*>(i1 + c);
        *reinterpret_cast<char4*>(o + c) =
            make_char4(quant_scaled(v.x, q.x), quant_scaled(v.y, q.y),
                       quant_scaled(v.z, q.z), quant_scaled(v.w, q.w));
      }
    } else {
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(n) + (size_t)row * C;
      for (int c = 4 * lane; c < C; c += 128) {
        const float4 v = value4(c);
        __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                               __floats2bfloat162_rn(v.z, v.w)};
        *reinterpret_cast<uint2*>(o + c) = *reinterpret_cast<uint2*>(h);
      }
    }
    if (keys != nullptr && lane == 0) keys[row] = 0ull;
  }
}

// b. GEMM 1's int8-static epilogue: hidden = up_static(sum), int8
struct UpStatic {
  const float* s1;
  const float* b1;
  const float* i2;
  int8_t* h;
  int N;
  __device__ __forceinline__ void operator()(int r, int c,
                                             const int (&v)[8]) const {
    float s[8], b[8], q[8];
    load8(s1 + c, s);
    load8(b1 + c, b);
    load8(i2 + c, q);
    uint2 u;
    int8_t* o = reinterpret_cast<int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = up_static(v[i], s[i], b[i], q[i]);
    *reinterpret_cast<uint2*>(h + (size_t)r * N + c) = u;
  }
};

// b1. GEMM 1's dynamic scan pass: amax[r] = max(amax[r], |up_dyn(sum)|)
// over the eight columns, as float bits (non-negative floats order as their
// int bits, so atomicMax takes the max in any order). The threads of a
// warp that hold the same row (16 of a 128-wide tile) reduce first, so a
// row takes one atomic per warp and tile.
struct UpDynScan {
  const float* nsc;
  const float* s1;
  const float* b1;
  int* amax;
  __device__ __forceinline__ void operator()(int r, int c,
                                             const int (&v)[8]) const {
    float s[8], b[8];
    load8(s1 + c, s);
    load8(b1 + c, b);
    const float sc = nsc[r];
    float m = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      m = fmaxf(m, fabsf(up_dyn(v[i], sc, s[i], b[i])));
    const unsigned same = __match_any_sync(__activemask(), r);
    const int top = __reduce_max_sync(same, __float_as_int(m));
    if ((int)(threadIdx.x & 31) == __ffs(same) - 1) atomicMax(amax + r, top);
  }
};

// b2. GEMM 1's dynamic quantize pass: hidden = quant_row(up_dyn(sum),
// row_scale(amax[r])), int8, and the row's scale into asc (by the thread of
// column 0)
struct UpDynQuant {
  const float* nsc;
  const float* s1;
  const float* b1;
  const int* amax;
  float* asc;
  int8_t* h;
  int N;
  __device__ __forceinline__ void operator()(int r, int c,
                                             const int (&v)[8]) const {
    float s[8], b[8];
    load8(s1 + c, s);
    load8(b1 + c, b);
    const float sc = nsc[r], q = row_scale(__int_as_float(amax[r]));
    if (c == 0) asc[r] = q;
    uint2 u;
    int8_t* o = reinterpret_cast<int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[i] = quant_row(up_dyn(v[i], sc, s[i], b[i]), q);
    *reinterpret_cast<uint2*>(h + (size_t)r * N + c) = u;
  }
};

// c. GEMM 2's int8-static epilogue: out = block_out(x, sum), x's type
template <typename T>
struct DownStatic {
  const float* s2;
  const float* b2;
  const float* g;
  const T* x;
  T* out;
  int N;
  __device__ __forceinline__ void operator()(int r, int c,
                                             const int (&v)[8]) const {
    const size_t o = (size_t)r * N + c;
    float s[8], b[8], gm[8], xv[8];
    load8(s2 + c, s);
    load8(b2 + c, b);
    load8(g + c, gm);
    load8(x + o, xv);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      xv[i] = block_out(xv[i], (float)v[i], s[i], b[i], gm[i]);
    store8(out + o, xv);
  }
};

// c. GEMM 2's dynamic epilogue: the same with the sum first scaled by its
// row's GELU scale, as the plain version does: block_out(x, sum * asc[r])
template <typename T>
struct DownDyn {
  const float* asc;
  const float* s2;
  const float* b2;
  const float* g;
  const T* x;
  T* out;
  int N;
  __device__ __forceinline__ void operator()(int r, int c,
                                             const int (&v)[8]) const {
    const size_t o = (size_t)r * N + c;
    float s[8], b[8], gm[8], xv[8];
    load8(s2 + c, s);
    load8(b2 + c, b);
    load8(g + c, gm);
    load8(x + o, xv);
    const float a = asc[r];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      xv[i] =
          block_out(xv[i], __fmul_rn((float)v[i], a), s[i], b[i], gm[i]);
    store8(out + o, xv);
  }
};

template <typename T, bool DWBF>
cudaError_t prologue_as(const BlockParams& p, DwPlan pl, void* n, float* nsc,
                        int* amax, unsigned long long* keys, int mode,
                        cudaStream_t st) {
  pl = dw_prologue_plan(pl, p.H, p.W, p.C, sizeof(T), DWBF);
  if (pl.tr == 0) return cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t err =
      make_plane_map(&map, p.x, p.B, p.H, p.W, p.C, sizeof(T), pl);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * ((p.H + pl.tr - 1) / pl.tr));
  const int smem = (int)dw_prologue_smem(pl, p.W, p.C, sizeof(T));
  auto go = [&](auto kernel) -> cudaError_t {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, st>>>(map, p, pl, n, nsc, amax, keys);
    return cudaGetLastError();
  };
  switch (mode) {
    case kQBf16: return go(block_prologue_kernel<T, kQBf16, DWBF>);
    case kQStatic: return go(block_prologue_kernel<T, kQStatic, DWBF>);
    case kQDyn: return go(block_prologue_kernel<T, kQDyn, DWBF>);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t prologue(const BlockParams& p, const DwPlan& pl, void* n,
                     float* nsc, int* amax, unsigned long long* keys,
                     int dw_bf16, int x_bf16, int mode, cudaStream_t st) {
  using BF = __nv_bfloat16;
  if (dw_bf16)
    return x_bf16
               ? prologue_as<BF, true>(p, pl, n, nsc, amax, keys, mode, st)
               : prologue_as<float, true>(p, pl, n, nsc, amax, keys, mode,
                                          st);
  return x_bf16
             ? prologue_as<BF, false>(p, pl, n, nsc, amax, keys, mode, st)
             : prologue_as<float, false>(p, pl, n, nsc, amax, keys, mode, st);
}

// The dynamic mode's GEMM 1 passes (``passes``): bit 0 the scan, bit 1 the
// quantize pass.
enum : int { kScan = 1, kQuantize = 2 };

cudaError_t up(const void* n, const void* w1, const float* s1,
               const float* b1, const float* i2, void* h, const float* nsc,
               int* amax, float* asc, int mode, int passes, int R, int C,
               int tile, cudaStream_t st) {
  if (mode == kQBf16)
    return tile ? cudaErrorInvalidValue
                : (cudaError_t)cpt_mlp_up_gelu(n, w1, b1, h, R, C, st);
  int8_t* hq = static_cast<int8_t*>(h);
  if (mode == kQStatic)
    return gemm_tiled<int8_t>(true, tile, n, w1, R, 4 * C, C,
                              UpStatic{s1, b1, i2, hq, 4 * C}, st);
  if (mode != kQDyn || passes < kScan || passes > (kScan | kQuantize))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (passes & kScan)
    err = gemm_tiled<int8_t>(true, tile, n, w1, R, 4 * C, C,
                             UpDynScan{nsc, s1, b1, amax}, st);
  if (err == cudaSuccess && (passes & kQuantize))
    err = gemm_tiled<int8_t>(true, tile, n, w1, R, 4 * C, C,
                             UpDynQuant{nsc, s1, b1, amax, asc, hq, 4 * C},
                             st);
  return err;
}

cudaError_t down(const void* h, const void* w2, const float* s2,
                 const float* b2, const float* g, const float* asc,
                 const void* x, int x_bf16, void* out, int mode, int R, int C,
                 int tile, cudaStream_t st) {
  if (mode == kQBf16)
    return tile ? cudaErrorInvalidValue
                : (cudaError_t)cpt_mlp_down_residual(h, w2, b2, g, x, x_bf16,
                                                     out, R, C, st);
  using BF = __nv_bfloat16;
  auto go = [&](auto epi) {
    return gemm_tiled<int8_t>(false, tile, h, w2, R, C, 4 * C, epi, st);
  };
  const BF* xb = static_cast<const BF*>(x);
  const float* xf = static_cast<const float*>(x);
  BF* ob = static_cast<BF*>(out);
  float* of = static_cast<float*>(out);
  if (mode == kQStatic)
    return x_bf16 ? go(DownStatic<BF>{s2, b2, g, xb, ob, C})
                  : go(DownStatic<float>{s2, b2, g, xf, of, C});
  if (mode == kQDyn)
    return x_bf16 ? go(DownDyn<BF>{asc, s2, b2, g, xb, ob, C})
                  : go(DownDyn<float>{asc, s2, b2, g, xf, of, C});
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cpt

// Kernel A. ``mode`` (block.cuh: kQ*): 0 bf16, 1 int8 with static scales,
// 2 int8 with dynamic per-row scales. Scratch from the caller: ``n`` [R, C]
// and ``h`` [R, 4C] of the GEMM operand type, and (mode 2) ``rs`` [3, R]
// f32: the rows' LN scales, GELU abs-max and GELU scales. x, out, w1, w2
// are 16-byte aligned.
extern "C" int cpt_fused_block(
    const void* x, void* out, int dw_bf16, int x_bf16, int mode, int B,
    int H, int W, int C, const float* dwk, const float* dwb, const float* lns,
    const float* lnb, const void* w1, const float* s1, const float* b1,
    const float* i1, const void* w2, const float* s2, const float* b2,
    const float* i2, const float* g, float eps, void* n, void* h, float* rs,
    void* stream) {
  const int R = B * H * W;
  if (C % 32 != 0 || R <= 0 || (mode == cpt::kQDyn && rs == nullptr))
    return (int)cudaErrorInvalidValue;
  const cpt::BlockParams p = cpt::make_block_params(
      x, B, H, W, C, dwk, dwb, lns, lnb, w1, s1, b1, i1, w2, s2, b2, i2, g,
      eps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* nsc = rs;
  int* amax = rs ? reinterpret_cast<int*>(rs + R) : nullptr;
  float* asc = rs ? rs + 2 * R : nullptr;
  cudaError_t err = cpt::prologue(p, cpt::DwPlan{0, 0, 0}, n, nsc,
                                  amax, nullptr, dw_bf16, x_bf16, mode, st);
  if (err == cudaSuccess)
    err = cpt::up(n, w1, s1, b1, i2, h, nsc, amax, asc, mode,
                  cpt::kScan | cpt::kQuantize, R, C, 0, st);
  if (err == cudaSuccess)
    err = cpt::down(h, w2, s2, b2, g, asc, x, x_bf16, out, mode, R, C, 0, st);
  return (int)err;
}

// Kernel A's launches on their own, to hold each against its plain version
// and to time it; kernel C runs the prologue and GEMM 1 through them. Mode
// 2: the prologue writes ``nsc`` [R] and zeroes ``amax`` [R] (when not
// null); modes 0 and 1: it zeroes ``keys`` [R] (when not null), kernel C's
// argmax keys; ``passes`` picks GEMM 1's scan pass (1, into
// ``amax``), quantize pass (2, from ``amax``, writes ``asc`` [R]) or both
// (3); GEMM 2 reads ``asc``. ``tile`` (int8 GEMMs): 0 the chosen tile, 1-5
// the candidates. The prologue's halo tile (block.cuh: DwPlan): tr = 0 the
// chosen plan, else the plan (tr, cs) (its row pieces: block.cuh,
// dw_prologue_plan).
extern "C" int cpt_block_prologue(const void* x, void* n, float* nsc,
                                  int* amax, unsigned long long* keys,
                                  int dw_bf16, int x_bf16,
                                  int mode, int B, int H, int W, int C,
                                  const float* dwk, const float* dwb,
                                  const float* lns, const float* lnb,
                                  const float* i1, float eps, int tr, int cs,
                                  void* stream) {
  if (C % 32 != 0 || B * H * W <= 0) return (int)cudaErrorInvalidValue;
  const cpt::BlockParams p = cpt::make_block_params(
      x, B, H, W, C, dwk, dwb, lns, lnb, nullptr, nullptr, nullptr, i1,
      nullptr, nullptr, nullptr, nullptr, nullptr, eps);
  return (int)cpt::prologue(p, cpt::DwPlan{tr, cs, 0}, n, nsc,
                            amax, keys, dw_bf16, x_bf16, mode,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int cpt_block_up(const void* n, const void* w1, const float* s1,
                            const float* b1, const float* i2, void* h,
                            const float* nsc, int* amax, float* asc,
                            int mode, int passes, int R, int C, int tile,
                            void* stream) {
  if (tile < 0 || tile > cpt::kTiles) return (int)cudaErrorInvalidValue;
  return (int)cpt::up(n, w1, s1, b1, i2, h, nsc, amax, asc, mode, passes, R,
                      C, tile, static_cast<cudaStream_t>(stream));
}

extern "C" int cpt_block_down(const void* h, const void* w2, const float* s2,
                              const float* b2, const float* g,
                              const float* asc, const void* x, int x_bf16,
                              void* out, int mode, int R, int C, int tile,
                              void* stream) {
  if (tile < 0 || tile > cpt::kTiles) return (int)cudaErrorInvalidValue;
  return (int)cpt::down(h, w2, s2, b2, g, asc, x, x_bf16, out, mode, R, C,
                        tile, static_cast<cudaStream_t>(stream));
}

// The GEMM core's s8 mode alone: D [M, N] s32 = A [M, K] . B [N, K]^T,
// int8, with the tile kernel A's GEMM 1 (N = 4K) or else its GEMM 2 takes.
extern "C" int cpt_sm90_gemm_s8(const void* a, const void* b, int* d, int M,
                                int N, int K, void* stream) {
  const cpt::sm90::StoreS32 epi{d, N};
  return (int)cpt::gemm_tiled<int8_t>(N == 4 * K, 0, a, b, M, N, K, epi,
                                      static_cast<cudaStream_t>(stream));
}
