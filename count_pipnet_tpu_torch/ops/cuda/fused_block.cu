// Kernel A: one whole ConvNeXt block on compact NHWC planes [B, H, W, C],
// for serving and for the --fused_whole_blocks forward:
//
//   out = x + gamma * (gelu_tanh(LN(dw7x7(x) + dwb) W1^T + b1) W2^T + b2)
//
// Replaces count_pipnet_tpu/ops/pallas/fused_block.py:fused_block_apply_padded
// (:358) and :fused_block_apply (:499), with the bf16, int8-static and
// dynamic int8 bodies of both; ``dw_bf16``: the depthwise taps in bf16 (the
// TPU's tap_dtype=bfloat16) in any mode. Bound to Python with ctypes
// (count_pipnet_tpu_torch/ops/fused_block.py).
//
// What bounds it on Hopper: the two pointwise GEMMs, 16 R C^2 operations on
// R = B H W rows, against one read and one write of the plane. The TPU
// kernel keeps the 4C-wide hidden activation in VMEM; on Hopper a 128-row
// wgmma tile's GEMM 2 sums at C = 768 would be a [128, 768] f32
// accumulator, 384 KB, which no SM holds (K5's reasoning, fused_mlp.cu). So
// the bf16 and int8-static modes are three launches on the stream:
//   a. block_prologue_kernel: depthwise 7x7 + bias, LayerNorm, then the cast
//      (bf16) or the static quantization (int8: quant_scaled(n, i1)) into
//      n [R, C]. Steps 1a and 1b of block.cuh's body through the same
//      functions (block_dw_rows, ln_stats, ln_value), so n is the bits that
//      kernel C computes for its GEMM operand.
//   b. GEMM 1, n . W1^T, on sm90.cuh's TMA-fed wgmma core: bf16, K5's
//      up_gelu (fused_mlp.cu) -> bf16 hidden; int8-static, the core's s8
//      mode with the epilogue up_static -> int8 hidden [R, 4C].
//   c. GEMM 2, hidden . W2^T: bf16, K5's down_residual with the block input
//      x as the residual; int8-static, the s8 mode with the epilogue
//      block_out -> out in x's type.
// n and the hidden activation go to device memory and back: 10 R C bytes
// each way in bf16, 5 R C in int8. The int8 sums are exact, and every step
// of the static mode's arithmetic is block.cuh's pinned function, which
// kernel C calls too: its output is the bits kernel C takes its argmax of.
// The dynamic int8 mode (mode 2) stays on block.cuh's one-kernel body: its
// GELU scale spans the whole 4C row.
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

// a. the prologue: a CTA owns kTM rows, as block.cuh's body does, and two
// CTAs share an SM (at most 128 registers a thread). Unbounded, the
// bf16-tap instantiations took 161-163 registers and one CTA an SM; kernel
// A ran 5-17 % slower so (H100).
template <typename T, bool INT8, bool DWBF>
__global__ void __launch_bounds__(kThreads, 2)
    block_prologue_kernel(const BlockParams p, void* n) {
  extern __shared__ __align__(16) unsigned char pro_smem[];
  float* accf = reinterpret_cast<float*>(pro_smem);  // [kTM, C + 8]
  const int C = p.C, total = p.B * p.H * p.W, as = C + 8;
  const int row0 = blockIdx.x * kTM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  block_dw_rows<T, DWBF>(p, accf, as, row0);
  __syncthreads();
  for (int r = warp; r < kTM; r += kThreads / 32) {
    const int row = row0 + r;
    if (row >= total) break;
    const float* d = accf + r * as;
    const float2 st = ln_stats(d, C, p.eps, lane);
    if constexpr (INT8) {
      int8_t* o = static_cast<int8_t*>(n) + (size_t)row * C;
      for (int c = lane; c < C; c += 32)
        o[c] = quant_scaled(ln_value(d[c], st, p.lns[c], p.lnb[c]), p.i1[c]);
    } else {
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(n) + (size_t)row * C;
      for (int c = lane; c < C; c += 32)
        o[c] = __float2bfloat16_rn(ln_value(d[c], st, p.lns[c], p.lnb[c]));
    }
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

// The s8 GEMMs' tiles <BN, STAGES, CTAs an SM> by ``tile``: 1-5 the
// candidates (scripts/block_tiles.py times each on the card), 0 the choice
// for the GEMM and width (default_tile, from those times).
constexpr int kTiles = 5;

int default_tile(bool up, int N) {
  if (!up && N % 256 == 0) return 2;
  if (N % 128 == 0) return 1;
  return 3;
}

template <typename Epi>
cudaError_t gemm_s8(bool up, int tile, const void* a, const void* b, int M,
                    int N, int K, const Epi& epi, cudaStream_t st) {
  using I8 = int8_t;
  switch (tile == 0 ? default_tile(up, N) : tile) {
    case 1: return sm90::gemm<128, 3, 2, Epi, I8>(a, b, M, N, K, epi, st);
    case 2: return sm90::gemm<256, 4, 1, Epi, I8>(a, b, M, N, K, epi, st);
    case 3: return sm90::gemm<96, 3, 2, Epi, I8>(a, b, M, N, K, epi, st);
    case 4: return sm90::gemm<64, 4, 2, Epi, I8>(a, b, M, N, K, epi, st);
    case 5: return sm90::gemm<192, 3, 1, Epi, I8>(a, b, M, N, K, epi, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t prologue(const BlockParams& p, void* n, int dw_bf16, int x_bf16,
                     int int8, cudaStream_t st) {
  const int total = p.B * p.H * p.W;
  const dim3 grid((total + kTM - 1) / kTM);
  const int smem = kTM * (p.C + 8) * 4;
  auto go = [&](auto kernel) -> cudaError_t {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, st>>>(p, n);
    return cudaGetLastError();
  };
  using BF = __nv_bfloat16;
  const int k = (dw_bf16 ? 4 : 0) + (x_bf16 ? 2 : 0) + (int8 ? 1 : 0);
  switch (k) {
    case 0: return go(block_prologue_kernel<float, false, false>);
    case 1: return go(block_prologue_kernel<float, true, false>);
    case 2: return go(block_prologue_kernel<BF, false, false>);
    case 3: return go(block_prologue_kernel<BF, true, false>);
    case 4: return go(block_prologue_kernel<float, false, true>);
    case 5: return go(block_prologue_kernel<float, true, true>);
    case 6: return go(block_prologue_kernel<BF, false, true>);
    default: return go(block_prologue_kernel<BF, true, true>);
  }
}

cudaError_t up(const void* n, const void* w1, const float* s1,
               const float* b1, const float* i2, void* h, int int8, int R,
               int C, int tile, cudaStream_t st) {
  if (!int8)
    return tile ? cudaErrorInvalidValue
                : (cudaError_t)cpt_mlp_up_gelu(n, w1, b1, h, R, C, st);
  const UpStatic epi{s1, b1, i2, static_cast<int8_t*>(h), 4 * C};
  return gemm_s8(true, tile, n, w1, R, 4 * C, C, epi, st);
}

cudaError_t down(const void* h, const void* w2, const float* s2,
                 const float* b2, const float* g, const void* x, int x_bf16,
                 void* out, int int8, int R, int C, int tile,
                 cudaStream_t st) {
  if (!int8)
    return tile ? cudaErrorInvalidValue
                : (cudaError_t)cpt_mlp_down_residual(h, w2, b2, g, x, x_bf16,
                                                     out, R, C, st);
  using BF = __nv_bfloat16;
  if (x_bf16) {
    const DownStatic<BF> epi{s2, b2, g, static_cast<const BF*>(x),
                             static_cast<BF*>(out), C};
    return gemm_s8(false, tile, h, w2, R, C, 4 * C, epi, st);
  }
  const DownStatic<float> epi{s2, b2, g, static_cast<const float*>(x),
                              static_cast<float*>(out), C};
  return gemm_s8(false, tile, h, w2, R, C, 4 * C, epi, st);
}

}  // namespace
}  // namespace cpt

// Kernel A. ``mode``: 0 bf16, 1 int8 with static scales (three launches;
// ``n`` [R, C] and ``h`` [R, 4C] are scratch of the GEMM operand type, and
// x, out, w1, w2 are 16-byte aligned), 2 int8 with dynamic per-row scales
// (block.cuh's body, one launch; n and h unused).
extern "C" int cpt_fused_block(
    const void* x, void* out, int dw_bf16, int x_bf16, int mode, int B,
    int H, int W, int C, const float* dwk, const float* dwb, const float* lns,
    const float* lnb, const void* w1, const float* s1, const float* b1,
    const float* i1, const void* w2, const float* s2, const float* b2,
    const float* i2, const float* g, float eps, void* n, void* h,
    void* stream) {
  const cpt::BlockParams p = cpt::make_block_params(
      x, out, B, H, W, C, dwk, dwb, lns, lnb, w1, s1, b1, i1, w2, s2, b2, i2,
      g, eps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == cpt::kQDyn)
    return (int)(dw_bf16
                     ? cpt::launch_fused_block<false, true>(p, x_bf16, mode,
                                                            st)
                     : cpt::launch_fused_block<false>(p, x_bf16, mode, st));
  const int R = B * H * W;
  if (C % 32 != 0 || R <= 0 || (mode != cpt::kQBf16 && mode != cpt::kQStatic))
    return (int)cudaErrorInvalidValue;
  const int int8 = mode == cpt::kQStatic;
  cudaError_t err = cpt::prologue(p, n, dw_bf16, x_bf16, int8, st);
  if (err == cudaSuccess)
    err = cpt::up(n, w1, s1, b1, i2, h, int8, R, C, 0, st);
  if (err == cudaSuccess)
    err = cpt::down(h, w2, s2, b2, g, x, x_bf16, out, int8, R, C, 0, st);
  return (int)err;
}

// Kernel A's three launches on their own, to hold each against its plain
// version and to time it; ``tile`` (int8 GEMMs): 0 the chosen tile, 1-5
// the candidates.
extern "C" int cpt_block_prologue(const void* x, void* n, int dw_bf16,
                                  int x_bf16, int int8, int B, int H, int W,
                                  int C, const float* dwk, const float* dwb,
                                  const float* lns, const float* lnb,
                                  const float* i1, float eps, void* stream) {
  if (C % 32 != 0 || B * H * W <= 0) return (int)cudaErrorInvalidValue;
  const cpt::BlockParams p = cpt::make_block_params(
      x, nullptr, B, H, W, C, dwk, dwb, lns, lnb, nullptr, nullptr, nullptr,
      i1, nullptr, nullptr, nullptr, nullptr, nullptr, eps);
  return (int)cpt::prologue(p, n, dw_bf16, x_bf16, int8,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int cpt_block_up(const void* n, const void* w1, const float* s1,
                            const float* b1, const float* i2, void* h,
                            int int8, int R, int C, int tile, void* stream) {
  if (tile < 0 || tile > cpt::kTiles) return (int)cudaErrorInvalidValue;
  return (int)cpt::up(n, w1, s1, b1, i2, h, int8, R, C, tile,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int cpt_block_down(const void* h, const void* w2, const float* s2,
                              const float* b2, const float* g, const void* x,
                              int x_bf16, void* out, int int8, int R, int C,
                              int tile, void* stream) {
  if (tile < 0 || tile > cpt::kTiles) return (int)cudaErrorInvalidValue;
  return (int)cpt::down(h, w2, s2, b2, g, x, x_bf16, out, int8, R, C, tile,
                        static_cast<cudaStream_t>(stream));
}

// The GEMM core's s8 mode alone: D [M, N] s32 = A [M, K] . B [N, K]^T,
// int8, with the tile kernel A's GEMM 1 (N = 4K) or else its GEMM 2 takes.
extern "C" int cpt_sm90_gemm_s8(const void* a, const void* b, int* d, int M,
                                int N, int K, void* stream) {
  const cpt::sm90::StoreS32 epi{d, N};
  return (int)cpt::gemm_s8(N == 4 * K, 0, a, b, M, N, K, epi,
                           static_cast<cudaStream_t>(stream));
}
