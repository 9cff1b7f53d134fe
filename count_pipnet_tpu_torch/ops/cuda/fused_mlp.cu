// K5: the ConvNeXt block body after the depthwise conv, for training and
// the fused_mlp serving backbone
//
//   out = residual + gamma * (gelu_tanh(LN(x) @ W1^T + b1) @ W2^T + b2)
//
// on [R, C] rows (x and the residual f32 or bf16, bf16 GEMM operands with
// f32 sums, out in the residual's type). Replaces
// count_pipnet_tpu/ops/pallas/fused_mlp.py:fused_ln_mlp_residual (:57).
//
// Bound by the two GEMMs (16 R C^2 operations a call). The TPU kernel keeps
// the 4C-wide hidden activation in VMEM; on Hopper a 64-row wgmma tile's
// pw2 sums at C = 768 would take 75 % of an SM's registers, so K5 is three
// launches on the stream instead, two of them wgmma GEMMs on the TMA-fed
// core of sm90.cuh with the elementwise work fused into their epilogues:
//   a. ln_rows_kernel: LayerNorm of each row -> bf16 n [R, C] (one warp a
//      row; the arithmetic of kernel A's step 1b).
//   b. GEMM 1, n . W1^T, epilogue + b1, tanh-GELU, bf16 -> hidden [R, 4C].
//   c. GEMM 2, hidden . W2^T, epilogue + b2, * gamma, + residual -> out.
// The bf16 hidden activation goes to device memory and back (4 R C bytes
// each way): the plain version rounds the GELU output to bf16 before pw2
// too, so only the order of the sums differs from it. n and hidden are
// scratch that the caller allocates. Bound to Python with ctypes
// (count_pipnet_tpu_torch/ops/fused_mlp.py).
#include "common.cuh"
#include "sm90.cuh"

namespace cpt {
namespace {

constexpr int kLnWarps = 8;  // rows per CTA of ln_rows_kernel

// a. n = bf16(LN(x) * lns + lnb), one warp a row: two-pass mean and
// variance, rsqrtf(var / C + eps), as block.cuh's step 1b.
template <typename T>
__global__ void __launch_bounds__(32 * kLnWarps)
    ln_rows_kernel(const T* __restrict__ x, __nv_bfloat16* __restrict__ n,
                   int R, int C, const float* __restrict__ lns,
                   const float* __restrict__ lnb, float eps) {
  const int row = blockIdx.x * kLnWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= R) return;
  const T* d = x + (size_t)row * C;
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += to_f32(d[c]);
  const float mu = warp_sum(s) / C;
  float v = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float t = to_f32(d[c]) - mu;
    v += t * t;
  }
  const float rs = rsqrtf(warp_sum(v) / C + eps);
  __nv_bfloat16* o = n + (size_t)row * C;
  for (int c = lane; c < C; c += 32)
    o[c] = __float2bfloat16_rn((to_f32(d[c]) - mu) * rs * lns[c] + lnb[c]);
}

// b. hidden = bf16(gelu_tanh(sum + b1))
struct UpGelu {
  const float* b1;
  __nv_bfloat16* h;
  int N;
  __device__ __forceinline__ void operator()(int r, int c,
                                             const float (&v)[8]) const {
    float b[8], o[8];
    load8(b1 + c, b);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = gelu_tanh(v[i] + b[i]);
    store8(h + (size_t)r * N + c, o);
  }
};

// c. out = residual + (sum + b2) * gamma, in the residual's type
template <typename TR>
struct DownResidual {
  const float* b2;
  const float* g;
  const TR* res;
  TR* out;
  int N;
  __device__ __forceinline__ void operator()(int r, int c,
                                             const float (&v)[8]) const {
    const size_t o = (size_t)r * N + c;
    float b[8], gm[8], x[8];
    load8(b2 + c, b);
    load8(g + c, gm);
    load8(res + o, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = x[i] + (v[i] + b[i]) * gm[i];
    store8(out + o, x);
  }
};

// Tile widths, ring depths and CTAs an SM (<BN, STAGES, MINB> of sm90.cuh).
// GEMM 1 (N = 4C, a multiple of 128; K = C, 12 steps at C = 768) keeps
// two 128-wide CTAs on an SM, so that one's GELU epilogue overlaps the
// other's wgmma. GEMM 2 (N = C, K = 4C) is long enough in K that a
// 256-wide tile, one CTA an SM, wins where 256 divides C; else 128 or 96
// (C = 96, 192), masking any remainder.
template <typename Epi>
cudaError_t gemm(bool up, const void* a, const void* b, int M, int N, int K,
                 const Epi& epi, cudaStream_t st) {
  if (!up && N % 256 == 0)
    return sm90::gemm<256, 4, 1>(a, b, M, N, K, epi, st);
  if (N % 128 == 0) return sm90::gemm<128, 3, 2>(a, b, M, N, K, epi, st);
  return sm90::gemm<96, 3, 2>(a, b, M, N, K, epi, st);
}

cudaError_t ln_rows(const void* x, int x_bf16, void* n, int R, int C,
                    const float* lns, const float* lnb, float eps,
                    cudaStream_t st) {
  const dim3 grid((R + kLnWarps - 1) / kLnWarps);
  auto* nb = static_cast<__nv_bfloat16*>(n);
  if (x_bf16) {
    ln_rows_kernel<<<grid, 32 * kLnWarps, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), nb, R, C, lns, lnb, eps);
  } else {
    ln_rows_kernel<<<grid, 32 * kLnWarps, 0, st>>>(
        static_cast<const float*>(x), nb, R, C, lns, lnb, eps);
  }
  return cudaGetLastError();
}

cudaError_t up_gelu(const void* n, const void* w1, const float* b1, void* h,
                    int R, int C, cudaStream_t st) {
  const UpGelu epi{b1, static_cast<__nv_bfloat16*>(h), 4 * C};
  return gemm(true, n, w1, R, 4 * C, C, epi, st);
}

cudaError_t down_residual(const void* h, const void* w2, const float* b2,
                          const float* g, const void* res, int res_bf16,
                          void* out, int R, int C, cudaStream_t st) {
  using BF = __nv_bfloat16;
  if (res_bf16) {
    const DownResidual<BF> epi{b2, g, static_cast<const BF*>(res),
                               static_cast<BF*>(out), C};
    return gemm(false, h, w2, R, C, 4 * C, epi, st);
  }
  const DownResidual<float> epi{b2, g, static_cast<const float*>(res),
                                static_cast<float*>(out), C};
  return gemm(false, h, w2, R, C, 4 * C, epi, st);
}

}  // namespace
}  // namespace cpt

// K5: the three launches. ``n`` ([R, C] bf16) and ``h`` ([R, 4C] bf16) are
// scratch; w1 [4C, C] and w2 [C, 4C] bf16, 16-byte aligned.
extern "C" int cpt_fused_mlp(const void* x, const void* res, void* out,
                             int x_bf16, int res_bf16, int R, int C,
                             const float* lns, const float* lnb,
                             const void* w1, const float* b1, const void* w2,
                             const float* b2, const float* g, float eps,
                             void* n, void* h, void* stream) {
  if (C % 32 != 0 || R <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cpt::ln_rows(x, x_bf16, n, R, C, lns, lnb, eps, st);
  if (err == cudaSuccess) err = cpt::up_gelu(n, w1, b1, h, R, C, st);
  if (err == cudaSuccess)
    err = cpt::down_residual(h, w2, b2, g, res, res_bf16, out, R, C, st);
  return (int)err;
}

// K5's stages on their own, to hold each against its plain version.
extern "C" int cpt_mlp_ln_rows(const void* x, int x_bf16, void* n, int R,
                               int C, const float* lns, const float* lnb,
                               float eps, void* stream) {
  return (int)cpt::ln_rows(x, x_bf16, n, R, C, lns, lnb, eps,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int cpt_mlp_up_gelu(const void* n, const void* w1, const float* b1,
                               void* h, int R, int C, void* stream) {
  return (int)cpt::up_gelu(n, w1, b1, h, R, C,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int cpt_mlp_down_residual(const void* h, const void* w2,
                                     const float* b2, const float* g,
                                     const void* res, int res_bf16, void* out,
                                     int R, int C, void* stream) {
  return (int)cpt::down_residual(h, w2, b2, g, res, res_bf16, out, R, C,
                                 static_cast<cudaStream_t>(stream));
}

// The GEMM core alone: D [M, N] f32 = A [M, K] . B [N, K]^T, with the
// tiles K5 takes for GEMM 1 (N = 4K) or else for GEMM 2.
extern "C" int cpt_sm90_gemm(const void* a, const void* b, float* d, int M,
                             int N, int K, void* stream) {
  const cpt::sm90::StoreF32 epi{d, N};
  return (int)cpt::gemm(N == 4 * K, a, b, M, N, K, epi,
                        static_cast<cudaStream_t>(stream));
}
