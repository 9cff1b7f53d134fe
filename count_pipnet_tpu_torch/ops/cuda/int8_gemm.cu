// K10: a GEMM with dynamic per-row int8 activations and per-column int8
// weights,
//
//   out[m, n] = (sum_k q(x)[m, k] * wq[n, k]) * ascale[m] * wscale[n] + b[n]
//
// with q(x) = round(x / ascale), ascale = max(max_k |x[m, k]|, 1e-9) / 127,
// int32 sums and an f32 epilogue cast to the output type. Replaces
// count_pipnet_tpu/ops/pallas/int8_gemm.py:int8_quant_gemm (:47), which the
// JAX package runs on the 2x2 im2col of the wide stride-1 downsample convs
// (models/quantized.py:286-302). Bound to Python with ctypes
// (count_pipnet_tpu_torch/ops/int8_gemm.py).
//
// What bounds it on Hopper: 2 M K N int8 operations against reading x once
// (M K bf16) - at the downsample shapes (K = 768 or 1536) the operations.
// As on the TPU the activations are quantized inside the kernel, so no int8
// copy of x goes through device memory:
//
//   1. A CTA owns 64 rows. One warp a row takes the abs-max over K and
//      writes the quantized row into shared memory (64 x (K + 16) bytes,
//      99 KB at K = 1536).
//   2. Each warp walks 16-column slices of N: all 64 rows (four m16 tiles)
//      against two n8 tiles of the [N, K] int8 weights, mma.sync m16n8k32
//      s8 with int32 sums; the weight fragments come from L2 (kernel A's
//      loads, block.cuh), each read once per CTA.
//   3. Epilogue: acc * ascale * wscale + b in f32, each step rounded on its
//      own (no fused multiply-add, as the plain version computes it).
//
// A weight pipeline through shared memory and wgmma are later work.
#include "block.cuh"

namespace cpt {

constexpr int kGemmRows = 64;      // rows per CTA
constexpr int kGemmThreads = 256;  // 8 warps
constexpr int kGemmCols = 16;      // columns of a warp's slice

__host__ __device__ inline size_t int8_gemm_smem_bytes(int K) {
  return (size_t)kGemmRows * (K + 16) + (size_t)kGemmRows * sizeof(float);
}

template <typename T, typename TO>
__global__ void __launch_bounds__(kGemmThreads)
    int8_quant_gemm_kernel(const T* x, const int8_t* wq, const float* ws,
                           const float* bias, TO* out, int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ks = K + 16;  // quantized row stride (bytes)
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* asc = reinterpret_cast<float*>(smem + (size_t)kGemmRows * ks);
  const int row0 = blockIdx.x * kGemmRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, tq = lane & 3;

  // 1. quantize the CTA's rows (rows past M: zeros)
  for (int r = warp; r < kGemmRows; r += kGemmThreads / 32) {
    const int row = row0 + r;
    int8_t* q = xq + (size_t)r * ks;
    if (row >= M) {
      for (int k = lane; k < K; k += 32) q[k] = 0;
      if (lane == 0) asc[r] = 0.0f;
      continue;
    }
    const T* xr = x + (size_t)row * K;
    float m = 0.0f;
    for (int k = lane; k < K; k += 32) m = fmaxf(m, fabsf(to_f32(xr[k])));
    const float sc = row_scale(warp_max(m));
    for (int k = lane; k < K; k += 32) q[k] = quant_row(to_f32(xr[k]), sc);
    if (lane == 0) asc[r] = sc;
  }
  __syncthreads();

  // 2. + 3. the product, slice by slice, and its epilogue
  const unsigned char* a_base = reinterpret_cast<const unsigned char*>(xq);
  const unsigned char* w = reinterpret_cast<const unsigned char*>(wq);
  for (int n0 = warp * kGemmCols; n0 < N;
       n0 += (kGemmThreads / 32) * kGemmCols) {
    int acc[4][2][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0;
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 32) {
      uint32_t b[2][2];
#pragma unroll
      for (int t = 0; t < 2; ++t)
        load_frag_b(b[t], w + (size_t)(n0 + 8 * t) * K + k0, K, lane);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4];
        load_frag_a(a, a_base + (size_t)(mt * 16) * ks + k0, ks, lane);
#pragma unroll
        for (int t = 0; t < 2; ++t) mma(acc[mt][t], a, b[t], int8_t());
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mt * 16 + g8 + (e >> 1) * 8, row = row0 + r;
        if (row >= M) continue;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int n = n0 + 8 * t + tq * 2 + (e & 1);
          const float v = __fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][t][e]), asc[r]),
                        ws[n]),
              bias[n]);
          store_as(out + (size_t)row * N + n, v);
        }
      }
  }
}

}  // namespace cpt

// x [M, K] (bf16 if x_bf16, else f32), wq [N, K] int8, ws and bias [N] f32,
// out [M, N] (bf16 if out_bf16, else f32). K % 32 == 0, N % 16 == 0.
extern "C" int cpt_int8_quant_gemm(const void* x, int x_bf16,
                                   const int8_t* wq, const float* ws,
                                   const float* bias, void* out, int out_bf16,
                                   int M, int K, int N, void* stream) {
  using BF = __nv_bfloat16;
  if (M <= 0 || K <= 0 || N <= 0 || K % 32 != 0 || N % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = cpt::int8_gemm_smem_bytes(K);
  const dim3 grid((M + cpt::kGemmRows - 1) / cpt::kGemmRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel, auto* xp, auto* op) -> int {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, cpt::kGemmThreads, smem, s>>>(xp, wq, ws, bias, op, M, K,
                                                N);
    return (int)cudaGetLastError();
  };
  if (x_bf16) {
    const BF* xp = static_cast<const BF*>(x);
    return out_bf16 ? go(cpt::int8_quant_gemm_kernel<BF, BF>, xp,
                         static_cast<BF*>(out))
                    : go(cpt::int8_quant_gemm_kernel<BF, float>, xp,
                         static_cast<float*>(out));
  }
  const float* xp = static_cast<const float*>(x);
  return out_bf16 ? go(cpt::int8_quant_gemm_kernel<float, BF>, xp,
                       static_cast<BF*>(out))
                  : go(cpt::int8_quant_gemm_kernel<float, float>, xp,
                       static_cast<float*>(out));
}
