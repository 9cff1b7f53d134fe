// K9: the softmax counting head of Count-PIPNet's deterministic serving
// path,
//
//   counts[b, p] = sum_patch softmax_p(x[b, patch, :] . w[p, :] + bias[p])
//
// on [B, H*W, C] features (f32 or bf16), w [P, C] f32 (the 1x1 conv's
// weight), bias [P] f32, counts [B, P] f32. Replaces
// count_pipnet_tpu/ops/pallas/fused_head.py:fused_count_head (:69). Bound to
// Python with ctypes (count_pipnet_tpu_torch/ops/fused_head.py).
//
// What bounds it on Hopper: 2 B HW C P f32 operations (f32 products and
// sums, as the TPU kernel's f32 matmul; no TF32) against reading the
// features once - the f32 FMA rate. As on the TPU the [B, H*W, P] prototype
// maps never reach device memory:
//
//   1. A CTA owns 32 patch rows of one image and keeps their [32, P] logits
//      in shared memory (P <= 1024: 128 KB). It fills them 128 columns at a
//      time: x and w are staged through shared memory 32 channels at a time
//      (x converted to f32 as it is loaded), each thread sums a 4 x 4 tile
//      in registers, channel by channel in order (SIMT FMA).
//   2. One warp a row: the row max, the sum of exponentials (IEEE expf and
//      division), the normalized probabilities in place.
//   3. The CTA adds its rows' probabilities column by column, in row order,
//      into one partial [P] row; a second kernel adds the partial rows of an
//      image in order. No float atomics: a run repeats bit for bit.
//
// The identity weight (num_features = 0) still runs the product, as the
// JAX package does. Larger row tiles (fewer weight reads from L2), tensor
// cores and the identity as a special case are later work.
#include "common.cuh"

namespace cpt {

constexpr int kHeadRows = 32;      // patch rows per CTA
constexpr int kHeadCols = 128;     // logit columns per pass
constexpr int kHeadK = 32;         // channels per staging step
constexpr int kHeadThreads = 256;  // 8 warps: warp -> 4 rows, lane -> 4 cols
constexpr int kHeadMaxP = 1024;

__host__ __device__ inline size_t head_smem_bytes(int P) {
  return ((size_t)kHeadRows * (P + 4)          // logits
          + (size_t)kHeadK * (kHeadRows + 1)   // x stage, [k][row]
          + (size_t)kHeadK * (kHeadCols + 4))  // w stage, [k][col]
         * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kHeadThreads)
    fused_count_head_kernel(const T* x, const float* w, const float* bias,
                            float* part, int HW, int C, int P) {
  extern __shared__ __align__(16) float hsm[];
  const int ls = P + 4;  // logits row stride
  float* logits = hsm;
  float* xs = logits + (size_t)kHeadRows * ls;
  float* wsm = xs + kHeadK * (kHeadRows + 1);
  const int img = blockIdx.y, r0 = blockIdx.x * kHeadRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* xi = x + (size_t)img * HW * C;

  // 1. logits, 128 columns at a time
  for (int p0 = 0; p0 < P; p0 += kHeadCols) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < C; k0 += kHeadK) {
      // x [32 rows, 32 channels]: lanes along channels (coalesced)
      for (int idx = tid; idx < kHeadRows * kHeadK; idx += kHeadThreads) {
        const int r = idx / kHeadK, kk = idx - r * kHeadK;
        xs[kk * (kHeadRows + 1) + r] =
            r0 + r < HW ? to_f32(xi[(size_t)(r0 + r) * C + k0 + kk]) : 0.0f;
      }
      // w [128 cols, 32 channels]: a thread loads 4 channels of one column
      for (int idx = tid; idx < kHeadCols * (kHeadK / 4); idx += kHeadThreads) {
        const int q = idx / kHeadCols, cl = idx - q * kHeadCols;
        const int p = p0 + cl;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (p < P)
          v = __ldg(reinterpret_cast<const float4*>(w + (size_t)p * C + k0) +
                    q);
        wsm[(4 * q + 0) * (kHeadCols + 4) + cl] = v.x;
        wsm[(4 * q + 1) * (kHeadCols + 4) + cl] = v.y;
        wsm[(4 * q + 2) * (kHeadCols + 4) + cl] = v.z;
        wsm[(4 * q + 3) * (kHeadCols + 4) + cl] = v.w;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kHeadK; ++k) {
        const float* xr = xs + k * (kHeadRows + 1) + warp * 4;
        const float4 wv =
            *reinterpret_cast<const float4*>(wsm + k * (kHeadCols + 4) +
                                             lane * 4);
        const float wj[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = xr[i];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv, wj[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + lane * 4 + j;
      if (p >= P) continue;
      const float bp = bias[p];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        logits[(warp * 4 + i) * ls + p] = acc[i][j] + bp;
    }
  }
  __syncthreads();

  // 2. softmax over P, row by row; rows past H*W become zeros
  for (int r = warp; r < kHeadRows; r += kHeadThreads / 32) {
    float* lr = logits + (size_t)r * ls;
    if (r0 + r >= HW) {
      for (int p = lane; p < P; p += 32) lr[p] = 0.0f;
      continue;
    }
    float m = -INFINITY;
    for (int p = lane; p < P; p += 32) m = fmaxf(m, lr[p]);
    m = warp_max(m);
    float s = 0.0f;
    for (int p = lane; p < P; p += 32) {
      const float e = expf(lr[p] - m);
      lr[p] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int p = lane; p < P; p += 32) lr[p] = __fdiv_rn(lr[p], s);
  }
  __syncthreads();

  // 3. the CTA's partial counts, rows added in order
  float* out = part + ((size_t)img * gridDim.x + blockIdx.x) * P;
  for (int p = tid; p < P; p += kHeadThreads) {
    float s = 0.0f;
    for (int r = 0; r < kHeadRows; ++r) s += logits[(size_t)r * ls + p];
    out[p] = s;
  }
}

// counts[b, p] = sum over the image's tiles of part[b, t, p], in tile order
__global__ void fused_count_head_sum_kernel(const float* part, int tiles,
                                            int B, int P, float* counts) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * P) return;
  const int b = idx / P, p = idx - b * P;
  const float* pb = part + (size_t)b * tiles * P + p;
  float s = 0.0f;
  for (int t = 0; t < tiles; ++t) s += pb[(size_t)t * P];
  counts[idx] = s;
}

}  // namespace cpt

// x [B, HW, C] (bf16 if x_bf16, else f32), w [P, C] f32, bias [P] f32,
// part [B, tiles, P] f32 scratch with tiles = ceil(HW / 32), counts [B, P]
// f32. C % 32 == 0, P <= 1024.
extern "C" int cpt_fused_count_head(const void* x, int x_bf16, const float* w,
                                    const float* bias, float* part,
                                    float* counts, int B, int HW, int C,
                                    int P, void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || C % cpt::kHeadK != 0 || P <= 0 ||
      P > cpt::kHeadMaxP)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (HW + cpt::kHeadRows - 1) / cpt::kHeadRows;
  const dim3 grid(tiles, B);
  const size_t smem = cpt::head_smem_bytes(P);
  auto go = [&](auto kernel, auto* xp) -> cudaError_t {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, cpt::kHeadThreads, smem, s>>>(xp, w, bias, part, HW, C,
                                                 P);
    return cudaGetLastError();
  };
  cudaError_t err =
      x_bf16 ? go(cpt::fused_count_head_kernel<__nv_bfloat16>,
                  static_cast<const __nv_bfloat16*>(x))
             : go(cpt::fused_count_head_kernel<float>,
                  static_cast<const float*>(x));
  if (err != cudaSuccess) return (int)err;
  const int n = B * P;
  cpt::fused_count_head_sum_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      part, tiles, B, P, counts);
  return (int)cudaGetLastError();
}
