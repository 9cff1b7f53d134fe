// Kernel B: the gumbel-hard counting head, and kernel C: the last ConvNeXt
// block fused with that head.
//
// B replaces count_pipnet_tpu/ops/pallas/gumbel_head.py:gumbel_hard_counts
// (:88). Per patch row: f32 logits + Gumbel(0, 1) noise, argmax over the P
// channels (ties to the lowest index), one count for the winner. It reads
// the [B, H*W, P] logits once and is bound by that read; a CTA owns kRows
// rows of one image and keeps its histogram in shared memory, so global
// memory sees at most P atomics per CTA.
//
// C replaces gumbel_head.py:fused_block_gumbel_counts (:268): the block of
// block.cuh with the histogram epilogue, so the last [B, H*W, C] feature
// plane is never written.
//
// Noise: Philox4x32-10 keyed by the seed, counter (channel / 4, patch,
// image), unless a [B, H*W, P] f32 noise tensor is passed (parity checks).
// Both kernels draw the same noise for the same (image, patch, channel).
#include "block.cuh"

namespace cpt {

constexpr int kRows = 64;  // patch rows per CTA of the standalone head

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gumbel_hist_kernel(const T* logits, const float* noise, float* counts,
                       int HW, int C, uint2 key) {
  extern __shared__ float hist[];  // [C]
  const int img = blockIdx.y, p0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < C; c += kThreads) hist[c] = 0.0f;
  __syncthreads();
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int patch = p0 + r;
    if (patch >= HW) break;
    const size_t off = ((size_t)img * HW + patch) * C;
    const T* row = logits + off;
    const int win = noisy_argmax_row(
        [&](int c) { return to_f32(row[c]); }, C,
        noise ? noise + off : nullptr, key, (uint32_t)patch, (uint32_t)img,
        lane);
    if (lane == 0) atomicAdd(hist + win, 1.0f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float h = hist[c];
    if (h != 0.0f) atomicAdd(counts + (size_t)img * C + c, h);
  }
}

}  // namespace cpt

extern "C" int cpt_gumbel_hard_counts(const void* logits, int x_bf16,
                                      const float* noise, float* counts,
                                      int B, int HW, int C,
                                      unsigned long long seed, void* stream) {
  if (C % 4 != 0) return (int)cudaErrorInvalidValue;
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  const dim3 grid((HW + cpt::kRows - 1) / cpt::kRows, B);
  const size_t smem = (size_t)C * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    cpt::gumbel_hist_kernel<__nv_bfloat16><<<grid, cpt::kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(logits), noise, counts, HW, C, key);
  } else {
    cpt::gumbel_hist_kernel<float><<<grid, cpt::kThreads, smem, s>>>(
        static_cast<const float*>(logits), noise, counts, HW, C, key);
  }
  return (int)cudaGetLastError();
}

extern "C" int cpt_fused_block_gumbel_counts(
    const void* x, int x_bf16, int int8, int B, int H, int W, int C,
    const float* dwk, const float* dwb, const float* lns, const float* lnb,
    const void* w1, const float* s1, const float* b1, const float* i1,
    const void* w2, const float* s2, const float* b2, const float* i2,
    const float* g, float eps, const float* noise, float* counts,
    unsigned long long seed, void* stream) {
  cpt::BlockParams p = cpt::make_block_params(
      x, B, H, W, C, dwk, dwb, lns, lnb, w1, s1, b1, i1, w2, s2, b2, i2, g,
      eps);
  p.counts = counts;
  p.noise = noise;
  p.key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  return (int)cpt::launch_fused_block(
      p, x_bf16, int8, static_cast<cudaStream_t>(stream));
}
