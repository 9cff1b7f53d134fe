// K7: depthwise 7x7 convolution + bias (stride 1, SAME padding 3) on a
// compact NHWC plane [B, H, W, C], f32 or bf16 in, f32 or bf16 out, f32
// sums. Replaces count_pipnet_tpu/ops/pallas/dwconv.py:dwconv7 (:79), the
// forward of ``--fused_dwconv``. Bound to Python with ctypes
// (count_pipnet_tpu_torch/ops/dwconv.py).
//
// What bounds it on Hopper: 49 FMAs per output element against one read
// and one write of the plane, so with bf16 planes the f32 FMA rate binds
// (at 128 x 26^2 x 768: 6.5 GFLOP, 0.097 ms at 67 TFLOP/s, against 0.079 ms
// for the 266 MB). The TPU kernel built the H halo in VMEM and shifted
// along W with 7 rolls; here the halo is bounds checks and each thread
// walks kSeg consecutive pixels of one channel with kernel A's sliding
// window (block.cuh:dw7_walk): 7 loads a pixel, the 49 taps in registers.
// Neighbouring threads own neighbouring channels, so every load of a warp
// is one contiguous run of the plane. No shared memory: the 7 rows of a
// window are re-read from L1/L2 by the threads of the next pixels.
#include "block.cuh"

namespace cpt {

constexpr int kDwSeg = 16;       // pixels a thread walks
constexpr int kDwThreads = 256;

template <typename T, typename TO>
__global__ void __launch_bounds__(kDwThreads)
    dwconv7_kernel(const T* x, TO* out, int B, int H, int W, int C,
                   const float* w, const float* bias) {
  const int total = B * H * W;
  const long long nseg = (total + kDwSeg - 1) / kDwSeg;
  const long long t = (long long)blockIdx.x * kDwThreads + threadIdx.x;
  if (t >= nseg * C) return;
  const int c = (int)(t % C);
  const int start = (int)(t / C) * kDwSeg;
  float wk[49];
#pragma unroll
  for (int i = 0; i < 49; ++i) wk[i] = w[c * 49 + i];  // [C, 1, 7, 7]
  const float bv = bias[c];
  dw7_walk(
      x, H, W, C, c, start, kDwSeg, total,
      [&](int i, const float(&win)[7][7]) {
        store_as(out + (size_t)(start + i) * C + c, dw7_dot(win, wk, bv));
      },
      [](int) {});
}

}  // namespace cpt

// x [B, H, W, C] (bf16 if x_bf16, else f32), out the same shape (bf16 if
// out_bf16), w [C, 49] f32 (the [C, 1, 7, 7] parameter as it lies), bias
// [C] f32.
extern "C" int cpt_dwconv7(const void* x, void* out, int x_bf16,
                           int out_bf16, int B, int H, int W, int C,
                           const float* w, const float* bias, void* stream) {
  using BF = __nv_bfloat16;
  const long long total = (long long)B * H * W;
  const long long threads = (total + cpt::kDwSeg - 1) / cpt::kDwSeg * C;
  if (total <= 0 || C <= 0) return 0;
  const dim3 grid((unsigned)((threads + cpt::kDwThreads - 1) /
                             cpt::kDwThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel, auto xp, auto op) -> int {
    kernel<<<grid, cpt::kDwThreads, 0, s>>>(xp, op, B, H, W, C, w, bias);
    return (int)cudaGetLastError();
  };
  const BF* xb = static_cast<const BF*>(x);
  const float* xf = static_cast<const float*>(x);
  BF* ob = static_cast<BF*>(out);
  float* of = static_cast<float*>(out);
  if (x_bf16) {
    return out_bf16 ? go(cpt::dwconv7_kernel<BF, BF>, xb, ob)
                    : go(cpt::dwconv7_kernel<BF, float>, xb, of);
  }
  return out_bf16 ? go(cpt::dwconv7_kernel<float, BF>, xf, ob)
                  : go(cpt::dwconv7_kernel<float, float>, xf, of);
}
