// K8: the weight and bias gradient of the depthwise 7x7 (stride 1, pad 3):
//
//   dK[c, ky, kx] = sum_{b,y,x} x[b, y+ky-3, x+kx-3, c] * g[b, y, x, c]
//   db[c]         = sum_{b,y,x} g[b, y, x, c]
//
// on compact NHWC planes x, g [B, H, W, C] (both f32 or both bf16), f32
// sums. Replaces count_pipnet_tpu/ops/pallas/dwconv_bwd.py:dwconv7_wgrad
// (:79). Bound to Python with ctypes (count_pipnet_tpu_torch/ops/
// dwconv_bwd.py).
//
// The TPU kernel walks the batch in one sequential grid and adds each
// image's 49 tap rows (7 rolls of g, 49 multiply-reduces) into one [56, C]
// output block. On Hopper blocks run in parallel and in no order, so the
// reduction over B*H*W (about 400k rows per tap at 128 images) is split:
//
//   (a) dwconv7_wgrad_kernel: a CTA owns 32 channels (one per lane, so a
//       warp's loads are contiguous) and a chunk of 8 * seg pixels; each
//       warp walks seg consecutive pixels with kernel A's sliding window
//       (block.cuh:dw7_walk), so the 7x7 window of x around each output
//       pixel costs 7 loads, and keeps its 49 tap sums and the bias sum in
//       registers (49 FMAs a pixel). The 8 warps are added in shared
//       memory in a fixed order and the CTA writes one partial [50, C]
//       slab of its chunk.
//   (b) dwconv7_wgrad_sum_kernel adds the slabs in chunk order.
//
// No float atomics: a run on the same card repeats bit for bit. What bounds
// it: the 49 FMAs per element (f32 FMA rate); x and g are read once each
// from device memory, the window's re-reads hit L1/L2.
#include "block.cuh"

namespace cpt {

constexpr int kWgWarps = 8;
constexpr int kWgRows = 50;  // 49 taps (ky * 7 + kx) + the bias row

template <typename T>
__global__ void __launch_bounds__(32 * kWgWarps)
    dwconv7_wgrad_kernel(const T* x, const T* g, int B, int H, int W, int C,
                         int seg, float* part) {
  __shared__ float red[kWgRows][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int total = B * H * W;
  const int start = (blockIdx.y * kWgWarps + warp) * seg;
  float acc[49];
#pragma unroll
  for (int k = 0; k < 49; ++k) acc[k] = 0.0f;
  float accb = 0.0f;
  if (c < C && start < total) {
    dw7_walk(
        x, H, W, C, c, start, seg, total,
        [&](int i, const float(&win)[7][7]) {
          const float gv = to_f32(g[(size_t)(start + i) * C + c]);
          accb += gv;
#pragma unroll
          for (int dy = 0; dy < 7; ++dy)
#pragma unroll
            for (int dx = 0; dx < 7; ++dx)
              acc[dy * 7 + dx] += win[dy][dx] * gv;
        },
        [](int) {});
  }
  // the warps' sums, added in warp order
  for (int w = 0; w < kWgWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int k = 0; k < 49; ++k)
        red[k][lane] = w == 0 ? acc[k] : red[k][lane] + acc[k];
      red[49][lane] = w == 0 ? accb : red[49][lane] + accb;
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < kWgRows * 32; idx += 32 * kWgWarps) {
    const int k = idx >> 5, l = idx & 31, cc = blockIdx.x * 32 + l;
    if (cc < C) part[((size_t)blockIdx.y * kWgRows + k) * C + cc] = red[k][l];
  }
}

__global__ void dwconv7_wgrad_sum_kernel(const float* part, int chunks,
                                         int n, float* out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s = 0.0f;
  for (int j = 0; j < chunks; ++j) s += part[(size_t)j * n + idx];
  out[idx] = s;
}

}  // namespace cpt

// x, g [B, H, W, C] (bf16 if bf16, else f32); part [chunks, 50, C] f32
// scratch with chunks = ceil(B*H*W / (8 * seg)); out [50, C] f32: rows
// 0..48 the taps (ky * 7 + kx), row 49 the bias gradient.
extern "C" int cpt_dwconv7_wgrad(const void* x, const void* g, int bf16,
                                 int B, int H, int W, int C, int seg,
                                 int chunks, float* part, float* out,
                                 void* stream) {
  using BF = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)B * H * W;
  if (seg <= 0 || chunks * (long long)cpt::kWgWarps * seg < total)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((C + 31) / 32, chunks);
  if (bf16) {
    cpt::dwconv7_wgrad_kernel<BF><<<grid, 32 * cpt::kWgWarps, 0, s>>>(
        static_cast<const BF*>(x), static_cast<const BF*>(g), B, H, W, C,
        seg, part);
  } else {
    cpt::dwconv7_wgrad_kernel<float><<<grid, 32 * cpt::kWgWarps, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), B, H, W,
        C, seg, part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = cpt::kWgRows * C;
  cpt::dwconv7_wgrad_sum_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, chunks,
                                                                 n, out);
  return (int)cudaGetLastError();
}
