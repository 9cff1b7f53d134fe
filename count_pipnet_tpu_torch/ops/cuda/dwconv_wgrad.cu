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
// What bounds it on Hopper: 49 FMAs per element against one read of x and
// of g, so with f32 planes the bytes bind (at 128 x 26^2 x 768: 532 MB,
// 0.159 ms) and with bf16 planes the f32 FMA rate (6.6 GFLOP, 0.098 ms
// at 67 TFLOP/s). The TPU kernel walks the batch in one sequential grid
// and adds each image's 49 tap rows into one [56, C] output block. On
// Hopper blocks run in parallel and in no order, so the reduction over
// B*H*W is split in two launches:
//
//   (a) dwconv7_wgrad_kernel walks block.cuh's halo tile, as K7 does. For
//       a strip of tr image rows and a slab of cs channels it copies two
//       TMA boxes into shared memory: x with its 3-pixel halo,
//       [tr + 6][W + 6][cs] (its zeros past the plane are the SAME
//       padding), and g's own rows, [tr][W][cs]. A thread owns one channel
//       and row pieces (dw_tile_slab's split) and slides the 7x7 window of
//       x along each piece (dw7_tile_run: 7 shared loads a pixel, one more
//       for g, no bounds check), adding win * g into 49 f32 sums and g into
//       a 50th, in registers. The grid is persistent over strips: a slab
//       has ``ctas`` CTAs, about two an SM in all, and each takes a fixed
//       contiguous range of its slab's (image, strip) list, keeping its
//       sums across the range; with two tile buffers the next strip's
//       boxes are copied while this one is walked. (One CTA a strip, as
//       K7 has, would write and read back one [50, cs] partial a strip:
//       79 MB at 128 x 26^2 x 768.) At the end the threads of a channel
//       add their sums in the spent buffer in piece order and the CTA
//       writes one [50, cs] partial.
//   (b) dwconv7_wgrad_sum_kernel adds each column's partials in CTA order.
//
// No float atomics: the plan fixes the order of every sum, so a run on the
// same card repeats bit for bit.
#include "block.cuh"

namespace cpt {

constexpr int kWgRows = 50;  // 49 taps (ky * 7 + kx) + the bias row

struct WgPlan {
  int tr, cs, segs;  // the halo tile (block.cuh: DwPlan)
  int bufs;          // tile buffers a CTA: 1, or 2 (the next strip's copy
                     // under this one's walk)
  int ctas;          // CTAs a slab
};

inline DwPlan wg_tile(const WgPlan& pl) { return {pl.tr, pl.cs, pl.segs}; }

// A buffer: the x tile [tr + 6][W + 6][cs], then the g tile [tr][W][cs],
// each from a 128-byte boundary (TMA); at least the [50][cs] f32 sums of
// the CTA's reduction. The buffers' mbarriers follow the last buffer.
__host__ __device__ inline size_t wg_round(size_t n) {
  return (n + 127) / 128 * 128;
}
__host__ __device__ inline size_t wg_x_bytes(const WgPlan& pl, int W,
                                             int elt) {
  return wg_round((size_t)(pl.tr + 6) * (W + 6) * pl.cs * elt);
}
__host__ __device__ inline size_t wg_buf_bytes(const WgPlan& pl, int W,
                                               int elt) {
  const size_t t =
      wg_x_bytes(pl, W, elt) + wg_round((size_t)pl.tr * W * pl.cs * elt);
  const size_t r = (size_t)kWgRows * pl.cs * 4;
  return t > r ? t : r;
}
inline size_t wg_smem(const WgPlan& pl, int W, int elt) {
  return pl.bufs * (wg_buf_bytes(pl, W, elt) + 8);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    dwconv7_wgrad_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap gmap, int B,
                         int H, int W, int C, const WgPlan pl, float* part) {
  extern __shared__ __align__(1024) unsigned char wg_buf[];
  constexpr int elt = sizeof(T);
  const size_t xbytes = wg_x_bytes(pl, W, elt);
  const size_t bbytes = wg_buf_bytes(pl, W, elt);
  uint64_t* bar = reinterpret_cast<uint64_t*>(wg_buf + pl.bufs * bbytes);
  const int strips = (H + pl.tr - 1) / pl.tr;
  const long long items = (long long)B * strips;
  const int i0 = (int)(items * blockIdx.y / gridDim.y);
  const int i1 = (int)(items * (blockIdx.y + 1) / gridDim.y);
  const int c0 = blockIdx.x * pl.cs;
  const int tx = (pl.tr + 6) * (W + 6) * pl.cs * elt;
  const int tg = pl.tr * W * pl.cs * elt;
  if (threadIdx.x == 0) {
    for (int k = 0; k < pl.bufs; ++k) sm90::mbar_init(bar + k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0 copies strip ``it`` into buffer k
  auto fill = [&](int it, int k) {
    if (threadIdx.x == 0) {
      unsigned char* buf = wg_buf + k * bbytes;
      const int b = it / strips, y0 = (it % strips) * pl.tr;
      sm90::mbar_expect_tx(bar + k, tx + tg);
      dw_box_copy(buf, &xmap, bar + k, b, y0 - 3, -3, c0);
      dw_box_copy(buf + xbytes, &gmap, bar + k, b, y0, 0, c0);
    }
  };
  const int runs = kThreads / pl.cs;
  const int u = threadIdx.x % pl.cs, j = threadIdx.x / pl.cs;
  const bool live = c0 + u < C;
  const int segs = pl.segs;
  const int row = (W + 6) * pl.cs;
  float acc[kWgRows];
#pragma unroll
  for (int k = 0; k < kWgRows; ++k) acc[k] = 0.0f;
  if (pl.bufs == 2 && i0 < i1) fill(i0, 0);
  for (int it = i0; it < i1; ++it) {
    const int n = it - i0, k = n % pl.bufs;
    if (pl.bufs == 1)
      fill(it, 0);
    else if (it + 1 < i1)
      fill(it + 1, (n + 1) & 1);  // freed by the last item's barrier
    sm90::mbar_wait(bar + k, (n / pl.bufs) & 1);
    const T* xt = reinterpret_cast<const T*>(wg_buf + k * bbytes);
    const T* gt = reinterpret_cast<const T*>(wg_buf + k * bbytes + xbytes);
    const int rows = min(pl.tr, H - (it % strips) * pl.tr);
    for (int q = j; live && q < rows * segs; q += runs) {
      const int r = q / segs, s = q % segs;
      const int x0 = s * W / segs, x1 = (s + 1) * W / segs;
      const T* gr = gt + (r * W + x0) * pl.cs + u;
      if (x1 > x0)
        dw7_tile_run<float>(
            xt + r * row + x0 * pl.cs + u, pl.cs, row, x1 - x0,
            [&](int i, const float(&win)[7][7]) {
              const float gv = to_f32(gr[i * pl.cs]);
#pragma unroll
              for (int dy = 0; dy < 7; ++dy)
#pragma unroll
                for (int dx = 0; dx < 7; ++dx)
                  acc[dy * 7 + dx] =
                      __fmaf_rn(win[dy][dx], gv, acc[dy * 7 + dx]);
              acc[49] = __fadd_rn(acc[49], gv);
            });
    }
    __syncthreads();  // the buffer is free
  }
  // the threads of a channel add their sums in piece order, in buffer 0
  float* red = reinterpret_cast<float*>(wg_buf);  // [50][cs]
  for (int jj = 0; jj < runs; ++jj) {
    if (j == jj) {
#pragma unroll
      for (int k = 0; k < kWgRows; ++k)
        red[k * pl.cs + u] =
            jj == 0 ? acc[k] : __fadd_rn(red[k * pl.cs + u], acc[k]);
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.y * kWgRows * C;
  for (int idx = threadIdx.x; idx < kWgRows * pl.cs; idx += kThreads) {
    const int cc = c0 + idx % pl.cs;
    if (cc < C) out[(size_t)(idx / pl.cs) * C + cc] = red[idx];
  }
}

__global__ void dwconv7_wgrad_sum_kernel(const float* part, int ctas, int n,
                                         float* out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s = 0.0f;
  for (int j = 0; j < ctas; ++j) s = __fadd_rn(s, part[(size_t)j * n + idx]);
  out[idx] = s;
}

// ``req`` evened out and checked, or with req.tr == 0 the chosen plan;
// segs 0: one piece a thread and row where the threads of a channel
// outnumber the rows (dw_tile_slab's rule), written into the plan; bufs 0:
// one; ctas 0: enough CTAs to fill ``sms`` SMs at the occupancy the plan's
// shared memory allows (two CTAs an SM up to kSmemTwo); at most one CTA an
// item. tr == 0 where none fits (and for an empty plane).
//
// Chosen (scripts/dw_tiles.py, 128 images of the four stage geometries,
// f32 and bf16 planes, H100): slabs whose box rows are 128 bytes (32 f32
// or 64 bf16 channels) where such slabs divide C (bf16 slabs of 32, rows
// of 64 bytes, were 1.15 times slower at 26^2 x 768), else 32 channels (a
// half-empty 64-channel slab at C = 96: 1.27 times slower); strips of four
// rows, so that each run of a channel's threads walks one piece a strip (8
// runs at 32 channels: half rows; 4 at 64: whole rows): strips of 7-14
// rows, whose pieces fall unevenly on the runs, were 1.1-1.4 times
// slower; two buffers where both leave room for two CTAs an SM, else one
// (at 56^2 x 96 in f32, two buffers at one CTA an SM: 1.07 times slower);
// one CTA a slab and SM slot, a single wave (half or twice as many:
// 1.03-1.8 times slower). The chosen plan was the fastest of 38-104
// candidates at seven of the eight; at 28^2 x 192 in f32 two buffers of
// 64 channels at one CTA an SM were 1.06 times faster. Fewer rows where W
// leaves no room for four.
inline WgPlan dw_wg_plan(WgPlan req, int B, int H, int W, int C, int elt,
                         int sms) {
  WgPlan pl = req;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) {
    pl.tr = 0;
    return pl;
  }
  if (pl.bufs == 0) pl.bufs = 1;
  if (req.tr == 0) {
    const int cs = C % (128 / elt) ? 32 : 128 / elt;
    pl = {0, cs, 0, 1, req.ctas};
    for (const size_t room : {(size_t)kSmemTwo, (size_t)kSmemMax})
      for (int tr = 4; tr >= 1 && pl.tr == 0; --tr)
        for (int bufs = 2; bufs >= 1 && pl.tr == 0; --bufs)
          if (wg_smem({dw_even_rows(tr, H), cs, 0, bufs, 0}, W, elt) <= room)
            pl = {tr, cs, 0, bufs, req.ctas};
    if (pl.tr == 0) return pl;
  }
  pl.tr = dw_even_rows(pl.tr, H);
  if (!dw_plan_ok(wg_tile(pl), false) || pl.bufs > 2 || W + 6 > 256 ||
      pl.tr + 6 > 256 || wg_smem(pl, W, elt) > (size_t)kSmemMax) {
    pl.tr = 0;
    return pl;
  }
  if (pl.segs == 0) pl.segs = std::max(1, kThreads / pl.cs / pl.tr);
  const int slabs = (C + pl.cs - 1) / pl.cs;
  const long long items = (long long)B * ((H + pl.tr - 1) / pl.tr);
  if (pl.ctas <= 0) {
    const int occ = wg_smem(pl, W, elt) <= (size_t)kSmemTwo ? 2 : 1;
    pl.ctas = (sms * occ + slabs - 1) / slabs;
  }
  pl.ctas = (int)std::max(1LL, std::min((long long)pl.ctas, items));
  return pl;
}

}  // namespace cpt

// The plan a launch of K8 takes on [B, H, W, C] planes of elt-byte values,
// from the request (tr, cs, segs, bufs, ctas) in ``plan`` (tr = 0: the
// chosen one; ctas = 0: fill ``sms`` SMs), written back with its shared
// memory in bytes as plan[5]; tr = 0 where none fits.
extern "C" int cpt_dwconv7_wgrad_plan(int B, int H, int W, int C, int elt,
                                      int sms, int* plan) {
  const cpt::WgPlan pl = cpt::dw_wg_plan(
      {plan[0], plan[1], plan[2], plan[3], plan[4]}, B, H, W, C, elt, sms);
  plan[0] = pl.tr; plan[1] = pl.cs; plan[2] = pl.segs;
  plan[3] = pl.bufs; plan[4] = pl.ctas;
  plan[5] = pl.tr == 0 ? 0 : (int)cpt::wg_smem(pl, W, elt);
  return 0;
}

// x, g [B, H, W, C] (bf16 if bf16, else f32), 16-byte aligned, C * elt a
// multiple of 16; the resolved plan (tr, cs, segs, bufs, ctas) of
// cpt_dwconv7_wgrad_plan; part [ctas, 50, C] f32 scratch; out [50, C] f32:
// rows 0..48 the taps (ky * 7 + kx), row 49 the bias gradient.
extern "C" int cpt_dwconv7_wgrad(const void* x, const void* g, int bf16,
                                 int B, int H, int W, int C, int tr, int cs,
                                 int segs, int bufs, int ctas, float* part,
                                 float* out, void* stream) {
  using BF = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elt = bf16 ? 2 : 4;
  const cpt::WgPlan pl =
      cpt::dw_wg_plan({tr, cs, segs, bufs, ctas}, B, H, W, C, elt, 1);
  if (pl.tr == 0 || pl.tr != tr || pl.segs != segs || pl.bufs != bufs ||
      pl.ctas != ctas)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xm, gm;
  cudaError_t err =
      cpt::make_plane_map(&xm, x, B, H, W, C, elt, cpt::wg_tile(pl));
  if (err == cudaSuccess)
    err = cpt::make_plane_map(&gm, g, B, H, W, C, elt, cpt::wg_tile(pl), 0);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + pl.cs - 1) / pl.cs, pl.ctas);
  const int smem = (int)cpt::wg_smem(pl, W, elt);
  auto go = [&](auto kernel) -> int {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, cpt::kThreads, smem, s>>>(xm, gm, B, H, W, C, pl, part);
    return (int)cudaGetLastError();
  };
  const int code = bf16 ? go(cpt::dwconv7_wgrad_kernel<BF>)
                        : go(cpt::dwconv7_wgrad_kernel<float>);
  if (code) return code;
  const int n = cpt::kWgRows * C;
  cpt::dwconv7_wgrad_sum_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      part, pl.ctas, n, out);
  return (int)cudaGetLastError();
}
