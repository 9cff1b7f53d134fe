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
// along W with 7 rolls. Here a CTA owns a strip of tr image rows of one
// image and one slab of cs channels: it copies the strip with its 3-pixel
// halo, (tr + 6) x (W + 6) x cs, into shared memory as one TMA box that
// reads zeros past the plane, and the slab's 49 taps with cp.async, then
// every output of the strip is computed from shared memory by block.cuh's
// halo-tile walk, the one kernel A's prologue runs (dw_tile_slab: a thread
// a channel, its 49 taps in registers, the 7x7 window sliding along its
// row piece, 7 shared loads a pixel, no bounds check). Neighbouring
// threads own neighbouring channels, so the shared loads are conflict-free
// and each warp's stores one contiguous run of the plane. Each input row
// is read from L2 by the strips that need it: (tr + 6) / tr times.
#include "block.cuh"

namespace cpt {

constexpr int kDwThreads = 256;

// K7's shared memory: the slab's tile, its taps [cs][49] f32, the tile's
// mbarrier.
inline size_t dw_k7_smem(const DwPlan& pl, int W, int elt) {
  return dw_tile_elems(pl, W) * elt + (size_t)49 * pl.cs * 4 + 8;
}

// ``req`` evened out, or with req.tr == 0 the chosen plan; tr == 0 where
// none fits. One slab a CTA. Chosen (scripts/dw_tiles.py, H100): slabs of
// 64 channels where 64 divides C (32 at C = 96: a half-empty second slab
// costs more), and the most rows up to 16 whose CTA leaves room for two an
// SM (two strips an image at 26^2 x 768, 90 KB), else one row.
inline DwPlan dw_k7_plan(DwPlan req, int H, int W, int C, int elt) {
  DwPlan pl = req;
  if (req.tr == 0) {
    pl = {1, C % 64 ? 32 : 64, 0};
    for (int tr = 16; tr > 1; --tr)
      if (dw_k7_smem({dw_even_rows(tr, H), pl.cs, 0}, W, elt) <=
          kSmemTwo) {
        pl.tr = tr;
        break;
      }
  }
  pl.tr = dw_even_rows(pl.tr, H);
  if (!dw_plan_ok(pl, false) || dw_k7_smem(pl, W, elt) > (size_t)kSmemMax)
    pl.tr = 0;
  return pl;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// Issue the copy of the slab's taps, w [C, 49] from channel c0 on, into
// ``ws`` [cs][49] (taps of channels past C zero), 16 bytes a cp.async (C a
// multiple of 8; the TMA takes no row of 49 floats: its rows are 16-byte
// multiples). From global memory a warp's 32 channels 49 floats apart
// touch 32 lines a load; from shared memory they hit 32 banks (49 is odd).
__device__ __forceinline__ void dw_taps_fill(float* ws, const float* w,
                                             int C, int c0, int cs) {
  for (int i = threadIdx.x; i < 49 * cs / 4; i += blockDim.x) {
    const bool in = 4 * i < (C - c0) * 49;
    cp_async16(ws + 4 * i, in ? w + (size_t)c0 * 49 + 4 * i : w, in);
  }
}

template <typename T, typename TO>
__global__ void __launch_bounds__(kDwThreads)
    dwconv7_kernel(const __grid_constant__ CUtensorMap map, TO* out, int B,
                   int H, int W, int C, const float* w, const float* bias,
                   const DwPlan pl) {
  extern __shared__ __align__(1024) unsigned char dw_smem[];
  T* tile = reinterpret_cast<T*>(dw_smem);
  float* ws = reinterpret_cast<float*>(tile + dw_tile_elems(pl, W));
  uint64_t* bar = reinterpret_cast<uint64_t*>(ws + 49 * pl.cs);
  const int strips = (H + pl.tr - 1) / pl.tr;
  const int b = blockIdx.x / strips, y0 = (blockIdx.x % strips) * pl.tr;
  const int rows = min(pl.tr, H - y0), c0 = blockIdx.y * pl.cs;
  dw_bar_init(bar);
  dw_tile_fill(tile, &map, bar, dw_box_bytes(pl, W, sizeof(T)), b, y0, c0);
  dw_taps_fill(ws, w, C, c0, pl.cs);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  sm90::mbar_wait(bar, 0);
  __syncthreads();  // every thread's taps
  TO* o = out + ((size_t)b * H + y0) * W * C;
  dw_tile_slab<float>(tile, pl, rows, W, C, c0, ws, c0, 1, 49, bias, [] {},
                      [&](int r, int xx, int c, float d) {
                        store_as(o + ((size_t)r * W + xx) * C + c, d);
                      });
}

}  // namespace cpt

// x [B, H, W, C] (bf16 if x_bf16, else f32), out the same shape (bf16 if
// out_bf16), w [C, 49] f32 (the [C, 1, 7, 7] parameter as it lies), bias
// [C] f32. C a multiple of 8, x 16-byte aligned. The halo tile (block.cuh:
// DwPlan): tr = 0 the chosen plan, else (tr, cs, segs).
extern "C" int cpt_dwconv7(const void* x, void* out, int x_bf16,
                           int out_bf16, int B, int H, int W, int C,
                           const float* w, const float* bias, int tr, int cs,
                           int segs, void* stream) {
  using BF = __nv_bfloat16;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return 0;
  const int elt = x_bf16 ? 2 : 4;
  const cpt::DwPlan pl = cpt::dw_k7_plan({tr, cs, segs}, H, W, C, elt);
  if (pl.tr == 0 || C % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const cudaError_t err =
      cpt::make_plane_map(&map, x, B, H, W, C, elt, pl);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * ((H + pl.tr - 1) / pl.tr), (C + pl.cs - 1) / pl.cs);
  const int smem = (int)cpt::dw_k7_smem(pl, W, elt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel, auto op) -> int {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, cpt::kDwThreads, smem, s>>>(map, op, B, H, W, C, w, bias,
                                               pl);
    return (int)cudaGetLastError();
  };
  BF* ob = static_cast<BF*>(out);
  float* of = static_cast<float*>(out);
  if (x_bf16) {
    return out_bf16 ? go(cpt::dwconv7_kernel<BF, BF>, ob)
                    : go(cpt::dwconv7_kernel<BF, float>, of);
  }
  return out_bf16 ? go(cpt::dwconv7_kernel<float, BF>, ob)
                  : go(cpt::dwconv7_kernel<float, float>, of);
}

// The halo tile a launch takes, kernel A's prologue's (``prologue``;
// block.cuh: dw_prologue_plan) or K7's (dw_k7_plan), from the request (tr,
// cs, segs) in ``plan`` (tr = 0: the chosen one), written back into
// ``plan`` with its shared memory in bytes as plan[3]; tr = 0 where none
// fits.
extern "C" int cpt_dw_plan(int prologue, int H, int W, int C, int elt,
                           int dw_bf16, int* plan) {
  const cpt::DwPlan req{plan[0], plan[1], plan[2]};
  const cpt::DwPlan pl =
      prologue ? cpt::dw_prologue_plan(req, H, W, C, elt, dw_bf16)
               : cpt::dw_k7_plan(req, H, W, C, elt);
  plan[0] = pl.tr; plan[1] = pl.cs; plan[2] = pl.segs;
  plan[3] = pl.tr == 0 ? 0
            : prologue ? (int)cpt::dw_prologue_smem(pl, W, C, elt)
                       : (int)cpt::dw_k7_smem(pl, W, elt);
  return 0;
}
