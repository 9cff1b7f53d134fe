// The port's Hopper GEMM core (sm_90a):
//
//   D[M, N] = A[M, K] . B[N, K]^T                          (gemm)
//   D[M, N] = A[K, M]^T . B[K, N], split over K           (gemm_mn)
//   D1 = A1 . B1^T and D2 = A2 . B2^T of one tile          (dual_gemm)
//
// gemm: A and B bf16 (f32 sums in registers) or int8 (exact s32 sums),
// row-major with K contiguous (the torch layout of a Linear's input and
// weight, so weights need no transpose). gemm_mn takes both operands MN-major (M and N contiguous: the
// activations of a weight gradient, summed over their rows) through wgmma's
// transpose immediates and the MN-major descriptor; dual_gemm runs two
// K-major products of the same shape in one CTA (below, at each kernel).
// What the core does not own - bias, activation, scale, residual, the store
// and its type - is an epilogue functor that receives the sums eight
// adjacent columns at a time: epi(row, col, v) with v[i] the sum of column
// col + i, only where row < M and col < N (N % 8 == 0).
//
// Design (NVIDIA's Hopper tuning guide; CUTLASS's "warp-specialized"
// kernels take the same shape):
//   - A CTA owns a [kBM = 128, BN] tile of D. Its K loop walks 128 bytes
//     of each row at a time (kBK = 64 bf16 columns, or 128 int8 ones): the
//     width of the TMA 128-byte swizzle.
//   - One producer warp issues TMA tile loads through tensor maps (A tiles
//     [128, 64], B tiles [BN, 64], 128-byte swizzle) into a ring of STAGES
//     shared-memory stages, each with a "full" mbarrier (the TMA reports
//     the bytes it wrote) and an "empty" one (each consumer warp arrives
//     when its warpgroup's wgmma no longer read the stage).
//   - Two consumer warpgroups, 64 rows each, run wgmma.mma_async m64nBNk16
//     (bf16 in, f32 out) or m64nBNk32 (s8 in, s32 out) from shared memory
//     on both operands, four per stage (32 bytes of K each), and keep one
//     stage's wgmma in flight while they wait for the next.
//   - Rows past M and columns past K read as zeros (the TMA fills them), so
//     ragged M, N and K need no special path; the epilogue masks rows and
//     columns past the end.
//   - The epilogue stages the tile (f32 or s32) through the (then idle) ring, so
//     that each thread hands the functor eight adjacent columns of one row
//     and a warp's loads and stores cover whole rows (16-byte accesses).
//     With a 128-wide tile and three stages two CTAs fit on an SM
//     (MINB = 2), so one CTA's epilogue runs under the other's wgmma.
// One CTA a tile. Tried on the H100 and left out, as no faster for K5's
// GEMMs: two-CTA clusters that multicast the B tile, and a persistent grid
// that loads the next tile under this one's epilogue.
// The wgmma shared-memory descriptors are the 128-byte-swizzle K-major
// layout that the tensor maps write: 8-row groups 1024 bytes apart (SBO),
// each stage 1024-byte aligned, a 16-deep K step 32 bytes further along the
// swizzled row. The s8 mode has the same bytes everywhere: a stage is 128
// int8 columns (the same 128-byte rows, swizzle and descriptors), a 32-deep
// step the same 32 bytes along the row; 8-bit wgmma reads K-major operands
// only, which is what gemm takes. Its s32 sums are exact in any order
// (|sum| <= 127^2 K < 2^31 for K < 133,000) and reach the epilogue as
// ints: an epilogue of the s8 mode takes ``const int (&v)[8]``.
//
// cuTensorMapEncodeTiled is a driver API function: it is looked up through
// the runtime (cudaGetDriverEntryPoint), so the library links no -lcuda.
// Maps are built on the host for each call and passed to the kernel as
// __grid_constant__ parameters.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no driver library is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cpt {
namespace sm90 {

constexpr int kBM = 128;                   // CTA rows: two warpgroups of 64
constexpr int kBK = 64;                    // K per stage: 128 bytes of bf16
constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp

// ---- host: TMA tensor maps ----

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major [rows, K] matrix of bf16 (``elt`` 2) or int8 (``elt`` 1) as
// TMA tiles of [box_rows, 128 bytes] with 128-byte swizzle. TMA needs a
// 16-byte aligned base and row stride.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int rows,
                            int K, int box_rows, int elt = 2) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(base) & 15) || (K * elt) % 16 ||
      rows <= 0)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * elt};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elt), (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = enc(map,
                         elt == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         2,
                         const_cast<void*>(base), dims, strides, box, steps,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- device: barriers, TMA, wgmma ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity ``parity`` of ``bar`` has completed. A
// wait that does not end within 2^26 polls (seconds) traps: a fault in the
// pipeline becomes a launch error instead of a kernel that never ends.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// TMA: the tile of ``map`` at (column c0, row c1) into shared ``dst``;
// ``bar`` counts its bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: start address
// (16-byte units), LBO 16 bytes (unused by this layout), SBO 1024 bytes
// (the next 8-row group), layout type 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t a = smem_addr(tile);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// wgmma descriptor of an MN-major tile in the 128-byte swizzle, as the TMA
// writes a [kBK rows of K, 64 columns of M or N] box: each K row is one
// 128-byte row of 64 MN values, 8 K rows make a 1024-byte swizzle atom.
// SBO 1024 bytes (the next 8 K rows), LBO ``lbo`` bytes (the next 64 MN
// values: the next box), layout type 1 = 128-byte swizzle. A 16-deep K step
// is 16 rows, 2048 bytes further on.
__device__ __forceinline__ uint64_t desc_sw128_mn(const void* tile,
                                                  uint32_t lbo) {
  const uint64_t a = smem_addr(tile);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// a wgmma fence or wait (the wgmma writes them asynchronously).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x N] (+)= A[64 x 16] . B[N x 16]^T, both from shared memory
// (descriptors ``a``, ``b``), K-major; ``acc`` 0 overwrites d. The f32
// accumulator of thread t of the warpgroup: d[4 j + e] is row
// 16 (t / 32) + (t % 32) / 4 + 8 (e / 2), column 8 j + 2 (t % 4) + e % 2.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a,
                                           uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<96>(float (&d)[48], uint64_t a,
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t a,
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// The same with both operands MN-major (wgmma's transpose immediates set):
// A[64 x 16] and B[N x 16] stored with M and N contiguous; N = 128, 256.
template <int N>
__device__ __forceinline__ void wgmma_bf16_mn(float (&d)[N / 2], uint64_t a,
                                              uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_bf16_mn<128>(float (&d)[64],
                                                   uint64_t a, uint64_t b,
                                                   int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16_mn<256>(float (&d)[128],
                                                   uint64_t a, uint64_t b,
                                                   int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t a,
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(acc));
}

// d[64 x N] (+)= A[64 x 32] . B[N x 32]^T, s8 operands from shared memory,
// K-major, exact s32 sums; the accumulator layout of wgmma_bf16.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a,
                                         uint64_t b, int acc);

#define CPT_RW4(d, i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define CPT_RW16(d, i) \
  CPT_RW4(d, i), CPT_RW4(d, i + 4), CPT_RW4(d, i + 8), CPT_RW4(d, i + 12)
#define CPT_RW32(d) CPT_RW16(d, 0), CPT_RW16(d, 16)
#define CPT_RW48(d) CPT_RW32(d), CPT_RW16(d, 32)
#define CPT_RW64(d) CPT_RW48(d), CPT_RW16(d, 48)
#define CPT_RW96(d) CPT_RW64(d), CPT_RW16(d, 64), CPT_RW16(d, 80)
#define CPT_RW128(d) CPT_RW96(d), CPT_RW16(d, 96), CPT_RW16(d, 112)

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : CPT_RW32(d)
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<96>(int (&d)[48], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : CPT_RW48(d)
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : CPT_RW64(d)
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<192>(int (&d)[96], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : CPT_RW96(d)
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : CPT_RW128(d)
      : "l"(a), "l"(b), "r"(acc));
}

#undef CPT_RW4
#undef CPT_RW16
#undef CPT_RW32
#undef CPT_RW48
#undef CPT_RW64
#undef CPT_RW96
#undef CPT_RW128

// What the K-major gemm needs of its operand type: the accumulator, the
// columns a 128-byte stage holds, and the wgmma of one 32-byte K step.
template <typename In>
struct KMajor;
template <>
struct KMajor<__nv_bfloat16> {
  using Acc = float;
  static constexpr int kCols = 64;
  template <int BN>
  __device__ static void mma(float (&d)[BN / 2], uint64_t a, uint64_t b) {
    wgmma_bf16<BN>(d, a, b, 1);
  }
};
template <>
struct KMajor<int8_t> {
  using Acc = int;
  static constexpr int kCols = 128;
  template <int BN>
  __device__ static void mma(int (&d)[BN / 2], uint64_t a, uint64_t b) {
    wgmma_s8<BN>(d, a, b, 1);
  }
};

// Two accumulator values into the staged tile, and eight back out.
__device__ __forceinline__ void stage2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void stage2(int* p, int a, int b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}
__device__ __forceinline__ void unstage8(const float* p, float (&v)[8]) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}
__device__ __forceinline__ void unstage8(const int* p, int (&v)[8]) {
  const int4 lo = reinterpret_cast<const int4*>(p)[0];
  const int4 hi = reinterpret_cast<const int4*>(p)[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// ---- the kernel ----

// Row stride (floats) of the f32 tile the epilogue stages: 8 more than BN,
// so that the four rows a half-warp writes fall on distinct banks.
template <int BN>
__host__ __device__ constexpr int stage_stride() {
  return BN + 8;
}

template <int BN, int STAGES>
__host__ __device__ constexpr int smem_bytes() {
  // the ring (or the staged tile, if larger), its 2 * STAGES barriers, and
  // slack to align to 1024 bytes
  constexpr int ring = STAGES * (kBM + BN) * kBK * 2;
  constexpr int tile = kBM * stage_stride<BN>() * 4;
  return (ring > tile ? ring : tile) + 16 * STAGES + 1024;
}

// The K loop of a consumer warpgroup of gemm_kernel (MN: of gemm_mn_kernel,
// whose stages hold MN-major tiles; In: the K-major operand type): warpgroup
// wg = threadIdx.x / 128 adds rows [64 wg, 64 wg + 64) of the tile's
// product over ``steps`` stages of the ring into ``d`` (the layout of
// wgmma_bf16), releasing each stage once its wgmma are done. Kernels with
// producers and epilogues of their own run it too (ops/cuda/fused_head.cu).
template <int BN, int STAGES, bool MN = false, typename In = __nv_bfloat16,
          typename Acc = typename KMajor<In>::Acc>
__device__ __forceinline__ void mma_loop(unsigned char* sa, unsigned char* sb,
                                         uint64_t* full, uint64_t* empty,
                                         int steps, Acc (&d)[BN / 2]) {
  constexpr int kA = kBM * kBK * 2, kB = BN * kBK * 2;  // stage bytes
  const int wg = threadIdx.x / 128;
  for (int k = 0; k < steps; ++k) {
    const int s = k % STAGES;
    mbar_wait(full + s, (k / STAGES) & 1);
    if constexpr (MN) {
      // warpgroup wg's rows are the A stage's box wg; B's boxes of 64
      // columns lie kBK * 128 bytes apart
      const uint64_t da =
          desc_sw128_mn(sa + s * kA + wg * 64 * kBK * 2, kBK * 128);
      const uint64_t db = desc_sw128_mn(sb + s * kB, kBK * 128);
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)  // +16 rows, 2048 bytes a step
        wgmma_bf16_mn<BN>(d, da + 128 * kk, db + 128 * kk, 1);
    } else {
      const uint64_t da = desc_sw128(sa + s * kA + wg * 64 * kBK * 2);
      const uint64_t db = desc_sw128(sb + s * kB);
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // +32 bytes of K a step
        KMajor<In>::template mma<BN>(d, da + 2 * kk, db + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's wgmma are done: release it
    fence_regs(d);
    if (k > 0 && threadIdx.x % 32 == 0) mbar_arrive(empty + (k - 1) % STAGES);
  }
  wgmma_wait<0>();
  fence_regs(d);
}

// The consumer warpgroups of gemm_kernel and gemm_mn_kernel: the K loop,
// then the tile through ``epi``.
template <int BN, int STAGES, typename Epi, bool MN = false,
          typename In = __nv_bfloat16>
__device__ __forceinline__ void consume(unsigned char* sa, unsigned char* sb,
                                        uint64_t* full, uint64_t* empty,
                                        int m0, int n0, int M, int N,
                                        int steps, const Epi& epi) {
  using Acc = typename KMajor<In>::Acc;
  const int wg = threadIdx.x / 128;
  Acc d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = Acc(0);
  mma_loop<BN, STAGES, MN, In>(sa, sb, full, empty, steps, d);

  // epilogue: both warpgroups are done with the ring (every stage was
  // consumed, so the producer is done too); stage the tile there
  constexpr int S = stage_stride<BN>();
  Acc* tile = reinterpret_cast<Acc*>(sa);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  {
    const int t = threadIdx.x % 128;
    Acc* r0 = tile + (wg * 64 + (t / 32) * 16 + (t % 32) / 4) * S +
              2 * (t % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      stage2(r0 + 8 * j, d[4 * j], d[4 * j + 1]);
      stage2(r0 + 8 * S + 8 * j, d[4 * j + 2], d[4 * j + 3]);
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  for (int i = threadIdx.x; i < kBM * (BN / 8); i += kConsumers) {
    const int r = i / (BN / 8), c = 8 * (i % (BN / 8));
    if (m0 + r < M && n0 + c < N) {
      Acc v[8];
      unstage8(tile + r * S + c, v);
      epi(m0 + r, n0 + c, v);
    }
  }
}

template <int BN, int STAGES, int MINB, typename Epi, typename In>
__global__ void __launch_bounds__(kThreads, MINB)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, int M, int N,
                int K, const Epi epi) {
  constexpr int kCols = KMajor<In>::kCols;  // K columns a stage
  constexpr int kA = kBM * kBK * 2, kB = BN * kBK * 2;  // stage bytes
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sa = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sb = sa + STAGES * kA;
  constexpr int kRing = STAGES * (kA + kB);
  constexpr int kTile = kBM * stage_stride<BN>() * 4;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(sa + (kRing > kTile ? kRing : kTile));
  uint64_t* empty = full + STAGES;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int steps = (K + kCols - 1) / kCols;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // producer: one thread keeps the ring full
    if (threadIdx.x % 32 == 0) {
      for (int k = 0; k < steps; ++k) {
        const int s = k % STAGES;
        mbar_wait(empty + s, ((k / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, kA + kB);
        tma_load(sa + s * kA, &map_a, full + s, k * kCols, m0);
        tma_load(sb + s * kB, &map_b, full + s, k * kCols, n0);
      }
    }
    return;
  }
  consume<BN, STAGES, Epi, false, In>(sa, sb, full, empty, m0, n0, M, N,
                                      steps, epi);
}

// Launch D = A . B^T through ``epi`` on ``stream``: A [M, K], B [N, K] of
// ``In`` (bf16 or int8), 16-byte aligned, K a multiple of 16 bytes,
// N % 8 == 0.
template <int BN, int STAGES, int MINB, typename Epi,
          typename In = __nv_bfloat16>
cudaError_t gemm(const void* A, const void* B, int M, int N, int K,
                 const Epi& epi, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8) return cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  constexpr int elt = (int)sizeof(In);
  cudaError_t err = make_map(&map_a, A, M, K, kBM, elt);
  if (err != cudaSuccess) return err;
  err = make_map(&map_b, B, N, K, BN, elt);
  if (err != cudaSuccess) return err;
  auto kernel = gemm_kernel<BN, STAGES, MINB, Epi, In>;
  constexpr int smem = smem_bytes<BN, STAGES>();
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(map_a, map_b, M, N, K, epi);
  return cudaGetLastError();
}

// The raw f32 sums, [M, N] row-major at ``d`` (an epilogue for checks and
// for products whose elementwise work runs elsewhere). In an unnamed
// namespace, as every epilogue is, so that each source file's kernels
// built on it are its own.
namespace {
struct StoreF32 {
  float* d;
  int N;
  __device__ __forceinline__ void operator()(int r, int c,
                                             const float (&v)[8]) const {
    float4* p = reinterpret_cast<float4*>(d + (size_t)r * N + c);
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// The exact s32 sums of the s8 mode, [M, N] row-major at ``d``.
struct StoreS32 {
  int* d;
  int N;
  __device__ __forceinline__ void operator()(int r, int c,
                                             const int (&v)[8]) const {
    int4* p = reinterpret_cast<int4*>(d + (size_t)r * N + c);
    p[0] = make_int4(v[0], v[1], v[2], v[3]);
    p[1] = make_int4(v[4], v[5], v[6], v[7]);
  }
};
}  // namespace

// ---- MN-major operands: D = A^T . B, summed over the rows ----

// D[M, N] = A[K, M]^T . B[K, N], A and B row-major with M and N contiguous
// (MN-major): a weight gradient, summed over K = the activations' rows. Each
// stage holds the A tile as two TMA boxes of [kBK rows, 64 columns], one a
// warpgroup, and the B tile as BN / 64 such boxes, 128-byte swizzled; wgmma
// reads both transposed. Grid z splits the K steps: split z sums steps
// [z per, min((z + 1) per, steps)) and hands its tile to epi.split(z).
template <int BN, int STAGES, int MINB, typename Epi>
__global__ void __launch_bounds__(kThreads, MINB)
    gemm_mn_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, int M, int N,
                   int steps_total, int per, const Epi epi) {
  static_assert(BN % 64 == 0, "B stages are boxes of 64 columns");
  constexpr int kA = kBM * kBK * 2, kB = BN * kBK * 2;  // stage bytes
  constexpr int kBox = 64 * kBK * 2;                    // one box
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sa = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sb = sa + STAGES * kA;
  constexpr int kRing = STAGES * (kA + kB);
  constexpr int kTile = kBM * stage_stride<BN>() * 4;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(sa + (kRing > kTile ? kRing : kTile));
  uint64_t* empty = full + STAGES;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int k0 = blockIdx.z * per;
  const int left = steps_total - k0;
  const int steps = left < per ? (left > 0 ? left : 0) : per;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    if (threadIdx.x % 32 == 0) {
      for (int k = 0; k < steps; ++k) {
        const int s = k % STAGES;
        const int kr = (k0 + k) * kBK;  // the step's first row
        mbar_wait(empty + s, ((k / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, kA + kB);
        tma_load(sa + s * kA, &map_a, full + s, m0, kr);
        tma_load(sa + s * kA + kBox, &map_a, full + s, m0 + 64, kr);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load(sb + s * kB + j * kBox, &map_b, full + s, n0 + 64 * j,
                   kr);
      }
    }
    return;
  }
  consume<BN, STAGES, decltype(epi.split(0)), true>(
      sa, sb, full, empty, m0, n0, M, N, steps, epi.split(blockIdx.z));
}

// Launch D = A^T . B through epi.split(z) on ``stream``: A [K, M] and
// B [K, N] bf16 row-major, 16-byte aligned, M % 8 == 0, N % 8 == 0; the
// ceil(K / kBK) steps in ``splits`` parts of ``per`` steps (the last may
// be shorter, none empty).
template <int BN, int STAGES, int MINB, typename Epi>
cudaError_t gemm_mn(const void* A, const void* B, int M, int N, int K,
                    int splits, const Epi& epi, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 || M % 8 || N % 8)
    return cudaErrorInvalidValue;
  const int steps = (K + kBK - 1) / kBK;
  const int per = (steps + splits - 1) / splits;
  if ((splits - 1) * per >= steps) return cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + kBM - 1) / kBM, splits);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  cudaError_t err = make_map(&map_a, A, K, M, kBK);
  if (err != cudaSuccess) return err;
  err = make_map(&map_b, B, K, N, kBK);
  if (err != cudaSuccess) return err;
  auto kernel = gemm_mn_kernel<BN, STAGES, MINB, Epi>;
  constexpr int smem = smem_bytes<BN, STAGES>();
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(map_a, map_b, M, N, steps, per,
                                           epi);
  return cudaGetLastError();
}

// ---- two products of one tile ----

// D1 = A1 . B1^T and D2 = A2 . B2^T, both [M, N] with K-major operands of
// the same K, computed by one CTA a [kBM, BN] tile of both: each stage
// holds the four TMA tiles, each consumer thread two accumulators.
// ``epi(d1, d2, smem, m0, n0, M, N)`` is called by every consumer thread
// once the ring is free, with the thread's fragments of both (the layout of
// wgmma_bf16), and may use Epi::smem_bytes<BN>() bytes at ``smem``.
template <int BN, int STAGES, int MINB, typename Epi>
__global__ void __launch_bounds__(kThreads, MINB)
    dual_gemm_kernel(const __grid_constant__ CUtensorMap map_a1,
                     const __grid_constant__ CUtensorMap map_b1,
                     const __grid_constant__ CUtensorMap map_a2,
                     const __grid_constant__ CUtensorMap map_b2, int M,
                     int N, int K, const Epi epi) {
  constexpr int kA = kBM * kBK * 2, kB = BN * kBK * 2;
  constexpr int kStage = 2 * (kA + kB);  // A1, A2, B1, B2
  constexpr int kRing = STAGES * kStage;
  static_assert(Epi::template smem_bytes<BN>() <= kRing,
                "the epilogue's tiles must fit in the ring");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRing);
  uint64_t* empty = full + STAGES;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int steps = (K + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    if (threadIdx.x % 32 == 0) {
      for (int k = 0; k < steps; ++k) {
        const int s = k % STAGES;
        unsigned char* st = ring + s * kStage;
        mbar_wait(empty + s, ((k / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, kStage);
        tma_load(st, &map_a1, full + s, k * kBK, m0);
        tma_load(st + kA, &map_a2, full + s, k * kBK, m0);
        tma_load(st + 2 * kA, &map_b1, full + s, k * kBK, n0);
        tma_load(st + 2 * kA + kB, &map_b2, full + s, k * kBK, n0);
      }
    }
    return;
  }
  const int wg = warp / 4;
  float d1[BN / 2], d2[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d1[i] = d2[i] = 0.0f;
  for (int k = 0; k < steps; ++k) {
    const int s = k % STAGES;
    const unsigned char* st = ring + s * kStage;
    mbar_wait(full + s, (k / STAGES) & 1);
    const uint64_t da1 = desc_sw128(st + wg * 64 * kBK * 2);
    const uint64_t da2 = desc_sw128(st + kA + wg * 64 * kBK * 2);
    const uint64_t db1 = desc_sw128(st + 2 * kA);
    const uint64_t db2 = desc_sw128(st + 2 * kA + kB);
    fence_regs(d1);
    fence_regs(d2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma_bf16<BN>(d1, da1 + 2 * kk, db1 + 2 * kk, 1);
      wgmma_bf16<BN>(d2, da2 + 2 * kk, db2 + 2 * kk, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(d1);
    fence_regs(d2);
    if (k > 0 && threadIdx.x % 32 == 0) mbar_arrive(empty + (k - 1) % STAGES);
  }
  wgmma_wait<0>();
  fence_regs(d1);
  fence_regs(d2);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  epi(d1, d2, ring, m0, n0, M, N);
}

// Launch the two products through ``epi`` on ``stream``: A1, A2 [M, K],
// B1, B2 [N, K] bf16, 16-byte aligned, K % 8 == 0, N % BN == 0.
template <int BN, int STAGES, int MINB, typename Epi>
cudaError_t dual_gemm(const void* A1, const void* B1, const void* A2,
                      const void* B2, int M, int N, int K, const Epi& epi,
                      cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % BN) return cudaErrorInvalidValue;
  const dim3 grid(N / BN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  CUtensorMap ma1, mb1, ma2, mb2;
  cudaError_t err = make_map(&ma1, A1, M, K, kBM);
  if (err == cudaSuccess) err = make_map(&ma2, A2, M, K, kBM);
  if (err == cudaSuccess) err = make_map(&mb1, B1, N, K, BN);
  if (err == cudaSuccess) err = make_map(&mb2, B2, N, K, BN);
  if (err != cudaSuccess) return err;
  auto kernel = dual_gemm_kernel<BN, STAGES, MINB, Epi>;
  constexpr int smem = STAGES * 4 * (kBM + BN) * kBK + 16 * STAGES + 1024;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(ma1, mb1, ma2, mb2, M, N, K, epi);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace cpt
