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
// What bounds it on Hopper: the logits' 2 B HW C P operations, on the
// tensor cores (ops/cuda/sm90.cuh's TMA-fed wgmma core) in bf16. The head
// is held to 1e-4 + 1e-4 |count| against f32 logits, which one bf16 product
// misses, so the operands are split (the weight once, when it is prepared:
// w = w_hi + w_lo, both bf16; f32 features x = x_hi + x_lo by a split
// pass) and the logits are one K-major GEMM over the products that matter:
// bf16 features x [w_hi | w_lo] (K = 2C), f32 features x_hi w_hi + x_lo
// w_hi + x_hi w_lo (K = 3C; the dropped x_lo w_lo is about 2^-16 of a
// product). The producer picks the A tensor map and the B column by the K
// step, so no concatenated copy of the features is written.
//
// A softmax row spans all P columns, more than a CTA holds beside its
// ring, so the logits go through device memory once (stored by the GEMM,
// read by a row kernel: 2 x 532 MB at 256 images, less time than a second
// pass of the GEMM, which a design that keeps them on chip needs; PERF.md,
// section 6):
//   1. the GEMM's epilogue, on the accumulators in registers: the logits
//      (sums + bias) stored [M, P] f32, and each row's max and sum of
//      exp(l - max) over the CTA's column tile ([M, P / BN] f32 pairs);
//   2. a row kernel, one 64-row subtile of one image a CTA: each row's tile
//      pairs combined in tile order into its max and sum, exp(l - max) /
//      sum (IEEE expf and division), and the rows added per column in order
//      into a partial row of counts ([B, ceil(HW / 64), P]);
//   3. each image's partial rows added in order.
// No float atomics: a call repeats bit for bit.
//
// P is padded to a multiple of 8 when the weight is prepared (zero rows, a
// bias of -inf: their exp is 0); columns past the padded P read a bias of
// -inf too. The identity weight (num_features = 0) runs the product, as in
// the JAX package.
#include "common.cuh"
#include "sm90.cuh"

namespace cpt {
namespace {

constexpr int kSub = 64;  // rows a partial row of counts sums: one image's

// ---- the feature split: x_hi = bf16(x), x_lo = bf16(x - x_hi) ----

__global__ void __launch_bounds__(256)
    head_split_kernel(const float* __restrict__ x, __nv_bfloat16* hi,
                      __nv_bfloat16* lo, size_t n8) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n8;
       i += (size_t)gridDim.x * blockDim.x) {
    float v[8], h[8], l[8];
    load8(x + 8 * i, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      h[e] = __bfloat162float(__float2bfloat16_rn(v[e]));
      l[e] = __fsub_rn(v[e], h[e]);  // exact
    }
    store8(hi + 8 * i, h);
    store8(lo + 8 * i, l);
  }
}

// ---- 1. the GEMM: logits and their row statistics ----

struct HeadArgs {
  const float* bias;  // [Pp], -inf past P
  float2* stats;      // [M, nt]: (max, sum of exp(l - max)) of a row's tile
  float* logits;      // [M, Pp]
  int M, C, nk, parts, Pp;
};

// A row's max and sum of exp(l - max) from its ``nt`` tile pairs, in tile
// order.
__device__ __forceinline__ float2 combine_stats(const float2* st, int nt) {
  float mx = -INFINITY;
  for (int t = 0; t < nt; ++t) mx = fmaxf(mx, st[t].x);
  float sum = 0.0f;
  for (int t = 0; t < nt; ++t) {
    const float2 v = st[t];
    sum = __fadd_rn(sum, __fmul_rn(v.y, expf(v.x - mx)));
  }
  return make_float2(mx, sum);
}

template <int BN, int STAGES>
constexpr int head_smem() {
  // the ring, its barriers, and slack to align to 1024 bytes
  return STAGES * (sm90::kBM + BN) * sm90::kBK * 2 + 16 * STAGES + 1024;
}

// The epilogue of warpgroup wg on its 64 rows x BN columns: d[4 j + e] of
// row m0 + 64 wg + 16 warp + lane / 4 + 8 (e / 2), column n0 + 8 j +
// 2 (lane % 4) + e % 2 (wgmma's layout), so a quad of lanes holds a row's
// BN columns.
template <int BN>
__device__ __forceinline__ void head_epilogue(float (&d)[BN / 2],
                                              const HeadArgs& a) {
  const int lane = threadIdx.x % 32;
  const int r0 = blockIdx.y * sm90::kBM + threadIdx.x / 32 * 16 + lane / 4;
  const int n0 = blockIdx.x * BN, tile = blockIdx.x, nt = gridDim.x;
  const int c0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = c0 + 8 * j;
    const float2 b = c < a.Pp
                         ? __ldg(reinterpret_cast<const float2*>(a.bias + c))
                         : make_float2(-INFINITY, -INFINITY);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      d[4 * j + 2 * h] = __fadd_rn(d[4 * j + 2 * h], b.x);
      d[4 * j + 2 * h + 1] = __fadd_rn(d[4 * j + 2 * h + 1], b.y);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      m = fmaxf(m, fmaxf(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s = __fadd_rn(s, expf(d[4 * j + 2 * h] - m));
      s = __fadd_rn(s, expf(d[4 * j + 2 * h + 1] - m));
    }
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
    const int row = r0 + 8 * h;
    if (row < a.M) {
      if (lane % 4 == 0) a.stats[(size_t)row * nt + tile] = make_float2(m, s);
      float* out = a.logits + (size_t)row * a.Pp;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        if (c0 + 8 * j < a.Pp)
          *reinterpret_cast<float2*>(out + c0 + 8 * j) =
              make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  }
}

// One [128, BN] tile of the logits: rows blockIdx.y 128 .. + 128, columns
// blockIdx.x BN .. + BN. K steps of kBK columns: part p = k / nk of the
// product (A map: x_lo for part 1, else x_hi; B: the w_lo half for the last
// part, else the w_hi half), column kBK (k % nk) of it.
template <int BN, int STAGES, int MINB>
__global__ void __launch_bounds__(sm90::kThreads, MINB)
    head_gemm_kernel(const __grid_constant__ CUtensorMap map_xhi,
                     const __grid_constant__ CUtensorMap map_xlo,
                     const __grid_constant__ CUtensorMap map_w,
                     const HeadArgs a) {
  using namespace sm90;
  constexpr int kA = kBM * kBK * 2, kB = BN * kBK * 2;  // stage bytes
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sa = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sb = sa + STAGES * kA;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * kB);
  uint64_t* empty = full + STAGES;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int steps = a.parts * a.nk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 32 == kConsumers / 32) {
    if (threadIdx.x % 32 == 0) {
      for (int k = 0, p = 0, kk = 0; k < steps; ++k) {
        const int s = k % STAGES;
        const CUtensorMap* ma = p == 1 ? &map_xlo : &map_xhi;
        const int bcol = (p == a.parts - 1 ? a.C : 0) + kk * kBK;
        mbar_wait(empty + s, ((k / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, kA + kB);
        tma_load(sa + s * kA, ma, full + s, kk * kBK, m0);
        tma_load(sb + s * kB, &map_w, full + s, bcol, n0);
        if (++kk == a.nk) {
          kk = 0;
          ++p;
        }
      }
    }
    return;
  }
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.0f;
  mma_loop<BN, STAGES>(sa, sb, full, empty, steps, d);
  head_epilogue<BN>(d, a);
}

// ---- 2. the normalized column sums of a subtile's rows ----

// One subtile a CTA: its rows' max and sum from their tile pairs, then four
// columns a thread, its rows added in order.
__global__ void __launch_bounds__(256)
    head_rows_kernel(const float* __restrict__ logits,
                     const float2* __restrict__ stats, float* part, int HW,
                     int n64, int Pp, int nt) {
  __shared__ float2 ms[kSub];
  const int g = blockIdx.x, s = g % n64;
  const int rows = min(kSub, HW - kSub * s);
  const size_t row0 = (size_t)(g / n64) * HW + kSub * s;
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    ms[r] = combine_stats(stats + (row0 + r) * nt, nt);
  __syncthreads();
  for (int c = 4 * threadIdx.x; c < Pp; c += 4 * blockDim.x) {
    const float* lp = logits + row0 * Pp + c;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const float4 l =
          __ldg(reinterpret_cast<const float4*>(lp + (size_t)r * Pp));
      const float2 m = ms[r];
      acc[0] = __fadd_rn(acc[0], __fdiv_rn(expf(l.x - m.x), m.y));
      acc[1] = __fadd_rn(acc[1], __fdiv_rn(expf(l.y - m.x), m.y));
      acc[2] = __fadd_rn(acc[2], __fdiv_rn(expf(l.z - m.x), m.y));
      acc[3] = __fadd_rn(acc[3], __fdiv_rn(expf(l.w - m.x), m.y));
    }
    *reinterpret_cast<float4*>(part + (size_t)g * Pp + c) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// ---- 3. counts[b, p] = the image's partial rows part[b, t, p] added in
// order ----
__global__ void head_sum_kernel(const float* part, int tiles, int B, int P,
                                float* counts) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * P) return;
  const int b = idx / P, p = idx - b * P;
  const float* pb = part + (size_t)b * tiles * P + p;
  float s = 0.0f;
  for (int t = 0; t < tiles; ++t) s = __fadd_rn(s, pb[(size_t)t * P]);
  counts[idx] = s;
}

// ---- host ----

struct HeadShape {
  int B, HW, C, Pp;
  int M() const { return B * HW; }
  int n64() const { return (HW + kSub - 1) / kSub; }
  bool valid() const {
    return B > 0 && HW > 0 && C > 0 && C % 32 == 0 && Pp > 0 &&
           Pp % 8 == 0 && (long long)B * HW < (1ll << 31) &&
           (M() + sm90::kBM - 1) / sm90::kBM <= 65535;
  }
};

template <int BN, int STAGES, int MINB>
cudaError_t head_gemm_as(const CUtensorMap& mhi, const CUtensorMap& mlo,
                         const void* w, const HeadArgs& a, cudaStream_t st) {
  CUtensorMap mw;
  cudaError_t err = sm90::make_map(&mw, w, a.Pp, 2 * a.C, BN);
  if (err != cudaSuccess) return err;
  auto kernel = head_gemm_kernel<BN, STAGES, MINB>;
  constexpr int smem = head_smem<BN, STAGES>();
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Pp + BN - 1) / BN, (a.M + sm90::kBM - 1) / sm90::kBM);
  kernel<<<grid, sm90::kThreads, smem, st>>>(mhi, mlo, mw, a);
  return cudaGetLastError();
}

// The GEMM's tiles <BN, STAGES, CTAs an SM> by ``tile``: 1-4 the
// candidates (scripts/k9_tiles.py), 0 the one K9 takes: <256, 4, 1>, 1-6 %
// faster than the others at 32 and 256 images, bf16 and f32 features (it
// spills 8 bytes). Their BN, also in ops/fused_head.py:TILE_BN:
constexpr int kTiles = 4;
constexpr int kTileBN[kTiles + 1] = {256, 128, 128, 256, 64};

// The GEMM on bf16 features ``xhi`` (``xlo`` null) or the split of f32
// ones: logits [M, Pp] and stats [M, ceil(Pp / BN)].
cudaError_t head_gemm(const void* xhi, const void* xlo, const void* w,
                      const float* bias, float2* stats, float* logits,
                      const HeadShape& sh, int tile, cudaStream_t st) {
  if (!sh.valid() || tile < 0 || tile > kTiles) return cudaErrorInvalidValue;
  CUtensorMap mhi, mlo;
  cudaError_t err = sm90::make_map(&mhi, xhi, sh.M(), sh.C, sm90::kBM);
  if (err == cudaSuccess)
    err = sm90::make_map(&mlo, xlo ? xlo : xhi, sh.M(), sh.C, sm90::kBM);
  if (err != cudaSuccess) return err;
  const HeadArgs a{bias, stats, logits, sh.M(), sh.C,
                   (sh.C + sm90::kBK - 1) / sm90::kBK, xlo ? 3 : 2, sh.Pp};
  switch (tile) {
    case 1: return head_gemm_as<128, 3, 2>(mhi, mlo, w, a, st);
    case 2: return head_gemm_as<128, 4, 1>(mhi, mlo, w, a, st);
    case 0:
    case 3: return head_gemm_as<256, 4, 1>(mhi, mlo, w, a, st);
    case 4: return head_gemm_as<64, 4, 2>(mhi, mlo, w, a, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t head_split(const float* x, __nv_bfloat16* hi, __nv_bfloat16* lo,
                       size_t n, cudaStream_t st) {
  const size_t n8 = n / 8;
  const size_t want = (n8 + 255) / 256;
  const unsigned blocks = (unsigned)(want < 8192 ? want : 8192);
  head_split_kernel<<<blocks, 256, 0, st>>>(x, hi, lo, n8);
  return cudaGetLastError();
}

cudaError_t head_rows(const float* logits, const float2* stats, float* part,
                      const HeadShape& sh, int nt, cudaStream_t st) {
  if (!sh.valid() || nt <= 0) return cudaErrorInvalidValue;
  head_rows_kernel<<<sh.B * sh.n64(), 256, 0, st>>>(logits, stats, part,
                                                    sh.HW, sh.n64(), sh.Pp,
                                                    nt);
  return cudaGetLastError();
}

cudaError_t head_sum(const float* part, float* counts, const HeadShape& sh,
                     cudaStream_t st) {
  const int n = sh.B * sh.Pp;
  head_sum_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, sh.n64(), sh.B,
                                                   sh.Pp, counts);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cpt

// K9: x [B, HW, C] (bf16 if x_bf16, else f32), w [Pp, 2C] bf16 ([w_hi |
// w_lo], P padded to Pp % 8 == 0 with zero rows), bias [Pp] f32 (-inf past
// P), counts [B, Pp] f32. Scratch: xhi, xlo [B HW, C] bf16 (f32 x only),
// stats [B HW, nt] f32 pairs (nt = ceil(Pp / BN) of tile 0), logits
// [B HW, Pp] f32, part [B, ceil(HW / 64), Pp] f32. C % 32 == 0.
extern "C" int cpt_fused_count_head(const void* x, int x_bf16, const void* w,
                                    const float* bias, __nv_bfloat16* xhi,
                                    __nv_bfloat16* xlo, float2* stats,
                                    float* logits, float* part, float* counts,
                                    int B, int HW, int C, int Pp,
                                    void* stream) {
  const cpt::HeadShape sh{B, HW, C, Pp};
  if (!sh.valid()) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  const void* a = x;
  const void* alo = nullptr;
  if (!x_bf16) {
    err = cpt::head_split(static_cast<const float*>(x), xhi, xlo,
                          (size_t)B * HW * C, st);
    a = xhi;
    alo = xlo;
  }
  const int bn = cpt::kTileBN[0];
  if (err == cudaSuccess)
    err = cpt::head_gemm(a, alo, w, bias, stats, logits, sh, 0, st);
  if (err == cudaSuccess)
    err = cpt::head_rows(logits, stats, part, sh, (Pp + bn - 1) / bn, st);
  if (err == cudaSuccess) err = cpt::head_sum(part, counts, sh, st);
  return (int)err;
}

// K9's launches on their own, to hold and time each: the feature split (n
// values, n % 8 == 0), the GEMM (xlo null for bf16 features; M = B HW
// rows) and the row kernel.
extern "C" int cpt_head_split(const float* x, __nv_bfloat16* hi,
                              __nv_bfloat16* lo, long long n, void* stream) {
  if (n <= 0 || n % 8) return (int)cudaErrorInvalidValue;
  return (int)cpt::head_split(x, hi, lo, (size_t)n,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int cpt_head_gemm(const void* xhi, const void* xlo, const void* w,
                             const float* bias, float2* stats, float* logits,
                             int M, int C, int Pp, int tile, void* stream) {
  return (int)cpt::head_gemm(xhi, xlo, w, bias, stats, logits,
                             cpt::HeadShape{1, M, C, Pp}, tile,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int cpt_head_rows(const float* logits, const float2* stats,
                             float* part, int B, int HW, int Pp, int nt,
                             void* stream) {
  return (int)cpt::head_rows(logits, stats, part,
                             cpt::HeadShape{B, HW, 32, Pp}, nt,
                             static_cast<cudaStream_t>(stream));
}
