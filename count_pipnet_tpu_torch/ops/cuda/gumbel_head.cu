// Kernel B: the gumbel-hard counting head, and kernel C: the last ConvNeXt
// block fused with that head.
//
// B replaces count_pipnet_tpu/ops/pallas/gumbel_head.py:gumbel_hard_counts
// (:88). Per patch row: f32 logits + Gumbel(0, 1) noise, argmax over the P
// channels by jnp.argmax's rule (the first NaN, else the first maximum),
// one count for the winner. Its bound is instruction dispatch, not bytes:
// the noise contract below costs each logit a quarter of a Philox4x32-10
// block (ten rounds of two 32x32->64 multiplies and two three-way XORs), a
// u32->f32 convert and two accurate logs of a positive normal, 17
// instructions each (common.cuh: log_normal, logf bit for bit without the
// tests for inputs the draw never makes): 50 instructions as the SASS
// spells them, against 2 or 4 bytes read (PERF.md, K4's bound;
// chip_smoke.py: K4_INSTRUCTIONS). So the design is about lanes,
// independent work a thread and dispatch slots; no tensor core and no TMA
// has anything to do here (the read is one coalesced pass, 8 or 16 bytes
// a quad):
// - a row's P / 4 channel quads go to a group of G lanes, the fewest
//   (a power of two up to 32) that hold them one each: a warp takes 8 rows
//   at P = 16, 2 at P = 64, and one row at P >= 128, with P / 128 quads a
//   lane at P = 256 and 768 (head_lg);
// - a thread holds S rows at once, so it runs S Philox chains
//   interleaved; it starts their logits loads (and the injected noise's)
//   before the chains, so the read flies under the arithmetic
//   (quad_argmax). The rule head_plan takes four rows a thread at three
//   CTAs an SM on large planes (kWide), else one quad a thread (kSingle);
// - a thread keeps a running argmax (first_max) over its channels, which
//   ascend; the lane group reduces the rows' argmax keys (common.cuh:
//   argmax_key) with __reduce_max_sync on the high word, then the low
//   word, so B and C pick winners by one rule, and a key only ever names
//   a channel of the row;
// - a CTA takes 8 S 32 / G rows of one image, and the grid is as many
//   CTAs as the rows need; the histogram is a u32 array in shared memory,
//   flushed with one global atomicAdd a nonzero bin (exact integers in
//   f32).
//
// C replaces gumbel_head.py:fused_block_gumbel_counts (:268), in its bf16
// and int8-static modes (f32 taps, as on the TPU). The TPU kernel keeps a
// whole image in VMEM, so the last [B, H*W, C] block output is never
// written. On Hopper it is bound by the block's two GEMMs (16 R C^2
// operations on R = B H W rows), and a row's argmax spans all C columns,
// more than one wgmma tile holds (block.cuh, fused_block.cu). So C is
// kernel A's launches with a head in place of GEMM 2's store, four
// launches on the stream:
//   a. kernel A's prologue (fused_block.cu: cpt_block_prologue), which also
//      zeroes each row's argmax key slot keys [R] (u64);
//   b. kernel A's GEMM 1 (cpt_block_up);
//   c. GEMM 2 on the TMA-fed wgmma core (block.cuh: gemm_tiled) with the
//      head epilogue HeadKeys: for its row and eight columns the block
//      output (block_out, kernel A's GEMM 2 arithmetic) plus the noise, the
//      winner of the eight as an argmax key (common.cuh: argmax_key), the
//      threads that hold the row reduce first, and one atomicMax on the
//      row's key slot. The largest key is the row's argmax whatever order
//      the tiles finish in, so the result is deterministic and needs no
//      stored plane and no second pass;
//   d. count_keys_kernel: one CTA an image turns its rows' keys into
//      counts [B, C] through a histogram in shared memory.
// n, the hidden activation and the keys are scratch from the caller. The
// argmax sees the f32 block output that kernel A's GEMM 2 computes before
// its store, so kernel C equals A -> B on f32 planes.
//
// Noise: Philox4x32-10 keyed by the seed, counter (channel / 4, patch,
// image), unless a [B, H*W, P] f32 noise tensor is passed (parity checks).
// Both kernels draw the same noise for the same (image, patch, channel).
#include "block.cuh"

// Kernel A's prologue and GEMM 1 (fused_block.cu)
extern "C" int cpt_block_prologue(const void* x, void* n, float* nsc,
                                  int* amax, unsigned long long* keys,
                                  int dw_bf16, int x_bf16, int mode, int B,
                                  int H, int W, int C, const float* dwk,
                                  const float* dwb, const float* lns,
                                  const float* lnb, const float* i1,
                                  float eps, int tr, int cs, void* stream);
extern "C" int cpt_block_up(const void* n, const void* w1, const float* s1,
                            const float* b1, const float* i2, void* h,
                            const float* nsc, int* amax, float* asc,
                            int mode, int passes, int R, int C, int tile,
                            void* stream);

namespace cpt {
namespace {

// Kernel B's two plans, the rule's only choices: kWide holds four rows a
// thread at three CTAs an SM, kSingle one quad of one row a thread at four
// (the CTAs an SM the registers are cut for by __launch_bounds__; neither
// spills). A row takes G = 1 << lg lanes (head_lg), a warp 32 / G rows a
// slot, a CTA 8 S 32 / G rows for S rows a thread.
constexpr int kWide = 1, kSingle = 2;

inline int head_lg(int C) {
  int lg = 0;
  while (lg < 5 && (1 << lg) < C / 4) ++lg;
  return lg;
}

// The rule, from the device times of six candidate plans at P = 16, 64,
// 256, 768 and 32 and 256 images of 26x26 (PERF.md, K4; H100): four rows
// a thread where a row has 16 quads or more and the grid still has 8 CTAs
// an SM (0.91-0.97 of the single plan's time at 256 images, P >= 64);
// else one quad of one row a thread, the most threads (within 5 % of the
// fastest candidate, or faster, elsewhere).
inline int head_plan(int B, int HW, int C, int sms) {
  const int rows = kThreads / 32 * 4 << (5 - head_lg(C));
  return C / 4 >= 16 && (long)((HW + rows - 1) / rows) * B >= 8L * sms
             ? kWide
             : kSingle;
}

template <typename T, int S, bool NOISE>
__device__ __forceinline__ void quad_argmax(const T* __restrict__ logits,
                                            const float* __restrict__ noise,
                                            int img, int HW, int C, int lg,
                                            uint2 key, const int (&patch)[S],
                                            int sub, float (&best)[S],
                                            int (&best_c)[S]) {
  const int G = 1 << lg, nq = C >> 2;
  const T* row[S];
  const float* nrow[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const size_t off = ((size_t)img * HW + patch[s]) * C;
    row[s] = logits + off;
    nrow[s] = NOISE ? noise + off : nullptr;
  }
  for (int q = sub; q < nq; q += G) {
    float v[S][4], g[S][4];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      load4(row[s] + 4 * q, v[s]);
      if constexpr (NOISE) load4(nrow[s] + 4 * q, g[s]);
    }
    if constexpr (!NOISE) {
#pragma unroll
      for (int s = 0; s < S; ++s)
        gumbel_quad((uint32_t)q, (uint32_t)patch[s], (uint32_t)img, key,
                    g[s]);
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        first_max(best[s], best_c[s], __fadd_rn(v[s][k], g[s][k]),
                  4 * q + k);
  }
}

template <typename T, int S, int M>
__global__ void __launch_bounds__(kThreads, M)
    gumbel_hist_kernel(const T* __restrict__ logits,
                       const float* __restrict__ noise, float* counts,
                       int HW, int C, int lg, uint2 key) {
  extern __shared__ unsigned int hist[];  // [C]
  const int G = 1 << lg, nq = C >> 2;
  const int img = blockIdx.y, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, sub = lane & (G - 1);
  const int p0 = blockIdx.x * (kThreads / 32 * S << (5 - lg))
                 + (warp * S << (5 - lg));
  for (int c = threadIdx.x; c < C; c += kThreads) hist[c] = 0u;
  __syncthreads();
  if (p0 < HW) {  // the warp has rows
    int patch[S];
    float best[S];
    int best_c[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // a row past the plane runs as the last row and counts nowhere
      patch[s] = min(p0 + (s << (5 - lg)) + (lane >> lg), HW - 1);
      best[s] = -INFINITY;  // a row of -inf keeps the lane's first channel
      best_c[s] = 4 * sub;
    }
    if (noise != nullptr)
      quad_argmax<T, S, true>(logits, noise, img, HW, C, lg, key, patch, sub,
                              best, best_c);
    else
      quad_argmax<T, S, false>(logits, noise, img, HW, C, lg, key, patch,
                               sub, best, best_c);
    const unsigned group =
        G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u) << (lane & ~(G - 1));
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // lanes past the row's quads (P / 4 not a power of two) hold key 0,
      // below every value's
      const unsigned long long k =
          sub < nq ? argmax_key(best[s], best_c[s]) : 0ull;
      const unsigned hi = __reduce_max_sync(group, (unsigned)(k >> 32));
      const unsigned lo = __reduce_max_sync(
          group, (unsigned)(k >> 32) == hi ? (unsigned)k : 0u);
      const uint32_t c = 0xFFFFFFFFu - lo;
      if (sub == 0 && p0 + (s << (5 - lg)) + (lane >> lg) < HW &&
          c < (uint32_t)C)
        atomicAdd(hist + c, 1u);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const unsigned int h = hist[c];
    if (h != 0u) atomicAdd(counts + (size_t)img * C + c, (float)h);
  }
}

template <typename T, int S, int M>
cudaError_t launch_hist(const void* logits, const float* noise,
                        float* counts, int B, int HW, int C, uint2 key,
                        cudaStream_t st) {
  const int lg = head_lg(C);
  const int rows = kThreads / 32 * S << (5 - lg);
  const dim3 grid((HW + rows - 1) / rows, B);
  gumbel_hist_kernel<T, S, M><<<grid, kThreads, (size_t)C * 4, st>>>(
      static_cast<const T*>(logits), noise, counts, HW, C, lg, key);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_head(int plan, const void* logits, const float* noise,
                        float* counts, int B, int HW, int C, uint2 key,
                        cudaStream_t st) {
  return plan == kWide
             ? launch_hist<T, 4, 3>(logits, noise, counts, B, HW, C, key, st)
             : launch_hist<T, 1, 4>(logits, noise, counts, B, HW, C, key, st);
}

// The block output of GEMM 2's sums v of row r, columns c..c+7, by
// block_out, kernel A's GEMM 2 arithmetic: x + (v * s2 + b2) * g, with
// s2 = 1 on the f32 sums of bf16 operands.
template <typename T>
struct BlockOut8 {
  const float* s2;
  const float* b2;
  const float* g;
  const T* x;
  int N;
  template <typename A>
  __device__ __forceinline__ void operator()(int r, int c, const A (&v)[8],
                                             float (&y)[8]) const {
    float s[8], b[8], gm[8];
    if constexpr (std::is_same_v<A, int>) {
      load8(s2 + c, s);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = 1.0f;
    }
    load8(b2 + c, b);
    load8(g + c, gm);
    load8(x + (size_t)r * N + c, y);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      y[i] = block_out(y[i], (float)v[i], s[i], b[i], gm[i]);
  }
};

// c. GEMM 2's head epilogue: the block output of row r, columns c..c+7,
// plus the row's Gumbel noise (two channel quads), and their winner's key
// atomicMax'ed into keys[r]. The threads of a warp that hold the same row
// (a whole warp at BN = 256, 16 lanes at 128) reduce first, high word then
// low word, so a row takes one atomic per warp and tile; rows past M skip
// the functor, so the reduction spans the active lanes.
template <typename T>
struct HeadKeys {
  BlockOut8<T> out;
  const float* noise;  // [R, N] or null: Philox from ``key``
  unsigned long long* keys;
  int HW;
  uint2 key;
  template <typename A>
  __device__ __forceinline__ void operator()(int r, int c,
                                             const A (&v)[8]) const {
    float y[8], nz[8];
    out(r, c, v, y);
    if (noise != nullptr) {
      load8(noise + (size_t)r * out.N + c, nz);
    } else {
      const int img = r / HW, patch = r - img * HW;
      gumbel_quad((uint32_t)c / 4, patch, img, key, nz);
      gumbel_quad((uint32_t)c / 4 + 1, patch, img, key, nz + 4);
    }
    unsigned long long best = 0ull;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned long long k = argmax_key(__fadd_rn(y[i], nz[i]), c + i);
      best = k > best ? k : best;
    }
    const unsigned same = __match_any_sync(__activemask(), r);
    const unsigned hi = __reduce_max_sync(same, (unsigned)(best >> 32));
    const unsigned lo = __reduce_max_sync(
        same, (unsigned)(best >> 32) == hi ? (unsigned)best : 0u);
    if (hi != 0u && (int)(threadIdx.x & 31) == __ffs(same) - 1)
      atomicMax(keys + r, ((unsigned long long)hi << 32) | lo);
  }
};

// GEMM 2 with the f32 block output stored: the plane kernel C takes its
// argmax of, for the checks.
template <typename T>
struct StoreBlockOut {
  BlockOut8<T> out;
  float* plane;
  template <typename A>
  __device__ __forceinline__ void operator()(int r, int c,
                                             const A (&v)[8]) const {
    float y[8];
    out(r, c, v, y);
    store8(plane + (size_t)r * out.N + c, y);
  }
};

// GEMM 2 of kernel C's modes (kQBf16, kQStatic): hidden [R, 4C] . W2^T
// through ``epi`` on the tile ``tile`` (gemm_tiled; 0: head_tile). The
// head's candidates at 26x26x768 (scripts/block_tiles.py, H100): in the s8
// mode <128, 3, 2> ties <256, 4, 1> at 32 images and beats it by 8 % at
// 256 (two CTAs an SM: one's epilogue, with its Gumbel draws, runs under
// the other's product); in bf16 <256, 4, 1> wins at 32 images by 10 % and
// loses at 256 by 2 %, so it stays kernel A's.
inline int head_tile(int mode, int C) {
  return mode == kQStatic && C % 128 == 0 ? 1 : default_tile(false, C);
}

template <typename Epi>
cudaError_t down(const void* h, const void* w2, int mode, int R, int C,
                 int tile, const Epi& epi, cudaStream_t st) {
  if (tile == 0) tile = head_tile(mode, C);
  if (mode == kQStatic)
    return gemm_tiled<int8_t>(false, tile, h, w2, R, C, 4 * C, epi, st);
  if (mode == kQBf16)
    return gemm_tiled<__nv_bfloat16>(false, tile, h, w2, R, C, 4 * C, epi,
                                     st);
  return cudaErrorInvalidValue;
}

cudaError_t head(const void* h, const void* w2, const float* s2,
                 const float* b2, const float* g, const void* x, int x_bf16,
                 const float* noise, unsigned long long* keys, int mode,
                 int R, int HW, int C, unsigned long long seed, int tile,
                 cudaStream_t st) {
  if (R <= 0 || HW <= 0 || R % HW || C % 8 || tile < 0 || tile > kTiles)
    return cudaErrorInvalidValue;
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  using BF = __nv_bfloat16;
  if (x_bf16)
    return down(h, w2, mode, R, C, tile,
                HeadKeys<BF>{{s2, b2, g, static_cast<const BF*>(x), C}, noise,
                             keys, HW, key},
                st);
  return down(h, w2, mode, R, C, tile,
              HeadKeys<float>{{s2, b2, g, static_cast<const float*>(x), C},
                              noise, keys, HW, key},
              st);
}

// d. counts [img, c] = the number of rows of image img whose key names
// channel c. Every row's key is nonzero after the head GEMM (argmax_key);
// a slot still 0, or a channel past C, counts nowhere.
__global__ void __launch_bounds__(kThreads)
    count_keys_kernel(const unsigned long long* keys, float* counts, int HW,
                      int C) {
  extern __shared__ unsigned int key_hist[];  // [C]
  const int img = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += kThreads) key_hist[c] = 0u;
  __syncthreads();
  const unsigned long long* k = keys + (size_t)img * HW;
  for (int p = threadIdx.x; p < HW; p += kThreads) {
    const unsigned long long key = k[p];
    const uint32_t c = 0xFFFFFFFFu - (uint32_t)key;
    if (key != 0ull && c < (uint32_t)C) atomicAdd(key_hist + c, 1u);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads)
    counts[(size_t)img * C + c] = (float)key_hist[c];
}

cudaError_t count_keys(const unsigned long long* keys, float* counts, int B,
                       int HW, int C, cudaStream_t st) {
  if (B <= 0 || HW <= 0 || C <= 0) return cudaErrorInvalidValue;
  count_keys_kernel<<<B, kThreads, (size_t)C * sizeof(unsigned int), st>>>(
      keys, counts, HW, C);
  return cudaGetLastError();
}

// Counts into ``mismatches`` the positive normal floats on which
// log_normal and logf differ in any bit.
__global__ void log_check_kernel(unsigned long long* mismatches) {
  unsigned n = 0;
  for (uint32_t b = 0x00800000u + blockIdx.x * blockDim.x + threadIdx.x;
       b < 0x7f800000u; b += gridDim.x * blockDim.x) {
    const float a = __uint_as_float(b);
    n += __float_as_uint(log_normal(a)) != __float_as_uint(logf(a));
  }
  n = __reduce_add_sync(0xFFFFFFFFu, n);
  if ((threadIdx.x & 31) == 0 && n != 0u)
    atomicAdd(mismatches, (unsigned long long)n);
}

}  // namespace
}  // namespace cpt

// Kernel B: counts [B, C] f32 (zeroed by the caller) of the rows' noisy
// argmax; logits (f32 or bf16) and noise 16-byte aligned. ``plan``: 0 the
// rule (head_plan); kWide or kSingle force that plan (the checks run both
// on small planes). ``taken``, if not null, receives the plan run.
extern "C" int cpt_gumbel_hard_counts(const void* logits, int x_bf16,
                                      const float* noise, float* counts,
                                      int B, int HW, int C,
                                      unsigned long long seed, int plan,
                                      int* taken, void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || C % 4 != 0 || C > 12288 || plan < 0 ||
      plan > cpt::kSingle)
    return (int)cudaErrorInvalidValue;
  if (plan == 0) {
    int sms = 0;
    const cudaError_t err = cpt::sm_count(&sms);
    if (err != cudaSuccess) return (int)err;
    plan = cpt::head_plan(B, HW, C, sms);
  }
  if (taken != nullptr) *taken = plan;
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)cpt::launch_head<__nv_bfloat16>(plan, logits, noise, counts,
                                                B, HW, C, key, s);
  return (int)cpt::launch_head<float>(plan, logits, noise, counts, B, HW, C,
                                      key, s);
}

// The count of positive normal floats on which common.cuh: log_normal and
// logf differ, into ``mismatches`` (zeroed by the caller): 0 means kernels
// B and C draw logf's noise bit for bit.
extern "C" int cpt_gumbel_log_mismatches(unsigned long long* mismatches,
                                         void* stream) {
  int sms = 0;
  const cudaError_t err = cpt::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  cpt::log_check_kernel<<<8 * sms, cpt::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(mismatches);
  return (int)cudaGetLastError();
}

// Kernel C. ``mode`` (block.cuh: kQ*): 0 bf16, 1 int8 with static scales.
// Scratch from the caller: ``n`` [R, C] and ``h`` [R, 4C] of the GEMM
// operand type, ``keys`` [R]. ``counts`` [B, C] is written whole. x, w1,
// w2, noise, n and h are 16-byte aligned.
extern "C" int cpt_fused_block_gumbel_counts(
    const void* x, int x_bf16, int mode, int B, int H, int W, int C,
    const float* dwk, const float* dwb, const float* lns, const float* lnb,
    const void* w1, const float* s1, const float* b1, const float* i1,
    const void* w2, const float* s2, const float* b2, const float* i2,
    const float* g, float eps, const float* noise, float* counts,
    unsigned long long seed, void* n, void* h, unsigned long long* keys,
    void* stream) {
  const int HW = H * W, R = B * HW;
  if (C % 32 != 0 || R <= 0 || (mode != cpt::kQBf16 && mode != cpt::kQStatic))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = cpt_block_prologue(x, n, nullptr, nullptr, keys, 0, x_bf16, mode,
                               B, H, W, C, dwk, dwb, lns, lnb, i1, eps, 0, 0,
                               stream);
  if (err == 0)
    err = cpt_block_up(n, w1, s1, b1, i2, h, nullptr, nullptr, nullptr, mode,
                       0, R, C, 0, stream);
  if (err == 0)
    err = (int)cpt::head(h, w2, s2, b2, g, x, x_bf16, noise, keys, mode, R,
                         HW, C, seed, 0, st);
  if (err == 0) err = (int)cpt::count_keys(keys, counts, B, HW, C, st);
  return err;
}

// Kernel C's own launches alone, to hold each against its plain version
// and to time it: GEMM 2 with the head epilogue into ``keys`` [R] (zeroed
// by the caller; ``tile``: 0 the chosen tile, 1-5 the candidates), the
// count kernel, and GEMM 2 with the f32 block output stored into ``out``
// [R, C] on the head's tile (the plane the head takes its argmax of).
extern "C" int cpt_block_head_keys(const void* h, const void* w2,
                                   const float* s2, const float* b2,
                                   const float* g, const void* x, int x_bf16,
                                   const float* noise,
                                   unsigned long long* keys, int mode, int R,
                                   int HW, int C, unsigned long long seed,
                                   int tile, void* stream) {
  return (int)cpt::head(h, w2, s2, b2, g, x, x_bf16, noise, keys, mode, R,
                        HW, C, seed, tile, static_cast<cudaStream_t>(stream));
}

extern "C" int cpt_count_keys(const unsigned long long* keys, float* counts,
                              int B, int HW, int C, void* stream) {
  return (int)cpt::count_keys(keys, counts, B, HW, C,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int cpt_block_down_f32(const void* h, const void* w2,
                                  const float* s2, const float* b2,
                                  const float* g, const void* x, int x_bf16,
                                  float* out, int mode, int R, int C,
                                  void* stream) {
  if (R <= 0 || C % 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (x_bf16)
    return (int)cpt::down(
        h, w2, mode, R, C, 0,
        cpt::StoreBlockOut<BF>{{s2, b2, g, static_cast<const BF*>(x), C}, out},
        st);
  return (int)cpt::down(
      h, w2, mode, R, C, 0,
      cpt::StoreBlockOut<float>{{s2, b2, g, static_cast<const float*>(x), C},
                                out},
      st);
}
