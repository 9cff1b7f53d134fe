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
// channel c; a slot still 0 (a row of NaN) counts nowhere.
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

}  // namespace
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
