// K6: backward of K5 (the ConvNeXt block MLP) with respect to x and every
// parameter. Replaces count_pipnet_tpu/ops/pallas/fused_mlp_bwd.py:
// fused_mlp_bwd (:143), and at C = 768 the JAX package's
// fused_mlp.py:_mlp_body_manual_bwd (:173), which computes the same math.
//
//   recompute:  n = LN(x);  h = n W1^T + b1;  a = gelu_tanh(h)
//   backward:   dy = g * gamma;  da = dy W2;  dh = da * gelu'(h);
//               dn = dh W1;  dx = LN backward of dn
//   param sums: dW1 = dh^T n,  dW2r = g^T a  (over all R rows)
//               db1 = sum dh,  sg = sum g,  dls = sum dn * xhat,
//               dlb = sum dn
//
// The TPU kernel runs one sequential grid and accumulates the [C, 4C]
// weight gradients in VMEM across row tiles. On Hopper the accumulators
// (9.4 MB f32 each at C = 768) fit in no SM and blocks run in parallel.
// What bounds K6 is its five GEMMs, 40 R C^2 operations a call, so every
// GEMM runs on the TMA-fed wgmma core of sm90.cuh, with the elementwise
// work in row kernels and GEMM epilogues around it. Five launches and the
// ordered sums of their partial rows, on the stream:
//
//   a. bwd_prologue_kernel, one warp a row: mu and 1/sigma (f32 [R]),
//      nb = bf16(LN(x)), dyb = bf16(g * gamma), gb = bf16(g), and the
//      column sums of g (sg) into the CTA's partial row.
//   b. the dual GEMM (sm90::dual_gemm): h = nb W1^T and da = dyb W2 for
//      the same [128, 128] tile (C = 768; [128, 64] at C <= 384) in two
//      accumulators; the epilogue adds b1, computes tanh-GELU and its
//      derivative in f32, writes ab = bf16(a) and dhb = bf16(da *
//      gelu'(h)), and the column sums of dh (db1) of the row tile into a
//      partial row.
//   c. dn = dhb W1 (sm90::gemm, K = 4C), f32 [R, C].
//   d. bwd_ln_rows_kernel, one warp a row: dx = inv (dnh - mean dnh -
//      xhat mean(dnh xhat)), dnh = dn * lns, in x's dtype; the column sums
//      dls and dlb into the CTA's partial row.
//   e. dW1 = dhb^T nb and dW2r = gb^T ab (sm90::gemm_mn: MN-major
//      operands, K = R), split over R into a workspace when the tiles
//      alone do not fill the card, the splits added in order.
//
// The bf16 operands go to device memory and back (nb, dyb, gb: 6 R C
// bytes; ab, dhb: 16 R C; dn: 8 R C, each written once and read once or
// twice): the TPU kernel kept them in VMEM. All are scratch that the caller
// allocates. No float atomics anywhere: a run on the same card repeats bit
// for bit. Bound to Python with ctypes (ops/fused_mlp_bwd.py).
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace cpt {
namespace {

constexpr int kRowWarps = 8;  // rows kernels: one row a warp at a time

// The row kernels keep a lane's columns c = lane + 32 k, k < C / 32, in
// registers: MAXNC is the most a lane holds (C <= 32 MAXNC), and the
// register budget allows four CTAs an SM at MAXNC = 8, two above. A lane
// loads all MAXNC columns of a row's planes without a branch, at clamped
// indices (col), so that the loads are in flight together (loads under a
// branch each wait for the last); only columns k < nc count. The
// parameter vectors, which stay in L1, are read under the branch: read
// ahead they would spill registers.
#define CPT_ROW_MINB(maxnc) ((maxnc) <= 8 ? 4 : 2)

__device__ __forceinline__ int col(int lane, int k, int C) {
  const int c = lane + 32 * k;
  return c < C ? c : C - 1;
}

// The warps' column sums ``v`` (k < nc) added in warp order into ``out``
// (C floats of this CTA's partial row), through ``red`` (C floats).
template <int MAXNC>
__device__ __forceinline__ void cta_column_sums(const float (&v)[MAXNC],
                                                float* red, float* out,
                                                int C) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nc = C / 32;
  for (int w = 0; w < kRowWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int k = 0; k < MAXNC; ++k)
        if (k < nc) {
          const int c = lane + 32 * k;
          red[c] = (w == 0 ? 0.0f : red[c]) + v[k];
        }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) out[c] = red[c];
  __syncthreads();
}

// a. LayerNorm statistics and the bf16 GEMM operands (two-pass mean and
// variance, rsqrtf(var / C + eps), as K5's ln_rows_kernel); partial row:
// sg [C].
template <int MAXNC, typename TX, typename TG>
__global__ void __launch_bounds__(32 * kRowWarps, CPT_ROW_MINB(MAXNC))
    bwd_prologue_kernel(const TX* __restrict__ x, const TG* __restrict__ g,
                        int R, int C, const float* __restrict__ lns,
                        const float* __restrict__ lnb,
                        const float* __restrict__ gamma, float eps,
                        float* __restrict__ mu_out,
                        float* __restrict__ inv_out,
                        __nv_bfloat16* __restrict__ nb,
                        __nv_bfloat16* __restrict__ dyb,
                        __nv_bfloat16* __restrict__ gb,
                        float* __restrict__ part) {
  __shared__ float red[32 * MAXNC];
  const int lane = threadIdx.x % 32, nc = C / 32;
  float sg[MAXNC];
#pragma unroll
  for (int k = 0; k < MAXNC; ++k) sg[k] = 0.0f;
  for (int row = blockIdx.x * kRowWarps + threadIdx.x / 32; row < R;
       row += gridDim.x * kRowWarps) {
    const size_t o = (size_t)row * C;
    float xv[MAXNC], gv[MAXNC];
#pragma unroll
    for (int k = 0; k < MAXNC; ++k) {
      xv[k] = to_f32(x[o + col(lane, k, C)]);
      gv[k] = to_f32(g[o + col(lane, k, C)]);
    }
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < MAXNC; ++k)
      if (k < nc) s += xv[k];
    const float mu = warp_sum(s) / C;
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < MAXNC; ++k)
      if (k < nc) {
        const float t = xv[k] - mu;
        v += t * t;
      }
    const float inv = rsqrtf(warp_sum(v) / C + eps);
    if (lane == 0) {
      mu_out[row] = mu;
      inv_out[row] = inv;
    }
#pragma unroll
    for (int k = 0; k < MAXNC; ++k)
      if (k < nc) {
        const int c = lane + 32 * k;
        nb[o + c] =
            __float2bfloat16_rn((xv[k] - mu) * inv * lns[c] + lnb[c]);
        dyb[o + c] = __float2bfloat16_rn(gv[k] * gamma[c]);
        gb[o + c] = __float2bfloat16_rn(gv[k]);
        sg[k] += gv[k];
      }
  }
  cta_column_sums<MAXNC>(sg, red, part + (size_t)blockIdx.x * C, C);
}

// d. LayerNorm backward; partial row: dls [C] | dlb [C].
template <int MAXNC, typename TX>
__global__ void __launch_bounds__(32 * kRowWarps, CPT_ROW_MINB(MAXNC))
    bwd_ln_rows_kernel(const float* __restrict__ dn,
                       const TX* __restrict__ x,
                       const float* __restrict__ mu_in,
                       const float* __restrict__ inv_in,
                       const float* __restrict__ lns, TX* __restrict__ dx,
                       int R, int C, float* __restrict__ part) {
  __shared__ float red[32 * MAXNC];
  const int lane = threadIdx.x % 32, nc = C / 32;
  float dls[MAXNC], dlb[MAXNC];
#pragma unroll
  for (int k = 0; k < MAXNC; ++k) dls[k] = dlb[k] = 0.0f;
  for (int row = blockIdx.x * kRowWarps + threadIdx.x / 32; row < R;
       row += gridDim.x * kRowWarps) {
    const size_t o = (size_t)row * C;
    const float mu = mu_in[row], inv = inv_in[row];
    float xh[MAXNC], d[MAXNC];  // dn * lns is recomputed: registers
#pragma unroll
    for (int k = 0; k < MAXNC; ++k) {
      d[k] = dn[o + col(lane, k, C)];
      xh[k] = to_f32(x[o + col(lane, k, C)]);
    }
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < MAXNC; ++k)
      if (k < nc) {
        const float dnh = d[k] * lns[lane + 32 * k];
        xh[k] = (xh[k] - mu) * inv;
        dls[k] += d[k] * xh[k];
        dlb[k] += d[k];
        s1 += dnh;
        s2 += dnh * xh[k];
      }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
    for (int k = 0; k < MAXNC; ++k)
      if (k < nc) {
        const float dnh = d[k] * lns[lane + 32 * k];
        store_as(dx + o + lane + 32 * k, inv * (dnh - m1 - xh[k] * m2));
      }
  }
  float* out = part + (size_t)blockIdx.x * 2 * C;
  cta_column_sums<MAXNC>(dls, red, out, C);
  cta_column_sums<MAXNC>(dlb, red, out + C, C);
}

// tanh-GELU and its derivative (f32), as the plain version's
// gelu_tanh_and_grad.
__device__ __forceinline__ void gelu_tanh_and_grad(float h, float& a,
                                                   float& dg) {
  const float k0 = 0.7978845608028654f, k1 = 0.044715f;
  const float th = tanhf(k0 * (h + k1 * h * h * h));
  a = 0.5f * h * (1.0f + th);
  dg = 0.5f * (1.0f + th) +
       0.5f * h * (1.0f - th * th) * k0 * (1.0f + 3.0f * k1 * h * h);
}

// b. the dual GEMM's epilogue: d1 = n W1^T, d2 = dy W2 of one [128, BN]
// tile. In registers: a = gelu(d1 + b1), dh = d2 * gelu'(d1 + b1); the
// column sums of dh over the tile's rows (lanes of a warp that share
// columns by shuffles, then the eight warps in order); bf16 a and dh
// staged through shared memory and stored as whole 16-byte row pieces.
// Rows past R have zero operands (the TMA fills them), so dh = 0 there and
// the sums need no mask.
struct GeluBwd {
  const float* b1;
  __nv_bfloat16* ab;
  __nv_bfloat16* dhb;
  float* part;  // [ceil(R / 128), 4C]: the row tiles' column sums of dh

  template <int BN>
  __host__ __device__ static constexpr int stride() {
    return BN + 8;  // bf16: 8 rows of a warp's pair stores on 32 banks
  }
  template <int BN>
  __host__ __device__ static constexpr int smem_bytes() {
    return 2 * sm90::kBM * stride<BN>() * 2 + kRowWarps * BN * 4;
  }

  template <int H>  // H = BN / 2 accumulators a thread
  __device__ __forceinline__ void operator()(float (&h)[H], float (&da)[H],
                                             unsigned char* smem, int m0,
                                             int n0, int M, int N) const {
    constexpr int BN = 2 * H, S = stride<BN>();
    __nv_bfloat16* ta = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* td = ta + sm90::kBM * S;
    float* cs = reinterpret_cast<float*>(td + sm90::kBM * S);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      const float2 b = *reinterpret_cast<const float2*>(b1 + n0 + c);
      float s[2] = {0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float a, dg;
        gelu_tanh_and_grad(h[4 * j + e] + (e & 1 ? b.y : b.x), a, dg);
        h[4 * j + e] = a;
        da[4 * j + e] *= dg;
        s[e & 1] += da[4 * j + e];
      }
      *reinterpret_cast<__nv_bfloat162*>(ta + r0 * S + c) =
          __floats2bfloat162_rn(h[4 * j], h[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(ta + (r0 + 8) * S + c) =
          __floats2bfloat162_rn(h[4 * j + 2], h[4 * j + 3]);
      *reinterpret_cast<__nv_bfloat162*>(td + r0 * S + c) =
          __floats2bfloat162_rn(da[4 * j], da[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(td + (r0 + 8) * S + c) =
          __floats2bfloat162_rn(da[4 * j + 2], da[4 * j + 3]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s[0] += __shfl_xor_sync(0xffffffffu, s[0], off);
        s[1] += __shfl_xor_sync(0xffffffffu, s[1], off);
      }
      if (lane < 4) {
        cs[warp * BN + c] = s[0];
        cs[warp * BN + c + 1] = s[1];
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(sm90::kConsumers) : "memory");
    for (int i = threadIdx.x; i < sm90::kBM * (BN / 8);
         i += sm90::kConsumers) {
      const int r = i / (BN / 8), c = 8 * (i % (BN / 8));
      if (m0 + r < M) {
        const size_t o = (size_t)(m0 + r) * N + n0 + c;
        *reinterpret_cast<uint4*>(ab + o) =
            *reinterpret_cast<const uint4*>(ta + r * S + c);
        *reinterpret_cast<uint4*>(dhb + o) =
            *reinterpret_cast<const uint4*>(td + r * S + c);
      }
    }
    for (int c = threadIdx.x; c < BN; c += sm90::kConsumers) {
      float v = 0.0f;
      for (int w = 0; w < kRowWarps; ++w) v += cs[w * BN + c];
      part[(size_t)(m0 / sm90::kBM) * N + n0 + c] = v;
    }
  }
};

// e.: split z of the rows writes the z-th [M, N] slab of the workspace.
struct StoreSplit {
  float* d;
  int M, N;
  __host__ __device__ sm90::StoreF32 split(int z) const {
    return sm90::StoreF32{d + (size_t)z * M * N, N};
  }
};

// out[i] = sum over s = 0 .. S-1 of in[s * n + i], in that order.
__global__ void sum_splits_kernel(const float* __restrict__ in, float* out,
                                  int S, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float v = 0.0f;
    for (int s = 0; s < S; ++s) v += in[(size_t)s * n + i];
    out[i] = v;
  }
}

cudaError_t sum_rows(const float* part, float* out, int S, int n,
                     cudaStream_t st) {
  const int need = (n + 255) / 256;
  const int blocks = need < 1024 ? need : 1024;
  sum_splits_kernel<<<blocks, 256, 0, st>>>(part, out, S, n);
  return cudaGetLastError();
}

// The row kernels' grid: as many CTAs as fit on the card at once, at most
// one for each kRowWarps rows. The partial rows, and so the order of the
// column sums, depend on it: the same card repeats bit for bit.
int rows_grid(int R, int C, int sms) {
  const int ctas = CPT_ROW_MINB(C <= 256 ? 8 : 32) * sms;
  const int need = (R + kRowWarps - 1) / kRowWarps;
  return need < ctas ? need : ctas;
}

// The weight gradients' tiles: 128 x 256, one CTA an SM, where 256
// divides N (a 256-wide tile reads less shared memory a product); else
// 128 x 128, two CTAs an SM.
bool wgrad_wide(int N) { return N % 256 == 0; }

// The weight-gradient splits: the tiles of one product times the splits in
// whole waves, each split's steps plus a fill and an epilogue, plus the
// ordered sum of the workspace; the cheapest by that model (about 0.56 us
// a 64-row step of a 128 x 128 tile with two CTAs an SM or of a 128 x 256
// tile alone, 4 us a tile of fill and epilogue, the sum at 3 TB/s).
int wgrad_splits(int R, int M, int N, int sms) {
  const int bn = wgrad_wide(N) ? 256 : 128;
  const int tiles = ((M + 127) / 128) * ((N + bn - 1) / bn);
  const int steps = (R + sm90::kBK - 1) / sm90::kBK;
  const int slots = (bn == 256 ? 1 : 2) * sms;
  int best = 1;
  double best_us = 1e30;
  for (int s = 1; s <= 256 && s <= steps; ++s) {
    const int per = (steps + s - 1) / s;
    if ((s - 1) * per >= steps) continue;  // an empty split
    const int waves = (tiles * s + slots - 1) / slots;
    const double us = waves * (0.56 * per + 4.0) +
                      (s > 1 ? (s + 1.0) * M * N * 4 / 3e6 : 0.0);
    if (us < best_us) {
      best_us = us;
      best = s;
    }
  }
  return best;
}

// The row kernels' MAXNC for C: C / 32 rounded up to 8, 16, 24 or 32 (no
// more registers than C = 256, 512, 768 or 1024 need).
template <typename F>
cudaError_t with_width(int C, F f) {
  if (C % 32 != 0 || C <= 0 || C > 1024) return cudaErrorInvalidValue;
  if (C <= 256) return f(std::integral_constant<int, 8>());
  if (C <= 512) return f(std::integral_constant<int, 16>());
  if (C <= 768) return f(std::integral_constant<int, 24>());
  return f(std::integral_constant<int, 32>());
}

cudaError_t prologue(const void* x, int x_bf16, const void* g, int g_bf16,
                     int R, int C, const float* lns, const float* lnb,
                     const float* gamma, float eps, float* mu, float* inv,
                     void* nb, void* dyb, void* gb, float* part, int grid,
                     float* sg, cudaStream_t st) {
  using BF = __nv_bfloat16;
  cudaError_t err = with_width(C, [&](auto nc) {
    constexpr int NC = decltype(nc)::value;
    auto go = [&](auto tx, auto tg) {
      using TX = decltype(tx);
      using TG = decltype(tg);
      bwd_prologue_kernel<NC, TX, TG><<<grid, 32 * kRowWarps, 0, st>>>(
          static_cast<const TX*>(x), static_cast<const TG*>(g), R, C, lns,
          lnb, gamma, eps, mu, inv, static_cast<BF*>(nb),
          static_cast<BF*>(dyb), static_cast<BF*>(gb), part);
      return cudaGetLastError();
    };
    if (x_bf16) return g_bf16 ? go(BF(), BF()) : go(BF(), float());
    return g_bf16 ? go(float(), BF()) : go(float(), float());
  });
  if (err != cudaSuccess) return err;
  return sum_rows(part, sg, grid, C, st);
}

// b. At C = 768 (12 K steps a tile) BN = 128: 128 accumulator registers
// a thread, three stages of four 16 KB tiles, one CTA an SM. At C <= 384
// (at most 6 K steps) the fill and the epilogue weigh more than the
// wgmma: BN = 64 and two stages, so that two CTAs share an SM and one's
// epilogue runs under the other's wgmma. 4C is a multiple of 128.
cudaError_t dual(const void* nb, const void* dyb, const void* w1,
                 const void* w2t, const float* b1, void* ab, void* dhb,
                 float* part, int R, int C, float* db1, cudaStream_t st) {
  using BF = __nv_bfloat16;
  const GeluBwd epi{b1, static_cast<BF*>(ab), static_cast<BF*>(dhb), part};
  cudaError_t err =
      C <= 384
          ? sm90::dual_gemm<64, 2, 2>(nb, w1, dyb, w2t, R, 4 * C, C, epi, st)
          : sm90::dual_gemm<128, 3, 1>(nb, w1, dyb, w2t, R, 4 * C, C, epi,
                                       st);
  if (err != cudaSuccess) return err;
  return sum_rows(part, db1, (R + sm90::kBM - 1) / sm90::kBM, 4 * C, st);
}

// c. the tiles K5 takes for its GEMM 2 (N = C, K = 4C): 256 wide, one CTA
// an SM, where 256 divides C; else 128 or 96, two CTAs an SM.
cudaError_t dn_gemm(const void* dhb, const void* w1t, float* dn, int R,
                    int C, cudaStream_t st) {
  const sm90::StoreF32 epi{dn, C};
  if (C % 256 == 0)
    return sm90::gemm<256, 4, 1>(dhb, w1t, R, C, 4 * C, epi, st);
  if (C % 128 == 0)
    return sm90::gemm<128, 3, 2>(dhb, w1t, R, C, 4 * C, epi, st);
  return sm90::gemm<96, 3, 2>(dhb, w1t, R, C, 4 * C, epi, st);
}

cudaError_t ln_bwd(const float* dn, const void* x, int x_bf16,
                   const float* mu, const float* inv, const float* lns,
                   void* dx, int R, int C, float* part, int grid,
                   float* dls_dlb, cudaStream_t st) {
  using BF = __nv_bfloat16;
  cudaError_t err = with_width(C, [&](auto nc) {
    constexpr int NC = decltype(nc)::value;
    if (x_bf16) {
      bwd_ln_rows_kernel<NC, BF><<<grid, 32 * kRowWarps, 0, st>>>(
          dn, static_cast<const BF*>(x), mu, inv, lns, static_cast<BF*>(dx),
          R, C, part);
    } else {
      bwd_ln_rows_kernel<NC, float><<<grid, 32 * kRowWarps, 0, st>>>(
          dn, static_cast<const float*>(x), mu, inv, lns,
          static_cast<float*>(dx), R, C, part);
    }
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  return sum_rows(part, dls_dlb, grid, 2 * C, st);
}

// e. out [M, N] = A^T B, A [R, M], B [R, N]: 128 x 256 tiles with four
// stages, or 128 x 128 with three and two CTAs an SM (wgrad_wide); split
// over R into ``ws`` (splits * M * N floats) when splits > 1.
cudaError_t wgrad(const void* A, const void* B, float* out, float* ws,
                  int R, int M, int N, int splits, cudaStream_t st) {
  const StoreSplit epi{splits > 1 ? ws : out, M, N};
  cudaError_t err =
      wgrad_wide(N) ? sm90::gemm_mn<256, 4, 1>(A, B, M, N, R, splits, epi, st)
                    : sm90::gemm_mn<128, 3, 2>(A, B, M, N, R, splits, epi, st);
  if (err != cudaSuccess || splits == 1) return err;
  return sum_rows(ws, out, splits, M * N, st);
}

}  // namespace
}  // namespace cpt

// Sizes the caller allocates: the row kernels' grid (partial rows of C and
// 2C floats a CTA) and the splits over R of dW1 and dW2r (a workspace of
// max(splits) * 4 C^2 floats when one is above 1).
extern "C" int cpt_fused_mlp_bwd_plan(int R, int C, int* grid_rows,
                                      int* splits1, int* splits2) {
  if (C % 32 != 0 || C > 1024 || R <= 0) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = cpt::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  *grid_rows = cpt::rows_grid(R, C, sms);
  *splits1 = cpt::wgrad_splits(R, 4 * C, C, sms);
  *splits2 = cpt::wgrad_splits(R, C, 4 * C, sms);
  return 0;
}

// The split over R of one weight-gradient product alone.
extern "C" int cpt_mlp_wgrad_plan(int R, int M, int N, int* splits) {
  if (R <= 0 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = cpt::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  *splits = cpt::wgrad_splits(R, M, N, sms);
  return 0;
}

// K6: the five launches and the ordered sums. Scratch: mu, inv [R] f32;
// nb, dyb, gb [R, C] bf16; ab, dhb [R, 4C] bf16; dn [R, C] f32; part_a
// [grid_rows, C], part_b [ceil(R / 128), 4C], part_d [grid_rows, 2C] f32;
// ws [max(splits1, splits2), 4C, C] f32 when either is above 1. Out: dx [R, C] (x's type), dw1
// [4C, C], dw2r [C, 4C], vec [7C] = db1 | sg | dls | dlb (f32). w1 [4C, C],
// w1t [C, 4C], w2t [4C, C] bf16; every bf16 operand 16-byte aligned.
extern "C" int cpt_fused_mlp_bwd(
    const void* x, const void* g, void* dx, int x_bf16, int g_bf16, int R,
    int C, const float* lns, const float* lnb, const void* w1,
    const void* w1t, const void* w2t, const float* b1, const float* gamma,
    float eps, float* mu, float* inv, void* nb, void* dyb, void* gb,
    void* ab, void* dhb, float* dn, float* part_a, float* part_b,
    float* part_d, int grid_rows, float* ws, int splits1, int splits2,
    float* dw1,
    float* dw2r, float* vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cpt::prologue(x, x_bf16, g, g_bf16, R, C, lns, lnb,
                                  gamma, eps, mu, inv, nb, dyb, gb, part_a,
                                  grid_rows, vec + 4 * C, st);
  if (err == cudaSuccess)
    err = cpt::dual(nb, dyb, w1, w2t, b1, ab, dhb, part_b, R, C, vec, st);
  if (err == cudaSuccess) err = cpt::dn_gemm(dhb, w1t, dn, R, C, st);
  if (err == cudaSuccess)
    err = cpt::ln_bwd(dn, x, x_bf16, mu, inv, lns, dx, R, C, part_d,
                      grid_rows, vec + 5 * C, st);
  if (err == cudaSuccess)
    err = cpt::wgrad(dhb, nb, dw1, ws, R, 4 * C, C, splits1, st);
  if (err == cudaSuccess)
    err = cpt::wgrad(gb, ab, dw2r, ws, R, C, 4 * C, splits2, st);
  return (int)err;
}

// K6's launches on their own (each with the ordered sum of its partial
// rows), to hold each against its plain version.
extern "C" int cpt_mlp_bwd_prologue(const void* x, int x_bf16, const void* g,
                                    int g_bf16, int R, int C,
                                    const float* lns, const float* lnb,
                                    const float* gamma, float eps, float* mu,
                                    float* inv, void* nb, void* dyb,
                                    void* gb, float* part, int grid_rows,
                                    float* sg, void* stream) {
  return (int)cpt::prologue(x, x_bf16, g, g_bf16, R, C, lns, lnb, gamma,
                            eps, mu, inv, nb, dyb, gb, part, grid_rows, sg,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int cpt_mlp_bwd_dual(const void* nb, const void* dyb,
                                const void* w1, const void* w2t,
                                const float* b1, void* ab, void* dhb,
                                float* part, int R, int C, float* db1,
                                void* stream) {
  if (C % 32 != 0) return (int)cudaErrorInvalidValue;
  return (int)cpt::dual(nb, dyb, w1, w2t, b1, ab, dhb, part, R, C, db1,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int cpt_mlp_bwd_dn(const void* dhb, const void* w1t, float* dn,
                              int R, int C, void* stream) {
  if (C % 32 != 0) return (int)cudaErrorInvalidValue;
  return (int)cpt::dn_gemm(dhb, w1t, dn, R, C,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int cpt_mlp_bwd_ln(const float* dn, const void* x, int x_bf16,
                              const float* mu, const float* inv,
                              const float* lns, void* dx, int R, int C,
                              float* part, int grid_rows, float* dls_dlb,
                              void* stream) {
  return (int)cpt::ln_bwd(dn, x, x_bf16, mu, inv, lns, dx, R, C, part,
                          grid_rows, dls_dlb,
                          static_cast<cudaStream_t>(stream));
}

// The MN-major GEMM core alone: out [M, N] f32 = A [R, M]^T . B [R, N].
extern "C" int cpt_mlp_wgrad(const void* a, const void* b, float* out,
                             float* ws, int R, int M, int N, int splits,
                             void* stream) {
  return (int)cpt::wgrad(a, b, out, ws, R, M, N, splits,
                         static_cast<cudaStream_t>(stream));
}
