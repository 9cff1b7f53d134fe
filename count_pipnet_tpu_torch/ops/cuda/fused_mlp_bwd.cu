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
// (9.4 MB f32 each at C = 768) fit in no SM, and blocks run in parallel,
// so the work is split in two:
//
//   (a) mlp_bwd_rows_kernel, row-parallel: a CTA owns 32 rows at a time
//       (persistent over tiles), recomputes n, h, a and gelu', computes
//       da and dn on the tensor cores (mma.sync bf16, the 4C-wide chunk of
//       128 in shared memory), the LayerNorm backward for dx, and adds the
//       vector sums into its own row of a partial buffer (no atomics). It
//       writes n, g, a and dh to device memory in bf16: the operands of
//       (b). The TPU kernel kept those in VMEM; here they cost
//       2 * R * 10C bytes of writes and reads.
//   (b) gemm_tn_kernel, the two tall-skinny products dW1 and dW2r as
//       tiles of 128 x 128, each summed over one fixed chunk of rows (split
//       so the card has enough CTAs), then the chunks and the partial rows
//       of (a) are added in a fixed order by sum_splits_kernel.
//
// No float atomics anywhere: a run on the same card repeats bit for bit.
// What bounds it: the five GEMMs, 10 * R * C * 4C flops per call.
#include "block.cuh"

namespace cpt {

constexpr int kBTM = 32;       // rows per tile in (a)
constexpr int kBHC = 128;      // hidden chunk in (a)
constexpr int kBThreads = 256;
constexpr int kGM = 128, kGN = 128, kGK = 32;  // (b): tile, rows per step
constexpr int kGThreads = 256;                 // 8 warps: 2 (M) x 4 (N)
constexpr int kGS = kGM + 8;  // row stride: ldmatrix's 8 rows on 8 banks

struct MlpBwdParams {
  const void* x;   // [R, C] TX, the block-body input (depthwise output)
  const void* g;   // [R, C] TG, cotangent of the block output
  void* dx;        // [R, C] TX
  int R, C;
  const float* lns;
  const float* lnb;
  const __nv_bfloat16* w1;   // [4C, C]  pw1 weight ([out, in])
  const __nv_bfloat16* w1t;  // [C, 4C]  its transpose
  const __nv_bfloat16* w2t;  // [4C, C]  pw2 weight transposed
  const float* b1;           // [4C]
  const float* gamma;        // [C]
  float eps;
  __nv_bfloat16* nb;   // [R, C]  out: LN output
  __nv_bfloat16* gb;   // [R, C]  out: g
  __nv_bfloat16* ab;   // [R, 4C] out: GELU output
  __nv_bfloat16* dhb;  // [R, 4C] out: dh
  float* part;         // [gridDim.x, 7C], zeroed: db1 | sg | dls | dlb
};

__host__ __device__ inline size_t rows_smem_bytes(int C) {
  return (size_t)kBTM * (C + 8) * 4          // dn accumulator
         + 2 * (size_t)kBTM * (C + 8) * 2    // n and dy (bf16)
         + (size_t)kBTM * (kBHC + 8) * 2     // dh chunk (bf16)
         + 2 * kBHC * 4 + 2 * kBTM * 4;      // column sums, mu, 1/sigma
}

template <typename TX, typename TG>
__global__ void __launch_bounds__(kBThreads)
    mlp_bwd_rows_kernel(const MlpBwdParams p) {
  const int C = p.C, HD = 4 * C;
  const int as = C + 8, ns = C + 8, hs = kBHC + 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, tq = lane & 3;
  constexpr int kWarps = kBThreads / 32;

  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  __nv_bfloat16* nbs =
      reinterpret_cast<__nv_bfloat16*>(smem + (size_t)kBTM * as * 4);
  __nv_bfloat16* dys = nbs + kBTM * ns;
  __nv_bfloat16* hsm = dys + kBTM * ns;
  float* colsum = reinterpret_cast<float*>(hsm + kBTM * hs);
  float* mu_s = colsum + 2 * kBHC;
  float* inv_s = mu_s + kBTM;

  const TX* x = static_cast<const TX*>(p.x);
  const TG* g = static_cast<const TG*>(p.g);
  const unsigned char* w1 = reinterpret_cast<const unsigned char*>(p.w1);
  const unsigned char* w1t = reinterpret_cast<const unsigned char*>(p.w1t);
  const unsigned char* w2t = reinterpret_cast<const unsigned char*>(p.w2t);
  float* part = p.part + (size_t)blockIdx.x * 7 * C;
  const int ntiles = (p.R + kBTM - 1) / kBTM;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * kBTM;

    // 1. LayerNorm statistics, n and dy = g * gamma as bf16 GEMM operands
    // (one warp a row); n and g to device memory for (b). Rows past R are
    // zeros: their dy is 0, so they add nothing to any sum.
    for (int r = warp; r < kBTM; r += kWarps) {
      const int row = row0 + r;
      const bool ok = row < p.R;
      const TX* xr = x + (size_t)row * C;
      const TG* gr = g + (size_t)row * C;
      float s = 0.0f;
      if (ok)
        for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
      const float mu = warp_sum(s) / C;
      float v = 0.0f;
      if (ok)
        for (int c = lane; c < C; c += 32) {
          const float t = to_f32(xr[c]) - mu;
          v += t * t;
        }
      const float inv = rsqrtf(warp_sum(v) / C + p.eps);
      if (lane == 0) {
        mu_s[r] = mu;
        inv_s[r] = inv;
      }
      for (int c = lane; c < C; c += 32) {
        const float xv = ok ? to_f32(xr[c]) : 0.0f;
        const __nv_bfloat16 nv =
            __float2bfloat16_rn((xv - mu) * inv * p.lns[c] + p.lnb[c]);
        const float gv = ok ? to_f32(gr[c]) : 0.0f;
        nbs[r * ns + c] = nv;
        dys[r * ns + c] = __float2bfloat16_rn(gv * p.gamma[c]);
        if (ok) {
          p.nb[(size_t)row * C + c] = nv;
          p.gb[(size_t)row * C + c] = __float2bfloat16_rn(gv);
        }
      }
    }
    for (int idx = tid; idx < kBTM * as; idx += kBThreads) acc[idx] = 0.0f;
    __syncthreads();

    // 2. hidden chunks of 128
    for (int j0 = 0; j0 < HD; j0 += kBHC) {
      // h = n W1^T and da = dy W2 for the chunk: warp -> m-tile (warp & 1)
      // and 4 n-tiles; both products land in the same fragment slots
      const int mt = warp & 1, nbase = (warp >> 1) * 4;
      float hc[4][4], dc[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) hc[t][e] = dc[t][e] = 0.0f;
#pragma unroll 2
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t an[4], ad[4];
        load_frag_a(an,
                    reinterpret_cast<const unsigned char*>(
                        nbs + (mt * 16) * ns + k0), ns * 2, lane);
        load_frag_a(ad,
                    reinterpret_cast<const unsigned char*>(
                        dys + (mt * 16) * ns + k0), ns * 2, lane);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const size_t off = ((size_t)(j0 + (nbase + t) * 8) * C + k0) * 2;
          uint32_t bf[2];
          load_frag_b(bf, w1 + off, C * 2, lane);
          mma(hc[t], an, bf, __nv_bfloat16());
          load_frag_b(bf, w2t + off, C * 2, lane);
          mma(dc[t], ad, bf, __nv_bfloat16());
        }
      }
      // GELU and its derivative; dh to shared memory (bf16) and, with a,
      // to device memory; column sums of dh (f32) for db1
      float cs[4][2];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        cs[t][0] = cs[t][1] = 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = mt * 16 + g8 + (e >> 1) * 8;
          const int jl = (nbase + t) * 8 + tq * 2 + (e & 1);
          const int j = j0 + jl;
          const float h = hc[t][e] + p.b1[j];
          const float k0c = 0.7978845608028654f, k1 = 0.044715f;
          const float th = tanhf(k0c * (h + k1 * h * h * h));
          const float a = 0.5f * h * (1.0f + th);
          const float dg = 0.5f * (1.0f + th) +
                           0.5f * h * (1.0f - th * th) * k0c *
                               (1.0f + 3.0f * k1 * h * h);
          const float dh = dc[t][e] * dg;
          const __nv_bfloat16 dhb = __float2bfloat16_rn(dh);
          hsm[r * hs + jl] = dhb;
          const int row = row0 + r;
          if (row < p.R) {
            p.ab[(size_t)row * HD + j] = __float2bfloat16_rn(a);
            p.dhb[(size_t)row * HD + j] = dhb;
          }
          cs[t][e & 1] += dh;
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float v = cs[t][k];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g8 == 0) colsum[mt * kBHC + (nbase + t) * 8 + tq * 2 + k] = v;
        }
      __syncthreads();
      for (int jl = tid; jl < kBHC; jl += kBThreads)
        part[j0 + jl] += colsum[jl] + colsum[kBHC + jl];
      // dn [32, C] += dh chunk @ W1[j0:j0+128, :]
      const int ntn = C / 8;
#pragma unroll 2
      for (int t = warp; t < 2 * ntn; t += kWarps) {
        const int mt2 = t & 1, n0 = (t >> 1) * 8;
        float c4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k0 = 0; k0 < kBHC; k0 += 16) {
          uint32_t a[4], bf[2];
          load_frag_a(a,
                      reinterpret_cast<const unsigned char*>(
                          hsm + (mt2 * 16) * hs + k0), hs * 2, lane);
          load_frag_b(bf, w1t + ((size_t)n0 * HD + j0 + k0) * 2, HD * 2,
                      lane);
          mma(c4, a, bf, __nv_bfloat16());
        }
        float* dst = acc + (mt2 * 16 + g8) * as + n0 + tq * 2;
        dst[0] += c4[0];
        dst[1] += c4[1];
        dst[8 * as] += c4[2];
        dst[8 * as + 1] += c4[3];
      }
      __syncthreads();
    }

    // 3. LayerNorm backward, one warp a row:
    //    dx = inv * (dnh - mean(dnh) - xhat * mean(dnh * xhat)), dnh = dn*ls
    for (int r = warp; r < kBTM; r += kWarps) {
      const int row = row0 + r;
      if (row >= p.R) break;
      const float mu = mu_s[r], inv = inv_s[r];
      const TX* xr = x + (size_t)row * C;
      float s1 = 0.0f, s2 = 0.0f;
      for (int c = lane; c < C; c += 32) {
        const float xh = (to_f32(xr[c]) - mu) * inv;
        const float dnh = acc[r * as + c] * p.lns[c];
        s1 += dnh;
        s2 += dnh * xh;
      }
      const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
      TX* dxr = static_cast<TX*>(p.dx) + (size_t)row * C;
      for (int c = lane; c < C; c += 32) {
        const float xh = (to_f32(xr[c]) - mu) * inv;
        const float dnh = acc[r * as + c] * p.lns[c];
        store_as(dxr + c, inv * (dnh - m1 - xh * m2));
      }
    }
    // 4. column sums sg, dls, dlb of the tile (a thread a channel, rows in
    // order) into this CTA's partial row
    for (int c = tid; c < C; c += kBThreads) {
      float sg = 0.0f, dls = 0.0f, dlb = 0.0f;
      for (int r = 0; r < kBTM; ++r) {
        const int row = row0 + r;
        if (row >= p.R) break;
        const float dn = acc[r * as + c];
        const float xh =
            (to_f32(x[(size_t)row * C + c]) - mu_s[r]) * inv_s[r];
        sg += to_f32(g[(size_t)row * C + c]);
        dls += dn * xh;
        dlb += dn;
      }
      part[HD + c] += sg;
      part[HD + C + c] += dls;
      part[HD + 2 * C + c] += dlb;
    }
    __syncthreads();
  }
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lane l gives
// the address of row l % 8 of matrix l / 8 and receives, of each matrix,
// the elements (2 * (l % 4), l / 4) and (2 * (l % 4) + 1, l / 4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* row) {
  const uint32_t a =
      static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// out[s][m, n] = sum over rows r of chunk s of A[r, m] * B[r, n]; A [R, M]
// and B [R, N] bf16 row-major, M and N multiples of 32. A 128 x 128 tile
// per CTA, 8 warps of 64 x 32. Each step stores 32 rows of both operands
// in shared memory as they lie in device memory (16-byte stores), while
// the next 32 rows are loaded into registers; ldmatrix.trans turns the
// [r][m] and [r][n] tiles into mma.sync's A and B fragments.
__global__ void __launch_bounds__(kGThreads)
    gemm_tn_kernel(const __nv_bfloat16* __restrict__ A,
                   const __nv_bfloat16* __restrict__ B, float* out, int R,
                   int M, int N, int rows_per_split) {
  __shared__ __align__(16) __nv_bfloat16 As[kGK][kGS];
  __shared__ __align__(16) __nv_bfloat16 Bs[kGK][kGS];
  const int n0 = blockIdx.x * kGN, m0 = blockIdx.y * kGM, s = blockIdx.z;
  const int r_begin = s * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, tq = lane & 3;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int mr = lane & 7, mj = lane >> 3;  // ldmatrix: row, matrix
  float c[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][t][e] = 0.0f;

  // 32 rows x 128 columns = 512 chunks of 8 per operand, 2 per thread
  uint4 va[2], vb[2];
  auto fetch = [&](int r0) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = tid + it * kGThreads;
      const int row = r0 + (idx >> 4), q = (idx & 15) * 8;
      va[it] = vb[it] = make_uint4(0u, 0u, 0u, 0u);
      if (row < r_end && m0 + q < M)
        va[it] = *reinterpret_cast<const uint4*>(A + (size_t)row * M + m0 +
                                                 q);
      if (row < r_end && n0 + q < N)
        vb[it] = *reinterpret_cast<const uint4*>(B + (size_t)row * N + n0 +
                                                 q);
    }
  };
  fetch(r_begin);
  for (int r0 = r_begin; r0 < r_end; r0 += kGK) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = tid + it * kGThreads;
      const int rr = idx >> 4, q = (idx & 15) * 8;
      *reinterpret_cast<uint4*>(&As[rr][q]) = va[it];
      *reinterpret_cast<uint4*>(&Bs[rr][q]) = vb[it];
    }
    __syncthreads();
    if (r0 + kGK < r_end) fetch(r0 + kGK);
#pragma unroll
    for (int k0 = 0; k0 < kGK; k0 += 16) {
      // A of m-tile i: matrices (k0, m), (k0, m + 8), (k0 + 8, m),
      // (k0 + 8, m + 8) of the [r][m] tile
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4_trans(a[i], &As[k0 + (mj >> 1) * 8 + mr]
                                   [wm + i * 16 + (mj & 1) * 8]);
      // B of n-tiles 2j and 2j + 1: matrices (k0, n), (k0 + 8, n),
      // (k0, n + 8), (k0 + 8, n + 8) of the [r][n] tile
      uint32_t b[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4_trans(b[j], &Bs[k0 + (mj & 1) * 8 + mr]
                                   [wn + j * 16 + (mj >> 1) * 8]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint32_t bt[2] = {b[t >> 1][(t & 1) * 2],
                                  b[t >> 1][(t & 1) * 2 + 1]};
          mma(c[i][t], a[i], bt, __nv_bfloat16());
        }
    }
    __syncthreads();
  }
  float* o = out + (size_t)s * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + i * 16 + g8 + (e >> 1) * 8;
        const int n = n0 + wn + t * 8 + tq * 2 + (e & 1);
        if (m < M && n < N) o[(size_t)m * N + n] = c[i][t][e];
      }
}

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

template <typename TX, typename TG>
cudaError_t rows_kernel_ready(int C, int* per_sm) {
  const size_t smem = rows_smem_bytes(C);
  auto kernel = mlp_bwd_rows_kernel<TX, TG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                         kBThreads, smem);
  return cudaSuccess;
}

template <typename F>
cudaError_t with_types(int x_bf16, int g_bf16, F f) {
  using BF = __nv_bfloat16;
  if (x_bf16) return g_bf16 ? f(BF(), BF()) : f(BF(), float());
  return g_bf16 ? f(float(), BF()) : f(float(), float());
}

int gemm_splits(int R, int M, int N, int sms) {
  const int tiles = ((N + kGN - 1) / kGN) * ((M + kGM - 1) / kGM);
  int s = (4 * sms + tiles - 1) / tiles;
  const int max_s = (R + 255) / 256;  // at least 256 rows a chunk
  return s < 1 ? 1 : (s > max_s ? (max_s < 1 ? 1 : max_s) : s);
}

int rows_per_split(int R, int S) {
  const int per = (R + S - 1) / S;
  return (per + kGK - 1) / kGK * kGK;
}

cudaError_t launch_gemm_tn(const __nv_bfloat16* A, const __nv_bfloat16* B,
                           float* out, float* ws, int R, int M, int N, int S,
                           cudaStream_t stream) {
  const int per = rows_per_split(R, S);
  const dim3 grid((N + kGN - 1) / kGN, (M + kGM - 1) / kGM, S);
  gemm_tn_kernel<<<grid, kGThreads, 0, stream>>>(A, B, S == 1 ? out : ws, R,
                                                 M, N, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  sum_splits_kernel<<<256, 256, 0, stream>>>(ws, out, S, M * N);
  return cudaGetLastError();
}

}  // namespace cpt

// Sizes the caller allocates: the grid of (a) (one partial row of 7C floats
// per CTA) and the row split of (b) (a workspace of S * C * 4C floats when
// S > 1).
extern "C" int cpt_fused_mlp_bwd_plan(int R, int C, int x_bf16, int g_bf16,
                                      int* grid_rows, int* splits) {
  if (C % 32 != 0 || R <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cpt::with_types(x_bf16, g_bf16, [&](auto tx, auto tg) {
      return cpt::rows_kernel_ready<decltype(tx), decltype(tg)>(C, &per_sm);
    });
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int ntiles = (R + cpt::kBTM - 1) / cpt::kBTM;
  *grid_rows = ntiles < per_sm * sms ? ntiles : per_sm * sms;
  *splits = cpt::gemm_splits(R, 4 * C, C, sms);
  return 0;
}

extern "C" int cpt_fused_mlp_bwd(
    const void* x, const void* g, void* dx, int x_bf16, int g_bf16, int R,
    int C, const float* lns, const float* lnb, const void* w1,
    const void* w1t, const void* w2t, const float* b1, const float* gamma,
    float eps, void* nb, void* gb, void* ab, void* dhb, float* part,
    int grid_rows, float* ws, int splits, float* dw1, float* dw2r,
    float* vec, void* stream) {
  using BF = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cpt::MlpBwdParams p;
  p.x = x; p.g = g; p.dx = dx; p.R = R; p.C = C;
  p.lns = lns; p.lnb = lnb;
  p.w1 = static_cast<const BF*>(w1);
  p.w1t = static_cast<const BF*>(w1t);
  p.w2t = static_cast<const BF*>(w2t);
  p.b1 = b1; p.gamma = gamma; p.eps = eps;
  p.nb = static_cast<BF*>(nb); p.gb = static_cast<BF*>(gb);
  p.ab = static_cast<BF*>(ab); p.dhb = static_cast<BF*>(dhb);
  p.part = part;
  // (a)
  cudaError_t err = cpt::with_types(x_bf16, g_bf16, [&](auto tx, auto tg) {
    using TX = decltype(tx);
    using TG = decltype(tg);
    cudaError_t e = cpt::rows_kernel_ready<TX, TG>(C, nullptr);
    if (e != cudaSuccess) return e;
    cpt::mlp_bwd_rows_kernel<TX, TG>
        <<<grid_rows, cpt::kBThreads, cpt::rows_smem_bytes(C), st>>>(p);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  // (b) dW1 [4C, C] = dh^T n;  dW2r [C, 4C] = g^T a
  err = cpt::launch_gemm_tn(p.dhb, p.nb, dw1, ws, R, 4 * C, C, splits, st);
  if (err != cudaSuccess) return (int)err;
  err = cpt::launch_gemm_tn(p.gb, p.ab, dw2r, ws, R, C, 4 * C, splits, st);
  if (err != cudaSuccess) return (int)err;
  // the CTAs' partial rows, in order
  cpt::sum_splits_kernel<<<(7 * C + 255) / 256, 256, 0, st>>>(
      part, vec, grid_rows, 7 * C);
  return (int)cudaGetLastError();
}
