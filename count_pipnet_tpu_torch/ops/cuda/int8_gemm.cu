// K10: a GEMM with dynamic per-row int8 activations and per-column int8
// weights,
//
//   out[m, n] = (sum_k q(x)[m, k] * wq[n, k]) * ascale[m] * wscale[n] + b[n]
//
// with q(x) = round(x / ascale), ascale = max(max_k |x[m, k]|, 1e-9) / 127,
// int32 sums and an f32 epilogue cast to the output type. Replaces
// count_pipnet_tpu/ops/pallas/int8_gemm.py:int8_quant_gemm (:47), which the
// JAX package runs on the 2x2 im2col of the wide stride-1 downsample convs
// (models/quantized.py:286-302). Bound to Python with ctypes
// (count_pipnet_tpu_torch/ops/int8_gemm.py).
//
// What bounds it on Hopper: reading x once (M K bf16) and writing out, and
// 2 M K N int8 operations; at the downsample shapes (K = 768 -> N = 384,
// K = 1536 -> N = 768) the bytes, the operations close behind. Two launches:
//   a. quant_rows_kernel: one warp a row (four rows a warp, their 16-byte
//      loads all in flight first) takes the row's abs-max, row_scale, and
//      quantizes -> xq [M, K] int8 and asc [M] f32 (scratch). The
//      quantization is quant_row's, value for value, with the division
//      only where it can matter (Raw8::quant).
//   b. the s8 mode of sm90.cuh's TMA-fed wgmma core, xq . wq^T with exact
//      s32 sums, and the epilogue RowScaleBias8: acc * ascale * wscale + b
//      in f32, each step rounded on its own (no fused multiply-add, as the
//      plain version computes it), stored in the output type. Tile <128, 3,
//      2> at both shapes (scripts/k10_tiles.py times the candidates).
// The int8 copy of x goes through device memory (M K bytes each way), which
// the TPU kernel avoids by quantizing in VMEM. A one-launch design with each
// CTA's quantized rows resident in shared memory (in the layout of the
// core's 128-byte-swizzle descriptors) and a TMA ring of weight tiles was
// built and timed (PERF.md, section 6): its quantize phase could not run
// under the product, and it was no faster, so it was not kept.
#include "common.cuh"
#include "sm90.cuh"

namespace cpt {
namespace {

template <typename T>
struct Raw8;

// The eight values of ``r`` quantized with quant_row (IEEE divisions): out
// of line, as values near a tie are rare.
template <typename T>
__device__ __noinline__ uint2 quant8_div(const Raw8<T> r, float scale) {
  float v[8];
  r.get(v);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i / 4] |= (uint32_t)(uint8_t)quant_row(v[i], scale) << (8 * (i % 4));
  return make_uint2(w[0], w[1]);
}

// Eight adjacent values of a row as loaded: 16 bytes of bf16, 32 of f32.
template <typename T>
struct Raw8 {
  uint4 u[sizeof(T) / 2];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < (int)(sizeof(T) / 2); ++i)
      u[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  }
  __device__ __forceinline__ void get(float (&v)[8]) const {
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(b[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    } else {
      const float* f = reinterpret_cast<const float*>(u);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = f[i];
    }
  }
  // the largest |value| of the eight (a tree, not a chain; bf16 pairs
  // compared packed: the maximum is one of the values, exactly)
  __device__ __forceinline__ float amax() const {
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(u);
      const __nv_bfloat162 m = __hmax2(__hmax2(__habs2(b[0]), __habs2(b[1])),
                                       __hmax2(__habs2(b[2]), __habs2(b[3])));
      return fmaxf(__low2float(m), __high2float(m));
    } else {
      float v[8];
      get(v);
#pragma unroll
      for (int w = 4; w > 0; w /= 2)
#pragma unroll
        for (int i = 0; i < w; ++i)
          v[i] = fmaxf(fabsf(v[i]), fabsf(v[i + w]));
      return v[0];
    }
  }
  // The eight values quantized with ``inv``, the row scale's reciprocal to
  // within 2^-22 relative (__fdividef), as int8 bytes in order: round(v *
  // inv) by adding 1.5 * 2^23 (the sum's low byte is the rounded value, half
  // to even). v * inv lies within 1.5 2^-22 |q| < 2^-14 of the IEEE quotient
  // q (|q| <= 127), so it rounds as quant_row does unless it lies within
  // 2^-14 of a half-integer; ``near``: one of the eight does, and quant8_div
  // decides.
  __device__ __forceinline__ uint2 quant(float inv, bool& near) const {
    constexpr float kMagic = 12582912.0f;
    float v[8];
    get(v);
    uint32_t t[8];
    near = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float y = __fmul_rn(v[i], inv);
      const float r = __fadd_rn(y, kMagic);
      near |= !(fabsf(__fsub_rn(y, __fsub_rn(r, kMagic))) <
                0.5f - 6.103515625e-05f);
      t[i] = __float_as_uint(r);
    }
    return make_uint2(__byte_perm(__byte_perm(t[0], t[1], 0x0040),
                                  __byte_perm(t[2], t[3], 0x0040), 0x5410),
                      __byte_perm(__byte_perm(t[4], t[5], 0x0040),
                                  __byte_perm(t[6], t[7], 0x0040), 0x5410));
  }
};

// Rows r0 .. r0 + n - 1 of x [M, K] (all below M), quantized by one warp
// into xq [M, K] and asc [M]. NCH > 0: K <= 256 NCH, RP rows at a time,
// their 16-byte loads all in flight before the first abs-max, the values
// kept in registers between the two passes; a row's arithmetic is one
// straight run (NCH chunks of eight values side by side), the values near a
// tie fixed after it. NCH = 0: any K, a row at a time, read twice.
template <typename T, int NCH, int RP>
__device__ __forceinline__ void quantize_rows(const T* __restrict__ x, int K,
                                              int r0, int n, int8_t* xq,
                                              float* asc) {
  const int lane = threadIdx.x % 32;
  if constexpr (NCH > 0) {
    for (int g = 0; g < n; g += RP) {
      Raw8<T> v[RP][NCH];
#pragma unroll
      for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int k = 8 * (lane + 32 * c);
          if (g + i < n && k < K)
            v[i][c].load(x + (size_t)(r0 + g + i) * K + k);
        }
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        if (g + i >= n) break;
        const int r = r0 + g + i;
        float m = 0.0f;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          if (8 * (lane + 32 * c) < K) m = fmaxf(m, v[i][c].amax());
        const float sc = row_scale(warp_max(m));
        const float inv = __fdividef(1.0f, sc);
        uint2 q[NCH];
        unsigned slow = 0;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          bool near;
          q[c] = v[i][c].quant(inv, near);
          slow |= (unsigned)near << c;
        }
        if (slow != 0) {
#pragma unroll
          for (int c = 0; c < NCH; ++c)
            if ((slow >> c) & 1) q[c] = quant8_div(v[i][c], sc);
        }
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int k = 8 * (lane + 32 * c);
          if (k < K) *reinterpret_cast<uint2*>(xq + (size_t)r * K + k) = q[c];
        }
        if (lane == 0) asc[r] = sc;
      }
    }
  } else {
    for (int r = r0; r < r0 + n; ++r) {
      const T* xr = x + (size_t)r * K;
      float m = 0.0f;
      for (int k = 8 * lane; k < K; k += 256) {
        Raw8<T> v;
        v.load(xr + k);
        m = fmaxf(m, v.amax());
      }
      const float sc = row_scale(warp_max(m));
      const float inv = __fdividef(1.0f, sc);
      for (int k = 8 * lane; k < K; k += 256) {
        Raw8<T> v;
        v.load(xr + k);
        bool near;
        uint2 q = v.quant(inv, near);
        if (near) q = quant8_div(v, sc);
        *reinterpret_cast<uint2*>(xq + (size_t)r * K + k) = q;
      }
      if (lane == 0) asc[r] = sc;
    }
  }
}

// a. four rows a warp, eight warps a CTA. K in (512, 768] and (1280, 1536]
// (the downsamples' 768 and 1536) keep about 48 registers of a thread's
// values in flight (4 or 2 rows of bf16 at a time, 2 or 1 of f32); other K
// take the two-read path.
constexpr int kRowsWarp = 4;

template <typename T, int NCH>
__host__ __device__ constexpr int rows_at_once() {
  return 48 / (NCH * 2 * (int)sizeof(T)) < 1 ? 1
                                              : 48 / (NCH * 2 * (int)sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(256)
    quant_rows_kernel(const T* __restrict__ x, int8_t* xq, float* asc, int M,
                      int K) {
  const int r0 = (blockIdx.x * 8 + threadIdx.x / 32) * kRowsWarp;
  const int n = M - r0 < kRowsWarp ? M - r0 : kRowsWarp;
  switch ((K + 255) / 256) {
    case 3:
      quantize_rows<T, 3, rows_at_once<T, 3>()>(x, K, r0, n, xq, asc);
      break;
    case 6:
      quantize_rows<T, 6, rows_at_once<T, 6>()>(x, K, r0, n, xq, asc);
      break;
    default:
      quantize_rows<T, 0, 1>(x, K, r0, n, xq, asc);
  }
}

cudaError_t quant_rows(const void* x, int x_bf16, int8_t* xq, float* asc,
                       int M, int K, cudaStream_t st) {
  const dim3 grid((M + 8 * kRowsWarp - 1) / (8 * kRowsWarp));
  if (x_bf16)
    quant_rows_kernel<<<grid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), xq, asc, M, K);
  else
    quant_rows_kernel<<<grid, 256, 0, st>>>(static_cast<const float*>(x), xq,
                                           asc, M, K);
  return cudaGetLastError();
}

// b. the epilogue, in the plain version's order: eight adjacent columns of
// row r
__device__ __forceinline__ float dequant(int acc, float asc, float ws,
                                         float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), asc), ws), b);
}

template <typename TO>
struct RowScaleBias8 {
  const float* asc;
  const float* ws;
  const float* b;
  TO* out;
  int N;
  __device__ __forceinline__ void operator()(int r, int c,
                                             const int (&v)[8]) const {
    float w[8], bb[8], o[8];
    load8(ws + c, w);
    load8(b + c, bb);
    const float a = asc[r];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = dequant(v[i], a, w[i], bb[i]);
    store8(out + (size_t)r * N + c, o);
  }
};

// The GEMM's tiles <BN, STAGES, CTAs an SM> by ``tile``: 1-5 the candidates
// (scripts/k10_tiles.py), 0 the one K10 takes.
constexpr int kTiles = 5;

template <typename TO>
cudaError_t rowscale_gemm_as(const int8_t* xq, const float* asc,
                             const int8_t* wq, const float* ws,
                             const float* bias, TO* out, int M, int K, int N,
                             int tile, cudaStream_t st) {
  using E = RowScaleBias8<TO>;
  using I8 = int8_t;
  const E epi{asc, ws, bias, out, N};
  switch (tile) {
    case 0:
    case 1: return sm90::gemm<128, 3, 2, E, I8>(xq, wq, M, N, K, epi, st);
    case 2: return sm90::gemm<256, 4, 1, E, I8>(xq, wq, M, N, K, epi, st);
    case 3: return sm90::gemm<192, 3, 1, E, I8>(xq, wq, M, N, K, epi, st);
    case 4: return sm90::gemm<96, 3, 2, E, I8>(xq, wq, M, N, K, epi, st);
    case 5: return sm90::gemm<64, 4, 2, E, I8>(xq, wq, M, N, K, epi, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t rowscale_gemm(const int8_t* xq, const float* asc,
                          const int8_t* wq, const float* ws, const float* bias,
                          void* out, int out_bf16, int M, int K, int N,
                          int tile, cudaStream_t st) {
  if (out_bf16)
    return rowscale_gemm_as(xq, asc, wq, ws, bias,
                            static_cast<__nv_bfloat16*>(out), M, K, N, tile,
                            st);
  return rowscale_gemm_as(xq, asc, wq, ws, bias, static_cast<float*>(out), M,
                          K, N, tile, st);
}

bool valid(int M, int K, int N) {
  return M > 0 && K > 0 && N > 0 && K % 32 == 0 && N % 16 == 0;
}

}  // namespace
}  // namespace cpt

// K10: x [M, K] (bf16 if x_bf16, else f32), wq [N, K] int8, ws and bias [N]
// f32, out [M, N] (bf16 if out_bf16, else f32); xq [M, K] int8 and asc [M]
// f32 scratch. x, wq and xq 16-byte aligned, K % 32 == 0, N % 16 == 0.
extern "C" int cpt_int8_quant_gemm(const void* x, int x_bf16,
                                   const int8_t* wq, const float* ws,
                                   const float* bias, void* out, int out_bf16,
                                   int8_t* xq, float* asc, int M, int K,
                                   int N, void* stream) {
  if (!cpt::valid(M, K, N)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cpt::quant_rows(x, x_bf16, xq, asc, M, K, st);
  if (err == cudaSuccess)
    err = cpt::rowscale_gemm(xq, asc, wq, ws, bias, out, out_bf16, M, K, N, 0,
                             st);
  return (int)err;
}

// K10's launches on their own, to hold and time each: a. the row quantize
// pass, b. the GEMM (``tile``: 0 K10's, 1-5 a candidate).
extern "C" int cpt_int8_quant_rows(const void* x, int x_bf16, int8_t* xq,
                                   float* asc, int M, int K, void* stream) {
  if (!cpt::valid(M, K, 16)) return (int)cudaErrorInvalidValue;
  return (int)cpt::quant_rows(x, x_bf16, xq, asc, M, K,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int cpt_int8_rowscale_gemm(const int8_t* xq, const float* asc,
                                      const int8_t* wq, const float* ws,
                                      const float* bias, void* out,
                                      int out_bf16, int M, int K, int N,
                                      int tile, void* stream) {
  if (!cpt::valid(M, K, N) || tile < 0 || tile > cpt::kTiles)
    return (int)cudaErrorInvalidValue;
  return (int)cpt::rowscale_gemm(xq, asc, wq, ws, bias, out, out_bf16, M, K,
                                 N, tile, static_cast<cudaStream_t>(stream));
}
