// K5: the ConvNeXt block body after the depthwise conv, for training
//
//   out = residual + gamma * (gelu_tanh(LN(x) @ W1^T + b1) @ W2^T + b2)
//
// on [R, C] rows (x and the residual f32 or bf16, bf16 GEMM operands with
// f32 accumulation, out in the residual's type). Replaces
// count_pipnet_tpu/ops/pallas/fused_mlp.py:fused_ln_mlp_residual (:57).
//
// It is kernel A's device code (block.cuh) with DW = false: a CTA owns 32
// rows, keeps their LayerNorm output in shared memory and walks the 4C
// hidden dimension in chunks of 128, so the hidden activation never
// reaches device memory - what the TPU kernel keeps in VMEM. Bound, like
// kernel A, by the two GEMMs (4 * R * C * 4C flops per call). Bound to
// Python with ctypes (count_pipnet_tpu_torch/ops/fused_mlp.py).
#include "block.cuh"

namespace cpt {

// K5: LayerNorm -> MLP -> * gamma + residual on [R, C] rows, bf16 GEMMs.
// x and the residual are each f32 or bf16; the output has the residual's
// type.
static cudaError_t launch_fused_mlp(const BlockParams& p, int x_bf16,
                                    int res_bf16, cudaStream_t stream) {
  if (p.C % 32 != 0) return cudaErrorInvalidValue;
  const int total = p.B * p.H * p.W;
  const dim3 grid((total + kTM - 1) / kTM);
  const size_t smem = block_smem_bytes<kQBf16>(p.C);
  auto go = [&](auto kernel) -> cudaError_t {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  };
  using BF = __nv_bfloat16;
  if (x_bf16) {
    return res_bf16 ? go(fused_block_kernel<BF, kQBf16, false, false, BF>)
                    : go(fused_block_kernel<BF, kQBf16, false, false, float>);
  }
  return res_bf16 ? go(fused_block_kernel<float, kQBf16, false, false, BF>)
                  : go(fused_block_kernel<float, kQBf16, false, false, float>);
}

}  // namespace cpt

extern "C" int cpt_fused_mlp(const void* x, const void* res, void* out,
                             int x_bf16, int res_bf16, int R, int C,
                             const float* lns, const float* lnb,
                             const void* w1, const float* b1, const void* w2,
                             const float* b2, const float* g, float eps,
                             void* stream) {
  cpt::BlockParams p = cpt::make_block_params(
      x, out, R, 1, 1, C, nullptr, nullptr, lns, lnb, w1, nullptr, b1,
      nullptr, w2, nullptr, b2, nullptr, g, eps);
  p.res = res;
  return (int)cpt::launch_fused_mlp(p, x_bf16, res_bf16,
                                    static_cast<cudaStream_t>(stream));
}
