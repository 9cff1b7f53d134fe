// Kernel A: one whole ConvNeXt block (see block.cuh for the design).
// Replaces count_pipnet_tpu/ops/pallas/fused_block.py:fused_block_apply_padded
// (:358) and :fused_block_apply (:499), with the bf16, int8-static and
// dynamic int8 bodies of both. Bound to Python with ctypes
// (count_pipnet_tpu_torch/ops/fused_block.py). ``mode``: 0 bf16, 1 int8
// with static scales, 2 int8 with dynamic per-row scales; ``dw_bf16``: the
// depthwise taps in bf16 (the TPU's tap_dtype=bfloat16) in any mode.
#include "block.cuh"

extern "C" int cpt_fused_block(
    const void* x, void* out, int dw_bf16, int x_bf16, int mode, int B,
    int H, int W, int C, const float* dwk, const float* dwb, const float* lns,
    const float* lnb, const void* w1, const float* s1, const float* b1,
    const float* i1, const void* w2, const float* s2, const float* b2,
    const float* i2, const float* g, float eps, void* stream) {
  const cpt::BlockParams p = cpt::make_block_params(
      x, out, B, H, W, C, dwk, dwb, lns, lnb, w1, s1, b1, i1, w2, s2, b2, i2,
      g, eps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dw_bf16 ? cpt::launch_fused_block<false, true>(p, x_bf16,
                                                              mode, st)
                       : cpt::launch_fused_block<false>(p, x_bf16, mode, st));
}
