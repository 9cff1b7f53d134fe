"""Ops of the port: Gumbel-softmax, the count STEs and the CUDA kernels'
wrappers (``fused_block``, ``gumbel_head``, ``fused_head``, ``int8_gemm``,
``fused_mlp``, ``fused_mlp_bwd``, ``dwconv``, ``dwconv_bwd``) with their
plain versions."""
