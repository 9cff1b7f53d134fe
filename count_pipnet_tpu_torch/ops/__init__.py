"""Ops of the port: Gumbel-softmax, the count STEs and the CUDA kernels'
wrappers (``fused_block``, ``gumbel_head``) with their plain versions."""
