"""Count-PIPNet in PyTorch with hand-written Hopper kernels.

The port of ``count_pipnet_tpu`` (JAX/Pallas on a TPU) to PyTorch and CUDA
on an NVIDIA H100. This package imports ``torch`` and never ``jax``: the
JAX package stays the reference it is tested against. File names mirror
the JAX package's; the public interface keeps its NHWC layout
([B, H, W, 3] images in, [B, H, W, P] maps and [B, P] counts out).

It covers the gumbel-hard and softmax Count-PIPNet serving paths
(``models/serving.py``, ``serving/engine.py``) and the training of a
Count-PIPNet or a PIP-Net (``python -m count_pipnet_tpu_torch.main``,
``train/``), with the flagship configs' routes on the hand-written kernels
(``--fused_blocks``, ``--fused_whole_blocks``, ``--fused_dwconv``), the
two views made on the device (``--device_augment``,
``--device_geometric``), data parallelism over several devices
(``parallel/``: ``--mesh_shape``, sharded serving, ``dryrun.py``), the
native batch assembler (``native/``), the interpretability suite
(``interpret/``, ``--interpret``), the sweep runner
(``run_multiple_configs``), the notebooks that read runs
(``notebooks/``) and the synthetic dataset generators
(``data/generate_*.py``); ROADMAP.md lists what is left.
"""
