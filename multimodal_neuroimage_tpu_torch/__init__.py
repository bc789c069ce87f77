"""PyTorch + CUDA port of multimodal_neuroimage_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference. This package imports torch and
never jax or flax; it shares only the JAX-free ``multimodal_neuroimage_tpu.config``
and ``multimodal_neuroimage_tpu.data.filters`` host modules. Its kernels
(``csrc/``) are hand-written CUDA C++ for ``sm_90a``, built with nvcc at
first use; on CPU tensors every kernel wrapper runs its plain PyTorch version.
"""
