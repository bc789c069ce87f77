"""PyTorch + CUDA port of multimodal_neuroimage_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference. This package imports torch and
never jax, flax or anything of the JAX package: what it needs of the JAX
package's host modules (``config``, ``data/filters``) it keeps as its own
copies, which the tests hold equal to the originals. Its kernels (``csrc/``)
are hand-written CUDA C++ for ``sm_90a``, built with nvcc at first use; on
CPU tensors every kernel wrapper runs its plain PyTorch version.
"""
