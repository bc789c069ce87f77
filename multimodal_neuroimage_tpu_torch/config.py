"""The run configuration, shared with the JAX package: its ``config`` module
imports neither jax nor flax, so the port uses the same ``Config``."""

from multimodal_neuroimage_tpu.config import Config  # noqa: F401
