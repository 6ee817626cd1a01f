"""vae_posterior_consistency_tpu_torch: the PyTorch/CUDA port of
vae_posterior_consistency_tpu for NVIDIA Hopper (H100).

Module names mirror the JAX package (config, ops/, nn/, models/, engine/,
data/) so each module's counterpart is easy to find. Parameters are nested
dicts of tensors in the JAX layout; devices and random generators are always
explicit. Entry points default to device="cuda" and raise without CUDA; an
explicit device="cpu" runs the plain PyTorch versions of the kernels.

The hand-written CUDA kernels live in csrc/ and are built with nvcc at first
use (ops/_build.py).
"""
