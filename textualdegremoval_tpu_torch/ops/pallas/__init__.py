"""Hand-written kernels of the port, each beside its plain PyTorch version.

The subpackage keeps the JAX package's name (ops/pallas) so that every
kernel's wrapper sits at the same relative path as the TPU kernel it
replaces; the kernels themselves are CUDA C++ under csrc/.
"""
