"""PyTorch/CUDA port of textualdegremoval_tpu.

The JAX package `textualdegremoval_tpu` is the reference; every module here
keeps its counterpart's relative path and names.  It covers the
guided-restoration evaluation and training of `RestormerRefFusion` and
`NAFNetRefFusion`, and pipeline A's reference generation
(`diffusion/pipeline.py`, `cli/generate_reference.py`).  The TPU kernels
on those paths are hand-written CUDA kernels under `csrc/`, each wrapped
beside its plain PyTorch version (`ops/pallas/`, `ops/flash_attn.py`).

Importing this package never imports jax or flax.
"""

from textualdegremoval_tpu_torch.version import __version__

__all__ = ["__version__"]
