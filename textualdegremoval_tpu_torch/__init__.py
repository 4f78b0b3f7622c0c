"""PyTorch/CUDA port of textualdegremoval_tpu.

The JAX package `textualdegremoval_tpu` is the reference; every module here
keeps its counterpart's relative path and names.  The first slice covers the
guided-restoration evaluation path of `RestormerRefFusion`, with the whole
TransformerBlock forward as a hand-written CUDA kernel
(`csrc/tblock.cu`, wrapped by `ops/pallas/tblock.py`).

Importing this package never imports jax or flax.
"""
