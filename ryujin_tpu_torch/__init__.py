"""ryujin_tpu_torch: the PyTorch / CUDA port of ryujin_tpu.

The JAX package `ryujin_tpu` stays the reference.  This package imports
torch and never jax; it reuses the numpy host layer of ryujin_tpu
(`ryujin_tpu.offline`, `ryujin_tpu.native`) for meshes, assembly and
canvas packing, and ports everything from the stencil upward.  The hot
path on a CUDA device runs hand-written kernels (csrc/, built with nvcc at
first use by kernels/build.py); CPU tensors run their plain-torch
references.
"""
