"""ryujin_tpu_torch: the PyTorch / CUDA port of ryujin_tpu.

The JAX package `ryujin_tpu` stays the reference.  This package imports
torch and never jax, and nothing of `ryujin_tpu`: meshes, assembly and
canvas packing come from its own numpy host layer (`offline/`, with the
g++ helpers of `native/`), copied from the reference under the same
module names.  The hot path on a CUDA device runs hand-written kernels
(csrc/, built with nvcc at first use by kernels/build.py); CPU tensors run
their plain-torch references.
"""
