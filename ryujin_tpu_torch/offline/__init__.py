"""The port's own offline (host, numpy) layer: meshes, geometry, ansatz
lattices, assembly and structured-canvas packing, copied from
ryujin_tpu/offline under the same module names."""
