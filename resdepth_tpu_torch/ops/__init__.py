"""Kernels K1, K2 (the scene stitch) and K3 (the fused 3x3 conv): hand-written
CUDA kernels, their plain versions and the nvcc build; blend weights."""
