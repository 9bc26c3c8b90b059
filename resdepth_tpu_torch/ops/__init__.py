"""The scene stitch: hand-written CUDA kernels and their plain twin."""
