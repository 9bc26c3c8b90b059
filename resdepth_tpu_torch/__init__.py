"""ResDepth refinement on PyTorch and CUDA: the port of ``resdepth_tpu``.

The JAX package beside it stays the reference; this package mirrors its
layout module by module and imports only torch, numpy and the JAX-free host
layer of ``resdepth_tpu`` (config validators, GeoTIFF codec, grids and
allocation, ``TileDataset``, blend weights, evaluation).

Package map (each module names the JAX module it ports):
  models/   eval-mode UNet (``nn.Module``), serving folds, weight readers
  data/     inference batch assembly on the device
  ops/      the scene stitch: hand-written CUDA kernels and their plain twin
  csrc/     CUDA C++ sources of the kernels, built with nvcc at first use
  infer/    full-scene tiled inference with on-device stitching
  predict   the inference CLI, the port of ``test.py``
"""

__version__ = "0.1.0"
