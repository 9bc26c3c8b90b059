"""ResDepth refinement on PyTorch and CUDA: the port of ``resdepth_tpu``.

The JAX package beside it stays the reference; this package mirrors its
layout module by module and imports torch, numpy and scipy, never JAX and
nothing of ``resdepth_tpu``. The framework-free host layer is the port's
own copy of the JAX package's, at the same paths, changed only in its
imports.

Package map (each module names the JAX module it ports):
  config/         JSON schema, defaults, merge, the train and inference validators
  geo/, native/   GeoTIFF codec (C++ hot paths built with g++), grids, allocation
  data/           TileDataset, normalization, control files; batch assembly on the device
  models/         UNet (``nn.Module``), serving folds, weight readers
  ops/            kernels K1, K2 (stitch) and K3 (conv) with their plain versions; blend weights
  csrc/           CUDA C++ sources of the kernels, built with nvcc at first use
  infer/          full-scene tiled inference with on-device stitching
  train/          loss, optimizers, steps, checkpoints, Trainer, schedulers, metrics, the train CLI
  evaluation/     masked residual statistics per pixel class
  utils/          logging, fs helpers, AttrDict, the synthetic demo city
  orchestration   run directories, allocation and dataset configuration for the CLIs
  predict         the inference CLI, the port of ``test.py``
"""

__version__ = "0.1.0"
