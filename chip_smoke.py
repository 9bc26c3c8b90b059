#!/usr/bin/env python3
"""Check on one NVIDIA GPU that the PyTorch/CUDA port builds, runs and is right.

    python3 chip_smoke.py

Run it from the root of a checkout. It needs one CUDA card, builds the
kernels from ``resdepth_tpu_torch/csrc`` with nvcc and imports no JAX. It
drives the port's paths with the flagship ResDepth-stereo model (random
weights from a seed): full-scene refinement through the inference CLI
``python -m resdepth_tpu_torch.predict``, and training through the train
CLI ``python -m resdepth_tpu_torch.train``. Phases, each printing what it
found:

  1. device: the card, its power limit, the torch and CUDA versions;
  2. build: nvcc builds every kernel source at once and the libraries load;
  3. kernels: K1 and K2 against the plain stitch (K2 bitwise and run to
     run, K1 within 2 ulps, more where over 4 tiles meet) on the main
     path's batch 2 (128 tiles of 256 px on a 4096x4096 canvas), its padded
     last batch, every batch of a ragged 4001x3999 scene, and 300 tiles at
     random spots at T 16 and 128; times of K1, K2 (device time, from
     CUDA graphs) and the plain stitch at batch 2, and of K1 and K2 over
     every batch of the 4096x4096 scene (K2 with the main path's padding
     and with two others), each beside its bound (the bytes they must
     move);
  4. flagship: a seeded 4096x4096 geom-stereo scene (961 tiles) refined by
     the CLI with K1 and with K2, in float32 (TF32 off) and in bfloat16
     (whose trunk runs the epilogue kernel, ``ops/epilogue.py``, after each
     cuDNN conv, as the bf16 trunk of mixed and balanced16 does);
     the outputs exist and are finite, the launch counters show that every
     stitch went through the kernels, and the K1 and K2 scenes agree;
     "steady": the float32 and bfloat16 scene with rasters resident;
     "modes": the five string serving modes (mixed, fast32, act2pass,
     balanced, balanced16) on that scene through ``predict_linear_blend``:
     K3's launches by pass count (12/12/12/3/2 a forward for
     fast32/act2pass/balanced/balanced16/mixed, times the 8 batches),
     scene time, tiles/s, forward ms, peak memory, and the deviation from
     the float32 scene in cm; "streaming": the scene streamed in row bands
     (``predict_linear_blend_streaming``) under a budget of 1024 rows of
     its 3 raster planes: 5 bands of 217, 217, 217, 217 and 93 tiles,
     float32 with K2 and K1 and balanced16 (K3 in every band), each held
     against the resident scene (K2 bitwise, K1 within its bar), times,
     peak memory and the bytes a band puts on the card;
  5. card against CPU: a 512x512 crop refined on the card (K2, whose sum
     order is the plain stitch's) and on the CPU, float32 within 4 f32 ulps
     of the largest height (``CROP_ULPS``), held after a K1 and a bfloat16
     scene on the card that leave K2's array as it was and share no memory
     with it (each lands in pinned memory of its own), and each serving
     mode's UNet outputs on the crop's tiles, the mean |diff| within a
     share of its own deviation from float32 (``CROP_SHARES``) that every
     other compute dtype served on the card in its place misses; "modes-cli": one CLI run at ``compute_dtype:
     "balanced16"`` that writes its rasters;
  6. conv: kernel K3 (the SASS of its library must hold HGMMA and
     UTMALDG) at batch 128 at every 3x3 conv the served flagship hands it
     in the modes (``mode_k3_convs``, traced: one a block and the composed
     top's two) and at ragged shapes, in float32 at 3, 1 and 2 bf16 passes
     and in bfloat16 (each call on the kernel ``k3_variant`` routes it to),
     against the plain version on cuDNN, TF32 off; times of K3, the plain
     version, one ``F.conv2d`` (``library_ms``) and, at 3 passes, cuDNN
     with TF32 on, each beside K3's bound (its passes' operations); K3's
     time in one forward of each mode; then each float32 kernel alone
     (``phase_conv_variant``), in two layouts, bitwise across two launches:
     wide_f32 (the trunk) at the trunk's convs and ragged shapes; narrow
     (Cout <= 8) at the top's two convs and ragged narrow shapes; narrow_k
     (Cin <= 4, 8 < Cout <= 64) at encoder0, the last conv's dx in
     training, the channel modes' first convs and ragged shapes; the
     narrow ones timed beside wide_f32 on the same calls; and the layouts
     the served flagship hands each; "epilogue": the bf16 trunk's epilogue
     kernel bitwise the ATen ops it fuses at the 14 calls of a balanced16
     forward and at ragged ones, a forward both ways, small models
     (mixed, balanced16, bfloat16 input on float32 weights, bfloat16
     storage), and a 1024^2 scene served at mixed, balanced16 and
     bfloat16 storage with test-time augmentation, 14 launches a batch and
     rotation, the canvas bitwise the ATen ops'; "upconv": the float32
     decoder's upconv kernel (``ops/upconv.py``) at the four decoder levels
     of the served flagship (batch 128) and ragged shapes, at 1, 2 and 3
     passes, within 1e-4 of the largest |plain| value and bitwise across
     two launches, timed beside its plain version, cuDNN's float32
     transposed conv with the skip add and its byte bound; a balanced
     forward both ways; its launches (4 a batch at balanced, none on the
     balanced16, float32 and training paths); and the 4096^2 scene at
     balanced resident and streamed, bitwise equal;
  7. train: the flagship trained on a seeded 2048x2048 scene by the train
     CLI (tile 256, batch 20, augmentation, Adam with weight decay, StepLR,
     float32 with TF32 off) for 2 epochs, resumed from ``Model_last.npz``
     for a third, its ``Model_best.npz`` served by the inference CLI;
     "train-precisions": the train step at each training policy
     (``TRAIN_POLICIES``: float32 'high', 'default', 'balanced',
     'balanced16', bfloat16 compute) on that scene at batch 20: steady ms,
     samples/s, peak memory, K3's launches a step by pass count
     (``k3_launches_a_step``: its forward and dx of every f32 conv with a
     pass count) and its time a step; K3 against its plain version at every
     call shape the steps hand it; "train-balanced16": the train CLI for an
     epoch at 'balanced16', its ``Model_best.npz`` served; "profile": that
     epoch traced through ``tpu.profile_dir`` (``utils/profiler.py``)
     against its untraced twin (deterministic cuDNN): one ``train#N``
     annotation a step, as many K3 kernels in the trace as counted,
     ``Model_last.npz`` bitwise the twin's; then phase 7's float32 epoch
     traced; each step's device-busy ms and host gap from the traces;
     "streaming-cli": the inference CLI's over-budget branch on that scene
     (``predict.MAX_DEVICE_PIXELS`` lowered: 3 row bands, K2), held against
     the resident scene; "train-banded": the ``Trainer`` for an epoch under
     banded residency (``data/banded.py``) at a 1-D and a 2-D budget, float32
     'high' and 'balanced16', each against its fully resident twin (weights
     bitwise the twin's with deterministic cuDNN, one upload a window,
     nothing resident after; samples/s beside the twin's), and the train
     CLI for an epoch under ``tpu.max_device_pixels``;
  8. train card against CPU: one flagship train step on 2 tiles of 128 px
     on the card and on the CPU (which takes the card's max-pool and ReLU
     decisions, see ``phase_train_vs_cpu``) at each training policy: loss,
     gradients, BatchNorm statistics and Adam moments within 1e-4 relative
     per tensor for float32 'high'; for the policies that round operands to
     bf16, their BatchNorm statistics within a share of their own gap to
     the float32 step (``TRAIN_ROUNDED_SHARE``);
  9. studies and CLI cases (``resdepth_tpu_torch/studies``), every
     kernel call held to its plain version as it is made (``held_kernels``):
     "studies" writes ``precision_study``'s state cache and reads it back
     bitwise, runs its ``--attrib`` (K3 at 3 and 1 passes), the stride and
     TTA x stride studies on a 1024^2 city (K2 bitwise, K3 in
     'balanced16'), the bilinear study at 8 steps, the train-throughput
     study and ``train_roofline --measure`` at one mode and batch;
     "config-smoke" runs 3 cases of ``studies/config_smoke.py`` (seed 21:
     narrow models on 16- and 32-px tiles, so K3 at 4 and 8 output
     channels and 16-px images, K1 on 16-px windows) through the CLIs, then
     serves each again with K2;
 10. data parallelism (``parallel/``: one process per GPU): "dp-nccl-1"
     runs the train CLI (an epoch, 'balanced16') and the inference CLI in a
     world of one process over NCCL that ``RESDEPTH_DIST_*`` forms, each
     bitwise its run without a process group; "dp-2-on-1" starts two
     processes of ``chip_smoke.py --dp-rank PLAN`` that share the card over
     gloo: 5 flagship train steps at batch 20 (10 a rank) at 'high' and
     'balanced16' against one process (``_hold_dp_training``), the 4096^2
     scene tile-sharded with K1, K2 and K3 in both ranks, and scene-sharded
     against the streamed scene;
 11. "dryrun" (``resdepth_tpu_torch/graft_entry.py``, the port of
     ``__graft_entry__.py``): ``entry()``'s flagship forward on 4 tiles of
     256^2 timed on the card and held to the CPU forward within 1e-5 of the
     largest output, then ``dryrun_multichip(1)`` in a world of one over
     NCCL and ``dryrun_multichip(4, share_cards=True)``, four ranks on the
     card over gloo (all five legs: a DP train step at 'default', banded
     training over 2-D windows, tile-sharded inference at tta 1 and 4,
     scene-sharded inference, the 2x2 (dcn, ici) step), every rank a
     process of ``chip_smoke.py --dryrun-rank`` that runs the legs under
     ``held_kernels``: K3 at 1 pass in the train legs, K1 in the
     tile-sharded leg and K2 in the scene-sharded leg, each call held to its
     plain version, and each leg's launches counted.

``python3 chip_smoke.py --phase studies --phase config-smoke`` runs phases
1 and 2 and the phases named (also ``conv``, phase 6, ``epilogue``,
``upconv``, ``dryrun`` and ``crop``, phase 5's crop on the seeded scene),
and prints no result line.
``python3 chip_smoke.py --stitch-scene`` runs phase 1 and the stitch
kernels' times over the scene's batches alone, and prints no result line:
run in two checkouts in one call, it compares their stitches on one card.

Any failure raises and the script exits non-zero. Without CUDA, or outside a
checkout of the repository, it exits non-zero before printing a result. The
scene and the CLI's outputs go to ``build/chip_smoke/`` and are removed at
the end of a passing run. The last three lines of standard output are the
kernels' JSON record (K3 once per float32 pass count, with its launches on
the mode paths and the train steps and its times and bound over one
forward of each mode at that pass count, once for bfloat16, and each of its
narrow variants alone with its launches and its share of those times), the
card's name and power limit
as ``nvidia-smi`` prints them, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

REPO = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(REPO, "build", "chip_smoke")

SCENE_SIZE = 4096
CROP_SIZE = 512
TILE = 256
BATCH = 128
DSM_STD = 5.0
SEED = 0

# The TPU kernels the CUDA kernels replace (functions reaching pl.pallas_call).
KERNELS = {
    "k1": ("stitch_k1", "resdepth_tpu/ops/pallas_stitch.py:114"),
    "k2": ("stitch_k2", "resdepth_tpu/ops/pallas_stitch.py:213"),
}
KERNEL_SOURCE = "resdepth_tpu_torch/csrc/stitch.cu"
K3 = ("conv3x3_k3", "resdepth_tpu_torch/csrc/conv.cu",
      "resdepth_tpu/ops/pallas_conv.py:101")
# K3's device kernels, by name (the wide, wide_f32, narrow, narrow_k and
# narrow_bf16 kernels): one a launch
K3_KERNEL_NAMES = ("conv3x3_k3_kernel", "conv3x3_k3_wide_f32_kernel",
                   "conv3x3_k3_narrow_kernel", "conv3x3_k3_narrow_k_kernel",
                   "conv3x3_k3_narrow_bf16_kernel")
# K3's float32 kernels, as ``conv.k3_variant`` names them, each counted in
# ``conv.LAUNCHES["k3_<variant>"]``
K3_F32_VARIANTS = ("wide_f32", "narrow", "narrow_k")
# K3's kernels counted by name on every path: the float32 ones and
# narrow_bf16 (bfloat16 x with a pass count, the composed top on the bf16
# trunk), each in ``conv.LAUNCHES["k3_<variant>"]``
K3_COUNTED = (*K3_F32_VARIANTS, "narrow_bf16")

# Phase 6: K3 at batch 128 at the 3x3 convs the served flagship hands it
# in the serving modes (``mode_k3_convs``), in float32 at each pass count
# (3: the TPU's HIGH) and in bfloat16.
CONV_BATCH = 128
CONV_PASSES = (3, 1, 2)
# Ragged shapes (N, H, W, Cin, Cout, activation): pixel tiles past the
# image's edge, Cin padded to 16, Cout not a multiple of 8 or of 64.
CONV_RAGGED = ((1, 17, 23, 5, 7, "prelu"), (3, 40, 9, 16, 72, "lrelu"),
               (2, 20, 150, 80, 40, "none"))

# Phase 6, K3's narrow variant (float32, Cout <= 8): the composed top's
# convs at batch 128 as the served flagship hands them (``k3_cases``) and
# ragged narrow shapes (N, H, W, Cin, Cout, activation): Cout 1, 3 and 7,
# images off the variant's 16x32 tile, Cin 3, 5 and 80. Each in two
# layouts: the NHWC view of NCHW memory, as a conv after cuDNN hands it,
# and NHWC memory, as K3 writes it.
NARROW_RAGGED = ((2, 17, 23, 3, 1, "prelu"), (3, 40, 9, 5, 3, "lrelu"),
                 (1, 17, 23, 80, 7, "none"), (2, 40, 9, 80, 1, "prelu"))
NARROW_LAYOUTS = ("nchw", "nhwc")
# Phase 6, K3's wide_f32 kernel (float32, every call the narrow variants
# do not take): the trunk's convs as the served flagship hands them
# (``k3_cases``, batch 128) and ragged shapes (N, H, W, Cin, Cout,
# activation): Cin 5 (no TMA: 20-byte pixels) and 80 (a chunk of 64 and a
# ragged one), W 23 and 9 (off the 16-wide tile), Cout 9, 40 and 72 (off
# BN), 8 x 8 images two a tile at an odd batch, W 6 (8 x 16 tiles), batch
# 1. In both of ``NARROW_LAYOUTS``.
WIDE_F32_RAGGED = ((1, 17, 23, 5, 9, "prelu"), (2, 20, 150, 80, 40, "none"),
                   (3, 40, 9, 16, 72, "lrelu"), (3, 8, 8, 512, 512, "relu"),
                   (2, 12, 6, 64, 96, "lrelu"), (1, 16, 16, 24, 130, "none"))
# Phase 6, K3's narrow_k variant (float32, Cin <= 4, 8 < Cout <= 64):
# encoder0 as the served flagship hands it (``k3_cases``: batch 128, 256²,
# 3->64), and beside it (N, H, W, Cin, Cout, activation) the last conv's
# dx in training (batch 20, 256², 1->64, no activation), the channel
# modes' first convs (Cin 1, 2 and 4 -> 64 at batch 128) and ragged shapes:
# images off the variant's 16x32 block, Cout 24 and 40 (16-byte stores) and
# 13 (4-byte stores). In both of ``NARROW_LAYOUTS``.
NARROW_K_CASES = ((20, 256, 256, 1, 64, "none"), (128, 256, 256, 1, 64, "relu"),
                  (128, 256, 256, 2, 64, "relu"), (128, 256, 256, 4, 64, "relu"),
                  (3, 37, 45, 3, 24, "prelu"), (3, 37, 45, 1, 40, "lrelu"),
                  (2, 19, 21, 2, 13, "relu"))

# Phase "epilogue": the bf16 trunk's epilogue kernel (``ops/epilogue.py``)
# at the calls one balanced16 forward of the served flagship hands it at
# batch CONV_BATCH (``epilogue_calls``) and at ragged ones (kind, (N, C,
# H, W), act_fn, pool), kind "block" (bf16 y), "cast" (f32 y) or "skip":
# odd H and W (the pool's floor), C not a multiple of 8 (one channel a
# thread), every activation. Every input holds NaN, +-inf and -0.0.
EPILOGUE_RAGGED = (("block", (2, 24, 7, 9), "prelu", True),
                   ("block", (3, 16, 5, 6), "lrelu", True),
                   ("block", (1, 7, 9, 11), "relu", True),
                   ("block", (2, 12, 6, 4), "none", False),
                   ("block", (2, 8, 4, 4), "relu", False),
                   ("cast", (2, 24, 7, 9), "none", True),
                   ("cast", (1, 5, 3, 5), "none", True),
                   ("skip", (2, 12, 5, 7), "none", False),
                   ("skip", (2, 16, 6, 6), "none", False))
# The scene served with test-time augmentation (``predict_linear_blend``,
# 49 tiles in batches of EPILOGUE_SCENE_BATCH; each rotated batch reaches
# the forward as a transposed view), through K2 so that the canvas can be
# held bitwise to the one the ATen ops give, at each (compute_dtype, tta)
# of EPILOGUE_TTA: a serving mode, or bfloat16 storage.
EPILOGUE_SCENE, EPILOGUE_SCENE_BATCH = 1024, 16
EPILOGUE_TTA = (("mixed", 4), ("mixed", 8), ("balanced16", 8), (torch.bfloat16, 1),
                (torch.bfloat16, 8))
# Small models whose forwards hold the kernel to the ATen ops bitwise in
# every path that reaches it: depth 3, start 4 (widths 4, 8, 16: one
# channel a thread at 4), PReLU encoders and LeakyReLU decoders, in both
# up modes, folded and not (BatchNorm before the epilogue), at mixed,
# balanced16, bfloat16 input on float32 weights and bfloat16 storage, 4
# tiles of 64.
EPILOGUE_MODELS = tuple((up_mode, folded) for up_mode in ("transpose", "bilinear")
                        for folded in (True, False))

# Phase "upconv": the float32 decoder's upconv kernel (``ops/upconv.py``)
# at the four decoder levels of the served flagship, batch CONV_BATCH (x's
# (H, W, Cin, Cout): 8² 512->512 up to 64² 128->128), and at ragged (N, H,
# W, Cin, Cout): pixels off the kernel's 64-pixel items, Cin off its
# 64-channel chunks and not a multiple of 4 (x by cp.async), Cout not a
# multiple of 4 (4-byte stores), B's 4 Cout rows off its 256-row blocks;
# each at 1, 2 and 3 passes, within UPCONV_BAR of the largest |plain| value.
UPCONV_LEVELS = ((8, 8, 512, 512), (16, 16, 512, 512), (32, 32, 256, 256),
                 (64, 64, 128, 128))
UPCONV_RAGGED = ((3, 5, 7, 24, 40), (2, 9, 11, 13, 7), (1, 3, 3, 70, 132), (2, 6, 10, 64, 12))
UPCONV_BAR = 1e-4

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
# memory bytes/s and bf16 tensor-core FLOP/s, for the kernels' bounds.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12

# Phase 7: training on a seeded scene at the flagship's width.
TRAIN_SCENE = 2048
TRAIN_BATCH = 20
TRAIN_SAMPLES = 200          # 10 steps an epoch
TRAIN_WARMUP = 3             # steps before the steady-state timing

# Phase "train-precisions": the train step at each training policy, as
# (tpu.train_precision, tpu.compute_dtype); "bfloat16" is bf16 compute at
# train_precision 'high' (one native pass a conv, as on the TPU).
TRAIN_POLICIES = {"high": ("high", "float32"), "default": ("default", "float32"),
                  "balanced": ("balanced", "float32"),
                  "balanced16": ("balanced16", "float32"),
                  "bfloat16": ("high", "bfloat16")}
TRAIN_STEPS = 13             # steps a policy, the first TRAIN_WARMUP untimed
# Phase 8's bar for every policy that rounds operands to bf16 (all but
# float32 'high', which holds 1e-4 per tensor), card against CPU: the
# relative L2 of the batch's BatchNorm statistics (all layers) as a share
# of the policy's own gap to the float32 step on the card. Where the two
# devices sum in another order, an activation near a bf16 rounding
# boundary rounds the other way (its bf16 pass operand or its bf16 trunk
# value), and a step on two tiles carries each such place far: measured
# default 0.18, balanced 0.22, balanced16 0.43, bfloat16 0.40 (the float32
# step in their place 1.0), so 0.7. Their gradients' shares are printed
# beside it, unbarred (on the CPU
# alone, another memory layout of one pooled map moved balanced16's by
# 0.65 of their own gap).
TRAIN_ROUNDED_SHARE = 0.7


def k3_calls_a_forward(mode: str, depth: int = 5) -> dict:
    """K3 launches of one forward of a folded transpose-mode UNet of
    ``depth`` in a serving mode, by pass count: every 3x3 conv with a pass
    count. The f32-storage modes run all 2 depth + 2 of them on K3 (depth
    encoder blocks, the bottleneck, depth - 1 decoder blocks and the
    composed top's two convs), balanced with encoder0 and the top at 3
    passes; balanced16 runs encoder0 and the top's two at 3 passes; mixed
    the top's two at 1."""
    every = 2 * depth + 2
    return {"fast32": {1: every}, "act2pass": {2: every},
            "balanced": {1: every - 3, 3: 3}, "balanced16": {3: 3},
            "mixed": {1: 2}}[mode]


def k3_launches_a_step(policy: str, depth: int = 5) -> dict:
    """K3 launches of one train step of a transpose-mode UNet of ``depth``
    at a training policy (``tpu.train_precision``, or "bfloat16" for
    ``tpu.compute_dtype`` bfloat16), by pass count: the forward and the dx
    of every f32 3x3 conv with a pass count (depth encoder blocks, the
    bottleneck, depth - 1 decoder blocks and the last conv; the top is not
    composed in training), no dx for encoder0, whose input needs no
    gradient. balanced runs encoder0 and last at 3 passes; balanced16 only
    those two on float32 operands; bf16 compute and the IEEE policies none."""
    convs = 2 * depth + 1
    return {"default": {1: 2 * convs - 1}, "balanced": {1: 2 * convs - 4, 3: 3},
            "balanced16": {3: 3}, "bfloat16": {}, "high": {}, "highest": {}}[policy]


def _meta_forward(mode: str, config, batch: int, k3) -> list:
    """One forward of the served (folded) flagship (``config``, or the
    stereo flagship) in a serving mode at ``batch`` tiles of ``TILE``,
    traced through ``apply_unet`` on meta tensors with K3's wrapper swapped
    for ``k3``, and the epilogue's entries (``ops.epilogue``) and the
    upconv's (``ops.upconv``) for recorders that give outputs of the right
    shapes (nothing runs). Returns the
    epilogue calls in order as ``(kind, (N, C, H, W), act_fn, pool)``, kind
    "block", "cast" or "skip" (as ``EPILOGUE_RAGGED``)."""
    from unittest import mock

    from resdepth_tpu_torch.models import unet
    from resdepth_tpu_torch.ops import epilogue, upconv

    config = config or unet.flagship_config("geom-stereo")
    model = unet.UNet(dataclasses.replace(config, do_BN=False), "meta",
                      composed_top=config.up_mode == "transpose")
    calls = []

    def block(y, bias=None, slope=None, *, act_fn="none", pool=False):
        n, c, h, w = y.shape
        calls.append(("cast" if y.dtype == torch.float32 else "block", (n, c, h, w), act_fn,
                      pool))
        def nhwc(shape):          # NHWC memory, as the kernel writes it
            return torch.empty(shape, dtype=torch.bfloat16, device=y.device,
                               memory_format=torch.channels_last).zero_()

        return nhwc(y.shape), nhwc((n, c, h // 2, w // 2)) if pool else None

    def skip_add(u, bias, skip):
        calls.append(("skip", tuple(u.shape), "none", False))
        return torch.zeros_like(skip)

    x = torch.zeros((batch, TILE, TILE, config.n_input_channels), device="meta")
    with mock.patch.object(unet, "conv3x3_bias_act", k3), \
            mock.patch.object(epilogue, "trunk_epilogue", block), \
            mock.patch.object(epilogue, "skip_add_epilogue", skip_add), \
            mock.patch.object(upconv, "upconv2x2_skip",
                              lambda x, weight, bias, skip, passes: torch.zeros_like(skip)), \
            torch.inference_mode():
        unet.apply_unet(model, x, **unet.serving_precision(mode).apply_kwargs())
    return calls


def mode_k3_convs(mode: str, config=None) -> list:
    """The 3x3 convs one forward of the served (folded) flagship hands to
    ``conv3x3_bias_act`` in a serving mode, in order, as ``(H, Cin, Cout,
    act, passes)`` at tiles of ``TILE``: traced on meta tensors
    (``_meta_forward``), the wrapper swapped for a recorder."""
    calls = []

    def record(x, kernel, bias=None, act_param=None, *, act_fn="relu", passes=None):
        calls.append((x.shape[1], kernel.shape[2], kernel.shape[3], act_fn, passes))
        return x.new_zeros(x.shape[:3] + (kernel.shape[3],))

    _meta_forward(mode, config, 1, record)
    return calls


def k3_cases() -> dict:
    """Each distinct ``(H, Cin, Cout, act)`` the five modes' forwards hand
    K3, with its launches in one forward of each mode by pass count
    (``mode_k3_convs``); the pass counts add up to ``k3_calls_a_forward``."""
    from collections import Counter

    from resdepth_tpu_torch.models.unet import SERVING_PRECISION_MODES

    cases = {}
    for mode in SERVING_PRECISION_MODES:
        convs = mode_k3_convs(mode)
        if Counter(p for *_, p in convs) != k3_calls_a_forward(mode):
            raise AssertionError(f"{mode}: the traced forward hands K3 {convs}, "
                                 f"not {k3_calls_a_forward(mode)} by pass count")
        for *shape, p in convs:
            cases.setdefault(tuple(shape), {1: 0, 2: 0, 3: 0})[p] += 1
    order = [tuple(c[:4]) for c in mode_k3_convs("fast32")]   # every shape, in order
    return {shape: cases[shape] for shape in sorted(cases, key=order.index)}


def epilogue_calls(mode: str = "balanced16", config=None, batch: int = CONV_BATCH) -> list:
    """The calls one forward of the served (folded) flagship makes to
    ``ops.epilogue`` in a serving mode, in order, as ``(kind, (N, C, H, W),
    act_fn, pool)`` at ``batch`` tiles of ``TILE`` (``_meta_forward``)."""
    def k3(x, kernel, *args, **kwargs):
        return x.new_zeros(x.shape[:3] + (kernel.shape[3],))

    return _meta_forward(mode, config, batch, k3)


def log(phase: str, message: str) -> None:
    print(f"[chip_smoke] {phase}: {message}", flush=True)


# ------------------------- scene and model artifacts ------------------------- #

def write_scene(out_dir: str, rows: int, cols: int, seed: int = SEED) -> dict:
    """A seeded synthetic city (ground truth, noisy initial DSM, two
    hillshade ortho views, building and water masks) as uncompressed
    GeoTIFFs plus the image and pair lists. Returns the paths and the
    orthos' mean and standard deviation (the image normalisation)."""
    from resdepth_tpu_torch.geo import tiff
    from resdepth_tpu_torch.utils.synth import GSD, NODATA, hillshade, synth_city

    os.makedirs(out_dir, exist_ok=True)
    geotransform = (465000.0, GSD, 0.0, 5247000.0, 0.0, -GSD)
    gt, dsm, building, water = synth_city(rows, cols, seed=seed)
    orthos = [hillshade(gt, azimuth) for azimuth in (315, 135)]

    def write(name, data, nodata=NODATA):
        path = os.path.join(out_dir, name)
        tiff.write(path, data, geotransform=geotransform, nodata=nodata,
                   compress="none")
        return path

    paths = {"raster_gt": write("ground_truth_DSM.tif", gt),
             "raster_in": write("initial_DSM.tif", dsm),
             "mask_building": write("mask_building.tif", building, nodata=255),
             "mask_water": write("mask_water.tif", water, nodata=255)}
    images = [write(f"ortho_{i}.tif", ortho) for i, ortho in enumerate(orthos)]
    paths["path_image_list"] = os.path.join(out_dir, "imagelist.txt")
    with open(paths["path_image_list"], "w") as f:
        f.write("\n".join(images) + "\n")
    paths["path_pairlist"] = os.path.join(out_dir, "pairlist.txt")
    with open(paths["path_pairlist"], "w") as f:
        f.write("ortho_0, ortho_1\n")
    stacked = np.stack(orthos)
    return {"paths": paths, "image_mean": float(stacked.mean()),
            "image_std": float(stacked.std())}


def random_model(config, seed: int = SEED):
    """A UNet with seeded random weights and random BatchNorm statistics and
    affines, so that folding BatchNorm has work to do."""
    from torch import nn

    from resdepth_tpu_torch.models.unet import init_unet

    generator = torch.Generator().manual_seed(seed)
    model = init_unet(config, generator)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.BatchNorm2d):
                module.weight.uniform_(0.5, 1.5, generator=generator)
                module.bias.normal_(0.0, 0.1, generator=generator)
                module.running_mean.normal_(0.0, 0.1, generator=generator)
                module.running_var.uniform_(0.5, 2.0, generator=generator)
    return model


def write_model_artifacts(out_dir: str, config, input_channels: str,
                          image_mean: float, image_std: float,
                          seed: int = SEED) -> dict:
    """The three artifacts an inference config names: a reference-layout
    ``.pth`` checkpoint, ``model_config.json`` and the normalisation
    pickles, as ``train.py`` writes them."""
    from resdepth_tpu_torch.data import control_files

    os.makedirs(out_dir, exist_ok=True)
    weights = os.path.join(out_dir, "Model_best.pth")
    torch.save({"epoch": 0,
                "model_state_dict": random_model(config, seed).state_dict()},
               weights)
    architecture = os.path.join(out_dir, "model_config.json")
    with open(architecture, "w") as f:
        json.dump({"name": "ResDepth", "input_channels": input_channels,
                   "settings": dataclasses.asdict(config)}, f, indent=2)
    geom = os.path.join(out_dir, "DSM_normalization_parameters.p")
    control_files.write_normalization_params_to_file(geom, None, DSM_STD)
    image = os.path.join(out_dir, "Image_normalization_parameters.p")
    control_files.write_normalization_params_to_file(image, image_mean, image_std)
    return {"weights": weights, "architecture": architecture,
            "normalization_geom": geom, "normalization_image": image}


def write_config(path: str, scene_paths: dict, model: dict, out_dir: str,
                 **general) -> str:
    """An inference config over the whole scene ('entire' allocation)."""
    dataset = dict(name="smoke_city", allocation_strategy="entire", **scene_paths)
    with open(path, "w") as f:
        json.dump({"datasets": [dataset], "model": model, "general": general,
                   "output": {"directory": out_dir}}, f, indent=2)
    return path


def run_cli(config_path: str, device: str) -> float:
    """Run the inference CLI, ``python -m resdepth_tpu_torch.predict config
    --device DEVICE``, through its entry point in this process (so that the
    kernels' launch counters are visible here); returns the wall time in
    seconds."""
    from resdepth_tpu_torch import predict

    start = time.perf_counter()
    predict.main([config_path, "--device", device])
    return time.perf_counter() - start


def output_paths(out_dir: str) -> dict:
    pair_dir = os.path.join(out_dir, "smoke_city", "Stereopair_0_1")
    return {"prediction": os.path.join(pair_dir, "initial_DSM_prediction.tif"),
            "residuals": os.path.join(pair_dir, "initial_DSM_residuals.tif"),
            "statistics": os.path.join(pair_dir,
                                       "initial_DSM_prediction_statistics.txt")}


def write_train_config(path: str, scene_paths: dict, out_root: str, *,
                       n_samples: int, suffix: str = "", model: dict | None = None,
                       training: dict | None = None, **sections) -> str:
    """A training config over the scene: 'train+val' over five vertical
    stripes (stripe 2 validates, stripe 1 is the test stripe), the
    geom-stereo channels, and ``model``, ``training`` and any further
    sections merged over that. Runs go to ``out_root/<minute>_<suffix>``."""
    dataset = {"name": "smoke_city",
               "raster_gt": scene_paths["raster_gt"],
               "raster_in": scene_paths["raster_in"],
               "path_image_list": scene_paths["path_image_list"],
               "path_pairlist_training": scene_paths["path_pairlist"],
               "path_pairlist_validation": scene_paths["path_pairlist"],
               "area_type": "train+val",
               "allocation_strategy": "5-crossval_vertical",
               "test_stripe": 1, "n_training_samples": n_samples}
    cfg = {"datasets": [dataset],
           "model": {"input_channels": "geom-stereo", **(model or {})},
           "training_settings": {"loss": "L1", **(training or {})},
           "output": {"output_directory": out_root, "suffix": suffix}}
    cfg.update(sections)
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)
    return path


def run_dir_of(out_root: str, suffix: str) -> str:
    """The newest run directory with ``suffix`` under a training output root."""
    runs = [os.path.join(out_root, d) for d in os.listdir(out_root)
            if d.endswith(f"_{suffix}")]
    return max(runs, key=os.path.getmtime)


def serving_model_artifacts(run_dir: str, checkpoint: str = "Model_best.npz") -> dict:
    """The inference config's ``model`` section for a training run."""
    return {"weights": os.path.join(run_dir, "checkpoints", checkpoint),
            "architecture": os.path.join(run_dir, "model_config.json"),
            "normalization_geom": os.path.join(run_dir,
                                               "DSM_normalization_parameters.p"),
            "normalization_image": os.path.join(run_dir,
                                                "Image_normalization_parameters.p")}


# --------------------------------- helpers ---------------------------------- #

def ulps(reference: np.ndarray, n: int = 2) -> float:
    """``n`` f32 ulps at the largest magnitude of ``reference``."""
    return n * float(np.spacing(np.float32(np.abs(reference).max())))


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 10) -> float:
    """Mean device time of one call of ``fn`` in ms: ``iters`` calls
    captured in a CUDA graph, replayed ``replays`` times after a warm-up
    replay, between CUDA events. No host work runs between the launches,
    so a kernel that takes less time than its wrapper's Python is timed,
    and not the host (``cuda_ms`` times that: back-to-back eager calls)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def nvidia_smi_line() -> str:
    result = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return result.stdout.strip().splitlines()[0].strip()


# --------------------------------- phases ----------------------------------- #

def phase_device() -> dict:
    smi = nvidia_smi_line()
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi}
    log("device", f"{info['kind']} x{info['count']}; nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    return info


def phase_build() -> float:
    """Build every kernel source at once (one nvcc each, in threads)."""
    from concurrent.futures import ThreadPoolExecutor

    from resdepth_tpu_torch.ops import build, conv, epilogue, stitch, upconv

    start = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:
        libs = list(pool.map(lambda load: load(),
                             (stitch._library, conv._library, epilogue._library,
                              upconv._library)))
    seconds = time.perf_counter() - start
    for lib, names in zip(libs, (("stitch_k1", "stitch_k2"),
                                 ("conv3x3_k3", "conv3x3_k3_narrow", "conv3x3_k3_narrow_bf16"),
                                 ("trunk_epilogue",),
                                 ("upconv2x2_skip",))):
        if not all(hasattr(lib, name) for name in names):
            raise RuntimeError(f"a kernel library lacks one of {names}")
    log("build", "; ".join(
        f"csrc/{name}.cu -> {os.path.relpath(build.library_path(name), REPO)} "
        f"(nvcc {build.BUILD_SECONDS[name]:.2f} s)"
        for name in ("stitch", "conv", "epilogue", "upconv"))
        + f"; all in {seconds:.2f} s; flags {' '.join(build.NVCC_FLAGS)}")
    return seconds


def grid_batches(rows: int = SCENE_SIZE, cols: int = SCENE_SIZE,
                 tile: int = TILE, batch: int = BATCH, seed: int = SEED,
                 n_batches: int | None = None) -> list:
    """The main path's batches over a (rows, cols) canvas: the
    ``create_regular_grid`` tiling at stride tile/2, cut into batches of
    ``batch`` and the last padded to ``batch`` as ``infer/tiled.py`` pads
    it (zero-weight tiles at the origins of the last batch's real tiles, in
    turn); random normalised tiles, per-tile means near 420 m, the blend
    weights of ``ops.blend``. Each batch carries its box (``batch_bounds``)
    and its count of padding tiles; ``n_batches`` stops after the first
    few."""
    from resdepth_tpu_torch.geo.grid import create_regular_grid, positions_as_array
    from resdepth_tpu_torch.ops import blend
    from resdepth_tpu_torch.ops.stitch import batch_bounds

    area = {"x_extent": [(0, cols - 1)], "y_extent": [(0, rows - 1)]}
    positions, borders = create_regular_grid(area, tile, tile // 2)
    positions = positions_as_array(positions)
    wy, wx = blend.weight_table(tile, tile // 2, borders)
    n = len(positions)
    n_pad = -(-n // batch) * batch - n
    last = positions[n // batch * batch:]
    positions = np.concatenate([positions, np.resize(last, (n_pad, 2))])
    wy = np.concatenate([wy, np.zeros((n_pad, tile), np.float32)])
    wx = np.concatenate([wx, np.zeros((n_pad, tile), np.float32)])
    rng = np.random.default_rng(seed)
    batches = []
    for first in range(0, len(positions), batch)[:n_batches]:
        sl = slice(first, first + batch)
        batches.append({
            "tiles": torch.from_numpy(
                rng.standard_normal((batch, tile, tile), np.float32)),
            "positions": torch.from_numpy(positions[sl]),
            "wy": torch.from_numpy(wy[sl]), "wx": torch.from_numpy(wx[sl]),
            "means": torch.from_numpy(rng.normal(420.0, 5.0, batch).astype(np.float32)),
            "bounds": batch_bounds(positions[sl], tile),
            "n_pad": max(0, first + batch - n)})
    return batches


def repadded(batch: dict, where: str) -> dict:
    """``batch`` with its padding tiles all at (0, 0) (``where="origin"``,
    as the JAX package pads) or all on its last real tile
    (``"last_tile"``), and the box that padding gives."""
    from resdepth_tpu_torch.ops.stitch import batch_bounds

    positions = batch["positions"].clone()
    n_pad = batch["n_pad"]
    if n_pad:
        positions[-n_pad:] = 0 if where == "origin" else positions[-n_pad - 1]
    return {**batch, "positions": positions,
            "bounds": batch_bounds(positions.numpy(), batch["tiles"].shape[1])}


def overlap_batch(rows: int, cols: int, tile: int, n: int, seed: int = SEED) -> dict:
    """``n`` tiles at random positions on a (rows, cols) canvas, eight of
    them on one spot and two against the far corner, with random blend
    weights in [0, 1): many tiles on some pixels, tile columns at every
    residue mod 4."""
    from resdepth_tpu_torch.ops.stitch import batch_bounds

    rng = np.random.default_rng(seed)
    positions = np.stack([rng.integers(0, rows - tile + 1, n),
                          rng.integers(0, cols - tile + 1, n)], 1).astype(np.int32)
    positions[n // 2:n // 2 + 8] = positions[n // 2]
    positions[-2:] = (rows - tile, cols - tile)
    return {"tiles": torch.from_numpy(rng.standard_normal((n, tile, tile), np.float32)),
            "positions": torch.from_numpy(positions),
            "wy": torch.from_numpy(rng.random((n, tile), np.float32)),
            "wx": torch.from_numpy(rng.random((n, tile), np.float32)),
            "means": torch.from_numpy(rng.normal(420.0, 5.0, n).astype(np.float32)),
            "bounds": batch_bounds(positions, tile), "n_pad": 0}


def max_cover(batches: list, shape) -> int:
    """The most weighted tiles of ``batches`` on one pixel of a canvas of
    ``shape`` (a tile with zero weights adds exact zeros)."""
    count = np.zeros(shape, np.int32)
    for batch in batches:
        tile = batch["tiles"].shape[1]
        weighted = ((batch["wy"] != 0).any(1) & (batch["wx"] != 0).any(1)).numpy()
        for (y, x), w in zip(batch["positions"].numpy(), weighted):
            count[y:y + tile, x:x + tile] += int(w)
    return int(count.max())


def k1_ulps(cover: int) -> int:
    """K1's bar in f32 ulps at the largest height, where at most ``cover``
    weighted tiles meet on a pixel: 2, as where the scene's grid puts 4,
    and cover / 2 above that. K1's atomics add in no fixed order, and a sum
    of n terms in another order may move by more than 2 ulps once n passes
    about 8 (``tests/test_torch_stitch.py::test_free_order_needs_k1_bar``)."""
    return max(2, -(-cover // 2))


def _stitch_args(batch: dict, device) -> list:
    return [batch[k].to(device) for k in ("tiles", "positions", "wy", "wx", "means")]


def stitch_cases() -> tuple:
    """The cases phase 3 holds K1 and K2 to the plain stitch on: (name,
    canvas shape, canvas on the CPU, batches). The 4096^2 scene's batch 2
    and its padded last batch go onto the canvas the plain stitch made of
    the batches before them."""
    from resdepth_tpu_torch.ops import stitch

    scene = grid_batches()
    canvas = torch.zeros((SCENE_SIZE, SCENE_SIZE), dtype=torch.float32)
    for index, batch in enumerate(scene[:-1]):
        if index == 1:
            before_second = canvas.clone()
        stitch.stitch_tiles_plain(canvas, *_stitch_args(batch, "cpu"), DSM_STD)
    ragged = (4001, 3999)
    cases = [
        (f"{SCENE_SIZE}^2 batch 2", before_second, [scene[1]]),
        (f"{SCENE_SIZE}^2 last batch ({BATCH - scene[-1]['n_pad']} tiles + "
         f"{scene[-1]['n_pad']} padding)", canvas, [scene[-1]]),
        (f"{ragged[0]}x{ragged[1]} scene, all batches",
         torch.zeros(ragged, dtype=torch.float32), grid_batches(*ragged)),
        ("random overlap T=16 B=300 on 96x128", torch.zeros((96, 128)),
         [overlap_batch(96, 128, 16, 300)]),
        ("random overlap T=128 B=300 on 1021x1023", torch.zeros((1021, 1023)),
         [overlap_batch(1021, 1023, 128, 300, seed=SEED + 1)]),
    ]
    return cases, scene


def phase_kernels() -> tuple:
    """K1 and K2 against the plain stitch on the CPU, on each of
    ``stitch_cases``: K2 bitwise equal to it and run to run, K1 within
    ``k1_ulps``; both of K2's canvas paths (float4, scalar) taken. Then
    CUDA-event times of K1, K2 and the plain stitch on the scene's batch 2,
    the main path's shape, whose errors the kernels' record keeps. Returns
    that record and the scene's batches."""
    from resdepth_tpu_torch.ops import build, stitch

    device = torch.device("cuda", 0)
    ptxas = [line.strip() for line in build.BUILD_LOGS.get("stitch", "").splitlines()
             if "registers" in line or "spill" in line]
    log("kernels", f"csrc/stitch.cu ptxas: {' | '.join(ptxas) or 'reused build'}")
    cases, scene = stitch_cases()
    result, paths, lines = {}, set(), []
    for name, canvas, batches in cases:
        want = canvas.clone()
        for batch in batches:
            stitch.stitch_tiles_plain(want, *_stitch_args(batch, "cpu"), DSM_STD)
        want = want.numpy()
        cover = max_cover(batches, canvas.shape)
        tol = ulps(want, k1_ulps(cover))
        on_card = [_stitch_args(batch, device) for batch in batches]

        def run(use_pallas):
            out = canvas.to(device, copy=True)
            for batch, args in zip(batches, on_card):
                stitch.stitch_tiles(out, *args, DSM_STD, use_pallas=use_pallas,
                                    bounds=batch["bounds"])
            torch.cuda.synchronize()
            return out.cpu().numpy()

        k1, k2, k2_again = run(True), run("fused"), run("fused")
        errs = {"k1": float(np.abs(k1 - want).max()), "k2": float(np.abs(k2 - want).max())}
        if not errs["k1"] <= tol:
            raise AssertionError(f"{name}: K1 differs from the plain stitch by "
                                 f"{errs['k1']} m (tolerance {k1_ulps(cover)} ulps "
                                 f"= {tol} m)")
        if not np.array_equal(k2, want):
            raise AssertionError(f"{name}: K2 is not bitwise equal to the plain "
                                 f"stitch (max |diff| {errs['k2']} m)")
        if not np.array_equal(k2, k2_again):
            raise AssertionError(f"{name}: K2 is not bitwise reproducible run to run")
        if not result:   # batch 2, the main path's shape
            result = {key: {"max_abs_err": err} for key, err in errs.items()}
        route = stitch.k2_vector_paths(canvas.to(device, copy=True),
                                       on_card[0][0], on_card[0][3])
        paths.add(route[0])
        misaligned = sum(int((b["positions"][:, 1] % 4 != 0).sum()) for b in batches)
        lines.append(f"{name}: {len(batches)} batch(es), up to {cover} weighted "
                     f"tiles a pixel, K2 canvas "
                     f"{'float4' if route[0] else 'scalar'}, tile rows "
                     f"{'float4' if route[1] else 'scalar'} ({misaligned} tiles at "
                     f"x % 4 != 0 load by scalars); K2 bitwise equal to plain and "
                     f"run to run; K1 max err {errs['k1']:.3g} m = "
                     f"{errs['k1'] / ulps(want, 1):.2f} ulps (bar {k1_ulps(cover)} "
                     f"ulps = {tol:.3g} m)")
        del on_card
    if paths != {True, False}:
        raise AssertionError(f"K2's canvas paths taken: {paths}; both must be")
    log("kernels", "; ".join(lines))

    second = scene[1]
    on_card = _stitch_args(second, device)
    scratch = cases[0][1].to(device, copy=True)
    calls = {
        "plain": lambda: stitch.stitch_tiles_plain(scratch, *on_card, DSM_STD),
        "k1": lambda: stitch.stitch_tiles(scratch, *on_card, DSM_STD, use_pallas=True),
        "k2": lambda: stitch.stitch_tiles(scratch, *on_card, DSM_STD,
                                          use_pallas="fused", bounds=second["bounds"]),
    }
    # K1 and K2 take less time than their wrappers' Python, so back-to-back
    # eager calls time the host: their device times come from CUDA graphs.
    # The plain stitch (many PyTorch calls, a host tensor) is timed eagerly.
    times = {name: [] for name in calls}
    eager = {name: [] for name in ("k1", "k2")}
    for order in (("plain", "k1", "k2"), ("k2", "k1", "plain")):
        for name in order:
            times[name].append(cuda_ms(calls[name]) if name == "plain"
                               else graph_ms(calls[name]))
            if name != "plain":
                eager[name].append(cuda_ms(calls[name]))
    plain_ms = float(np.mean(times["plain"]))
    bound, bound_by = stitch_bound(second, (SCENE_SIZE, SCENE_SIZE))
    for key in ("k1", "k2"):
        # No single PyTorch call computes the stitch: library_ms is None.
        result[key].update(ms=float(np.mean(times[key])), plain_ms=plain_ms,
                           bound_ms=bound, bound_by=bound_by, library_ms=None)
    spread = "; ".join(f"{k} {' / '.join(f'{t:.4f}' for t in v)} ms"
                       for k, v in times.items())
    log("kernels", f"batch 2: B={BATCH} T={TILE} canvas {SCENE_SIZE}^2: "
        + "; ".join(f"{k.upper()} {r['ms']:.4f} ms ({100 * bound / r['ms']:.0f} % "
                    "of bound)" for k, r in result.items())
        + f"; plain on CUDA {plain_ms:.4f} ms (K1, K2: CUDA graphs of 20 "
        "launches replayed 10 times; plain: CUDA events around 20 eager calls; "
        f"mean of 2 turns: {spread}); bound {bound:.4f} ms ({bound_by}); eager "
        "back-to-back calls (host-bound): " + ", ".join(
            f"{k.upper()} {float(np.mean(v)):.4f} ms" for k, v in eager.items()))
    return result, scene


def phase_stitch_scene(scene: list) -> dict:
    """Device times (CUDA graphs) of K2 over every batch of the 4096^2
    scene with the main path's padding (on the last batch's real tiles in
    turn), with all padding tiles on the last real tile, and with the JAX
    package's padding at the origin (whose box reaches the canvas's
    origin); and of K1 over the same batches; each beside the sum of the
    batches' bounds. Each batch is timed alone (a graph of 20 launches of
    it) and the scene as a whole (a graph of 4 passes over its 8 batches,
    so each launch finds in L2 what the batch before it left), in turns."""
    from resdepth_tpu_torch.ops import stitch

    device = torch.device("cuda", 0)
    shape = (SCENE_SIZE, SCENE_SIZE)
    canvas = torch.zeros(shape, dtype=torch.float32, device=device)
    on_card = [_stitch_args(batch, device) for batch in scene]
    variants = {"k2": scene, "k2_last_tile_pad": [repadded(b, "last_tile") for b in scene],
                "k2_origin_pad": [repadded(b, "origin") for b in scene], "k1": scene}
    positions = {name: [b["positions"].to(device) for b in batches]
                 for name, batches in variants.items()}

    def launcher(name, index):
        args = list(on_card[index])
        args[1] = positions[name][index]
        if name == "k1":
            return lambda: stitch.stitch_tiles(canvas, *args, DSM_STD, use_pallas=True)
        bounds = variants[name][index]["bounds"]
        return lambda: stitch.stitch_tiles_fused(canvas, *args, DSM_STD, bounds=bounds)

    def whole(name):
        launches = [launcher(name, index) for index in range(len(scene))]
        return lambda: [launch() for launch in launches]

    times = {name: [[] for _ in scene] for name in variants}
    whole_ms = {name: [] for name in variants}
    order = tuple(variants)
    for name in order + order[::-1]:
        for index in range(len(scene)):
            times[name][index].append(graph_ms(launcher(name, index)))
        whole_ms[name].append(graph_ms(whole(name), iters=4))
    bounds = [stitch_bound(batch, shape)[0] for batch in scene]
    result = {name: {"scene_ms": float(np.mean(whole_ms[name])),
                     "per_batch_ms": [float(np.mean(t)) for t in ts]}
              for name, ts in times.items()}
    result["bound_ms"] = sum(bounds)
    log("stitch-scene", f"{len(scene)} batches of the {SCENE_SIZE}^2 scene (the "
        f"last with {scene[-1]['n_pad']} padding tiles), device time from CUDA "
        "graphs, mean of 2 turns: " + "; ".join(
            f"{name} {r['scene_ms']:.4f} ms a scene ({100 * result['bound_ms'] / r['scene_ms']:.0f} % "
            f"of bound; each batch alone {', '.join(f'{t:.4f}' for t in r['per_batch_ms'])}, "
            f"sum {sum(r['per_batch_ms']):.4f})"
            for name, r in result.items() if name != "bound_ms")
        + f"; bound {result['bound_ms']:.4f} ms a scene (per batch "
        f"{', '.join(f'{b:.4f}' for b in bounds)}); last batch's box: "
        + ", ".join(f"{name} {batches[-1]['bounds']}"
                    for name, batches in variants.items() if name != "k1"))
    return result


def stitch_bound(batch: dict, shape) -> tuple:
    """The stitch's bound for one batch on a canvas of ``shape``: the tiles,
    positions, blend weights and means read once, and the canvas pixels the
    batch covers read and written once; a few operations a pixel, so bytes
    bound it."""
    tile = batch["tiles"].shape[1]
    covered = np.zeros(shape, bool)
    for y, x in batch["positions"].numpy():
        covered[y:y + tile, x:x + tile] = True
    n_bytes = sum(batch[k].numel() * batch[k].element_size()
                  for k in ("tiles", "positions", "wy", "wx", "means"))
    n_bytes += 2 * 4 * int(covered.sum())
    return bound_ms(n_bytes, 3.0 * batch["tiles"].numel())


def _check_outputs(out_dir: str, shape) -> np.ndarray:
    from resdepth_tpu_torch.geo.raster import open_raster

    paths = output_paths(out_dir)
    for path in paths.values():
        if not os.path.exists(path):
            raise AssertionError(f"the CLI did not write {path}")
    prediction = open_raster(paths["prediction"]).band(1)
    if prediction.shape != tuple(shape):
        raise AssertionError(f"prediction of shape {prediction.shape}, "
                             f"expected {tuple(shape)}")
    if not (np.isfinite(prediction).all() and (prediction != -9999).all()):
        raise AssertionError("the refined scene has non-finite or nodata pixels")
    return prediction


def phase_flagship(work: str, scene: dict, model: dict) -> dict:
    """Four CLI runs over the 4096^2 scene: K1 and K2 in float32 and in
    bfloat16. The launch counters are zeroed just before the runs and read
    just after them."""
    from resdepth_tpu_torch.ops import stitch

    n_tiles = ((SCENE_SIZE - TILE) // (TILE // 2) + 1) ** 2
    n_batches = -(-n_tiles // BATCH)
    runs = [("float32", None), ("float32", "fused"),
            ("bfloat16", None), ("bfloat16", "fused")]
    predictions, walls = {}, {}
    for key in stitch.LAUNCHES:
        stitch.LAUNCHES[key] = 0
    for dtype, use_pallas in runs:
        name = f"{dtype}-{'k2' if use_pallas else 'k1'}"
        out_dir = os.path.join(work, "eval", name)
        general = {"tile_size": TILE, "batch_size": BATCH, "compute_dtype": dtype}
        if use_pallas is not None:
            general["use_pallas"] = use_pallas
        config = write_config(os.path.join(work, f"config_{name}.json"),
                              scene["paths"], model, out_dir, **general)
        if not walls:
            with _timed_steps() as steps:
                walls[name] = run_cli(config, "cuda")
        else:
            walls[name] = run_cli(config, "cuda")
        if dtype == "float32" and (torch.backends.cudnn.allow_tf32
                                   or torch.backends.cuda.matmul.allow_tf32):
            raise AssertionError("TF32 is on after a float32 run")
        predictions[name] = _check_outputs(out_dir, (SCENE_SIZE, SCENE_SIZE))
    launches = dict(stitch.LAUNCHES)
    if launches != {"k1": 2 * n_batches, "k2": 2 * n_batches}:
        raise AssertionError(f"launch counters {launches}, expected "
                             f"{2 * n_batches} each ({n_batches} batches a run)")
    agreement = {}
    for dtype in ("float32", "bfloat16"):
        a, b = predictions[f"{dtype}-k1"], predictions[f"{dtype}-k2"]
        err, tol = float(np.abs(a - b).max()), ulps(a)
        if not err <= tol:
            raise AssertionError(f"{dtype}: K1 and K2 scenes differ by {err} m "
                                 f"(tolerance 2 ulps = {tol} m)")
        agreement[dtype] = err
    bf16_dev = predictions["bfloat16-k1"] - predictions["float32-k1"]
    log("flagship", f"{n_tiles} tiles, {n_batches} batches of {BATCH} a run; "
        + "; ".join(f"{name} CLI wall {wall:.2f} s ({n_tiles / wall:.1f} tiles/s)"
                    for name, wall in walls.items())
        + f"; TF32 off in float32: True; launches {launches}; "
        f"K1 vs K2 max diff float32 {agreement['float32']:.3g} m, bfloat16 "
        f"{agreement['bfloat16']:.3g} m; bfloat16 vs float32 mean |dev| "
        f"{float(np.abs(bf16_dev).mean()):.4g} m, max {float(np.abs(bf16_dev).max()):.4g} m")
    log("flagship", f"where the float32-k1 CLI run's {walls['float32-k1']:.2f} s "
        "went (host clock, s): " + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    return {"launches": launches, "walls": walls}


# The CLI's steps whose wall time phase 4 reports for its first run: the
# names ``resdepth_tpu_torch.predict`` calls them by. ``_to_numpy`` is the
# fetch that waits for the device.
TIMED_STEPS = ("TileDataset", "serving_model", "device_put_dataset",
               "predict_linear_blend", "_to_numpy", "evaluate_performance")


@contextlib.contextmanager
def _timed_steps():
    """Wrap the CLI's steps (and ``write_raster``) with host-clock timers
    while the block runs; yields the seconds summed per step."""
    from resdepth_tpu_torch.geo import raster as raster_mod
    from resdepth_tpu_torch import predict

    seconds = {}
    targets = [(predict, name) for name in TIMED_STEPS]
    targets.append((raster_mod, "write_raster"))
    originals = [getattr(module, name) for module, name in targets]

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            start = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - start
        return wrapper

    for (module, name), fn in zip(targets, originals):
        setattr(module, name, timed(name, fn))
    try:
        yield seconds
    finally:
        for (module, name), fn in zip(targets, originals):
            setattr(module, name, fn)


def _tile_dataset(paths: dict, size: int, image_mean: float, image_std: float,
                  tile: int = TILE, stride: int | None = None):
    """The 'test'-strategy TileDataset the CLI builds for the whole scene."""
    from resdepth_tpu_torch.data import control_files
    from resdepth_tpu_torch.data.dataset import TileDataset

    entry = {"raster_in": paths["raster_in"],
             "image_list": control_files.read_imagelist_from_file(
                 paths["path_image_list"]),
             "image_pairs": [(0, 1)],
             "area_defn": {"x_extent": [(0, size - 1)], "y_extent": [(0, size - 1)]}}
    return TileDataset(entry, input_channels="geom-stereo", tile_size=tile,
                       sampling_strategy="test", stride=stride, dsm_std=DSM_STD,
                       ortho_mean=image_mean, ortho_std=image_std)


def phase_steady(scene: dict, model_path: str) -> dict:
    """Scene time of ``predict_linear_blend`` with the model served and the
    rasters on the card (no file I/O, no evaluation), and the UNet forward
    of one batch against one K1 stitch, in float32 and bfloat16."""
    from resdepth_tpu_torch import predict
    from resdepth_tpu_torch.data.pipeline import build_batch, device_put_dataset
    from resdepth_tpu_torch.infer.tiled import (_inference_spec,
                                                predict_linear_blend,
                                                serving_model)
    from resdepth_tpu_torch.models import weights
    from resdepth_tpu_torch.models.unet import UNet, apply_unet, flagship_config

    device = torch.device("cuda", 0)
    ds = _tile_dataset(scene["paths"], SCENE_SIZE, scene["image_mean"],
                       scene["image_std"])
    rasters = device_put_dataset(ds, device)
    config = flagship_config("geom-stereo")
    base = UNet(config)
    base.load_state_dict(weights.load_state_dict(model_path, config))
    spec = _inference_spec(ds)
    batch = build_batch(rasters, torch.from_numpy(ds.positions[:BATCH]).to(device),
                        torch.from_numpy(ds.pair_indices[:BATCH]).to(device), spec)
    result = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = predict.select_compute_dtype(dtype_name, device)
        served = serving_model(base, device, dtype)

        def scene_run():
            return predict_linear_blend(served, ds, device=device,
                                        batch_size=BATCH, compute_dtype=dtype,
                                        rasters=rasters, fold_bn=False,
                                        as_numpy=False)

        scene_run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        walls = []
        for _ in range(3):
            start = time.perf_counter()
            scene_run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
        x = batch["input"].to(dtype)
        with torch.inference_mode():
            forward_ms = cuda_ms(lambda: apply_unet(served, x), iters=5, warmup=2)
        result[dtype_name] = {
            "scene_s": float(np.median(walls)), "walls": walls,
            "tiles_per_s": len(ds.positions) / float(np.median(walls)),
            "forward_ms": forward_ms,
            "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30}
    log("steady", "predict_linear_blend on the card, rasters resident, median "
        "of 3 after a warm-up: " + "; ".join(
            f"{k} scene {r['scene_s']:.3f} s ({r['tiles_per_s']:.1f} tiles/s; "
            f"runs {', '.join(f'{w:.3f}' for w in r['walls'])} s), "
            f"UNet forward {r['forward_ms']:.2f} ms per batch of {BATCH}, "
            f"peak {r['peak_gib']:.2f} GiB" for k, r in result.items()))
    return result


# Kernel-name fragments by which ``device_breakdown`` groups device time.
KERNEL_GROUPS = (("K3", ("conv3x3_k3",)), ("K3 split", ("split_hi_lo",)),
                 ("stitch", ("stitch_k",)), ("trunk epilogue", ("trunk_epilogue",)),
                 ("cuDNN convs", ("conv", "cudnn", "xmma", "cutlass", "gemm")))


def device_breakdown(fn) -> dict:
    """Device time of the kernels ``fn`` launches, from ``torch.profiler``
    (CUPTI): ms by group (``KERNEL_GROUPS``, the rest "other"), the
    kernel count, and each group's two longest kernels by total time;
    empty when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names, count = {}, 0
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            names[event.name] = names.get(event.name, 0.0) + event.time_range.elapsed_us() / 1e3
            count += 1
    groups, top = {}, {}
    for name, ms in sorted(names.items(), key=lambda kv: -kv[1]):
        lower = name.lower()
        group = next((g for g, keys in KERNEL_GROUPS if any(k in lower for k in keys)),
                     "other")
        groups[group] = groups.get(group, 0.0) + ms
        top.setdefault(group, [])
        if len(top[group]) < 2:
            top[group].append(f"{name[:60]} {ms:.2f}")
    return {"ms": groups, "kernels": count, "top": top, "names": names} if groups else {}


def k3_ms_by_passes(names: dict) -> dict:
    """K3's float32 device time (``device_breakdown``'s per-kernel ms) by
    its pass count, the second template argument of
    ``conv3x3_k3_wide_f32_kernel<BN, kPasses>`` and the first of
    ``conv3x3_k3_narrow_kernel<kPasses, kLoad>`` and
    ``conv3x3_k3_narrow_k_kernel<kPasses, kKSteps>``, and its weights' split
    kernels' (``split_hi_lo_weights_kernel``, ``split_hi_lo_fragments_kernel``
    and ``split_hi_lo_k_fragments_kernel``)."""
    import re

    out = {}
    for name, ms in names.items():
        match = (re.search(r"conv3x3_k3_wide_f32_kernel<\s*\d+,\s*(\d+)", name)
                 or re.search(r"conv3x3_k3_narrow(?:_k)?_kernel<\s*(\d+)", name))
        if match:
            key = int(match.group(1))
        elif "split_hi_lo" in name:
            key = "split"
        else:
            continue
        out[key] = out.get(key, 0.0) + ms
    return out


def phase_modes(scene: dict, model_path: str) -> dict:
    """The five string serving modes on the 4096^2 scene, rasters resident,
    through ``predict_linear_blend(compute_dtype=mode)``. For each mode the
    K3 and trunk epilogue launch counters are zeroed just before its first
    scene run and read just after it: they must be the forward's launches
    by pass count (``k3_calls_a_forward``) and the forward's epilogue calls
    (``epilogue_calls``: 14 on the bf16 trunk of mixed and balanced16, none
    elsewhere) times the batches. Then the scene time (median of 3 more
    runs), tiles/s, the UNet forward of one batch of 128 (CUDA events) and
    the peak memory; and the mean and p99 |deviation| of the first run's
    scene from the float32 scene, in cm (random weights, so this is no
    budget check). Returns the per-mode records, the K3 launches of the
    mode paths by pass count and their epilogue launches."""
    from resdepth_tpu_torch import predict
    from resdepth_tpu_torch.data.pipeline import build_batch, device_put_dataset
    from resdepth_tpu_torch.infer.tiled import (_inference_spec, predict_linear_blend,
                                                serving_model)
    from resdepth_tpu_torch.models import weights
    from resdepth_tpu_torch.models.unet import (SERVING_PRECISION_MODES, UNet,
                                                apply_unet, flagship_config,
                                                serving_precision)
    from resdepth_tpu_torch.ops import conv, epilogue

    device = torch.device("cuda", 0)
    ds = _tile_dataset(scene["paths"], SCENE_SIZE, scene["image_mean"],
                       scene["image_std"])
    rasters = device_put_dataset(ds, device)
    config = flagship_config("geom-stereo")
    base = UNet(config)
    base.load_state_dict(weights.load_state_dict(model_path, config))
    n_batches = -(-len(ds.positions) // BATCH)
    x = build_batch(rasters, torch.from_numpy(ds.positions[:BATCH]).to(device),
                    torch.from_numpy(ds.pair_indices[:BATCH]).to(device),
                    _inference_spec(ds))["input"]

    def run(served, dtype):
        return predict_linear_blend(served, ds, device=device, batch_size=BATCH,
                                    compute_dtype=dtype, rasters=rasters,
                                    fold_bn=False, as_numpy=False)

    dtype = predict.select_compute_dtype("float32", device)
    served = serving_model(base, device, dtype)
    reference = run(served, dtype).cpu().numpy()
    breakdowns = {"float32": device_breakdown(lambda: run(served, dtype))}
    result, launches = {}, {1: 0, 2: 0, 3: 0, **{v: 0 for v in K3_COUNTED}}
    launches["epilogue"] = 0
    for mode in SERVING_PRECISION_MODES:
        dtype = predict.select_compute_dtype(mode, device)
        served = serving_model(base, device, dtype)
        for key in conv.LAUNCHES:
            conv.LAUNCHES[key] = 0
        epilogue.LAUNCHES["epilogue"] = 0
        canvas = run(served, dtype)
        torch.cuda.synchronize()
        want_epilogue = len(epilogue_calls(mode, config, 1)) * n_batches
        if epilogue.LAUNCHES["epilogue"] != want_epilogue or (
                mode in ("mixed", "balanced16") and want_epilogue != 14 * n_batches):
            raise AssertionError(f"{mode}: {epilogue.LAUNCHES['epilogue']} trunk epilogue "
                                 f"launches, expected {want_epilogue} ({n_batches} batches; "
                                 f"14 a batch on the bf16 trunk)")
        launches["epilogue"] += want_epilogue
        counts = {p: conv.LAUNCHES[f"k3_p{p}"] for p in (1, 2, 3)}
        want = {p: n * n_batches
                for p, n in k3_calls_a_forward(mode, config.depth).items()}
        if ({p: c for p, c in counts.items() if c} != want
                or conv.LAUNCHES["k3"] != sum(want.values())):
            raise AssertionError(f"{mode}: K3 launches {conv.LAUNCHES}, expected "
                                 f"{want} by pass count ({n_batches} batches)")
        for p, c in counts.items():
            launches[p] += c
        for variant in K3_COUNTED:
            launches[variant] += conv.LAUNCHES[f"k3_{variant}"]
        # the composed top's two convs on the bf16 trunk read it as it lies
        want_bf16 = 2 * n_batches if mode in ("mixed", "balanced16") else 0
        if (conv.LAUNCHES["k3_narrow_bf16"], conv.LAUNCHES["k3_bf16_upcast"]) != (want_bf16, 0):
            raise AssertionError(f"{mode}: K3 launches {conv.LAUNCHES}, expected "
                                 f"{want_bf16} of narrow_bf16 and no upcast")
        out = canvas.cpu().numpy()
        if not np.isfinite(out).all():
            raise AssertionError(f"{mode}: non-finite refined scene")
        dev_cm = np.abs(out - reference) * 100.0
        torch.cuda.reset_peak_memory_stats(device)
        walls = []
        for _ in range(3):
            start = time.perf_counter()
            run(served, dtype)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
        kwargs = serving_precision(mode).apply_kwargs()
        with torch.inference_mode():
            forward_ms = cuda_ms(lambda: apply_unet(served, x, **kwargs), iters=5,
                                 warmup=2)
        result[mode] = {
            "scene_s": float(np.median(walls)), "walls": walls,
            "tiles_per_s": len(ds.positions) / float(np.median(walls)),
            "forward_ms": forward_ms,
            "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
            "launches": want, "epilogue_launches": want_epilogue,
            "mean_dev_cm": float(dev_cm.mean()),
            "p99_dev_cm": float(np.percentile(dev_cm, 99))}
        breakdowns[mode] = device_breakdown(lambda: run(served, dtype))
        x_split = [n for n in breakdowns[mode].get("names", {})
                   if n.startswith("split_hi_lo_kernel") or "::split_hi_lo_kernel" in n]
        if x_split:
            raise AssertionError(f"{mode}: a split launch of x ran: {x_split}")
        del served, canvas
    torch.cuda.empty_cache()
    log("modes", f"predict_linear_blend(compute_dtype=mode) on the card, rasters "
        f"resident, {len(ds.positions)} tiles, {n_batches} batches of {BATCH}; "
        "median of 3 after a counted run: " + "; ".join(
            f"{m} scene {r['scene_s']:.3f} s ({r['tiles_per_s']:.1f} tiles/s; runs "
            f"{', '.join(f'{w:.3f}' for w in r['walls'])} s), UNet forward "
            f"{r['forward_ms']:.2f} ms per batch of {BATCH}, peak {r['peak_gib']:.2f} "
            f"GiB, K3 launches by passes {r['launches']}, trunk epilogue launches "
            f"{r['epilogue_launches']}, |dev| from float32 mean "
            f"{r['mean_dev_cm']:.4g} cm, p99 {r['p99_dev_cm']:.4g} cm"
            for m, r in result.items())
        + f"; K3 launches of the mode paths by passes {launches}")
    walls = {"float32": None, **{m: r["scene_s"] for m, r in result.items()}}
    log("modes", "device time of one scene run by kernel group (torch.profiler; "
        "idle share against the median unprofiled scene time): " + "; ".join(
            f"{m}: " + (", ".join(f"{g} {t:.2f} ms ({' | '.join(b['top'][g])})"
                                  for g, t in sorted(b["ms"].items(), key=lambda kv: -kv[1]))
                + f", {b['kernels']} kernels, busy {sum(b['ms'].values()):.2f} ms"
                + (f", idle {100 * (1 - sum(b['ms'].values()) / 1e3 / walls[m]):.1f} %"
                   if walls[m] else "") if b else "no device time")
            for m, b in breakdowns.items()))
    return {"modes": result, "launches": launches, "breakdowns": breakdowns}


# The crop's float32 bar, card (K2) against CPU, in f32 ulps of the CPU
# scene's largest height (``ulps``): measured 3 (9.16e-5 m at 420-450 m,
# PRs 1-5), so 4 keeps an ulp of margin and follows the heights.
CROP_ULPS = 4

# The bar of each serving mode on the crop, card against CPU: the mean
# |diff| of the UNet's outputs as a share of the mode's own mean deviation
# from float32 on the card, a tenth. The two sides differ only in how the
# sums are taken (K3's and cuDNN's against the CPU's), which moves a bf16
# rounding of an activation now and then: measured fast32 0.025, act2pass
# 0.0005, mixed 0.027, balanced16 0.070. Except balanced, whose own
# deviation with random weights is 0.015 cm on the crop, as small as those
# moved roundings (0.0037 cm, fast32's 0.0093): measured 0.25, so its bar
# is 0.5. On trained weights (``studies/precision_study.py``) its share is
# 0.27-0.28 as well, and cuDNN's plain version on the card stands as far
# from the CPU (0.25-0.26) as K3 does: the rounding of 1-pass activations
# after sums in another order, not K3's sums, keeps it above a tenth
# (``tests/test_torch_train_precision.py``, sum order alone, on the CPU).
# Every bar must also reject the nearest
# other compute dtype served on the card in the mode's place, measured at
# 0.59-1.0. ``bfloat16`` is reported beside them, with no bar.
CROP_SHARES = {"fast32": 0.1, "act2pass": 0.1, "balanced": 0.5,
               "mixed": 0.1, "balanced16": 0.1}


def _crop_modes(model, ds) -> dict:
    """Each serving mode on the crop's tiles, card against CPU: the card's
    batch of the crop's tiles through the served UNet on the card and on
    the CPU. The mean |diff| of the UNet's outputs must be within a share of
    the mode's own mean deviation from float32 on the card
    (``CROP_SHARES``), and that bar must reject every other compute dtype
    served on the card in the mode's place (the controls: each other
    mode's, float32's and bfloat16's card outputs against the mode's CPU
    outputs). They are compared before the stitch: its denormalised
    heights, near 420 m, round at 3.05e-5 m, as large as balanced's own
    deviation on the crop. The stitched crops' mean |diff| is reported
    beside them."""
    from resdepth_tpu_torch import predict
    from resdepth_tpu_torch.data.pipeline import build_batch, device_put_dataset
    from resdepth_tpu_torch.infer.tiled import (_inference_spec, _storage,
                                                predict_linear_blend, serving_model)
    from resdepth_tpu_torch.models.unet import SERVING_PRECISION_MODES, apply_unet

    devices = {"cpu": torch.device("cpu"), "card": torch.device("cuda", 0)}
    x = build_batch(device_put_dataset(ds, devices["card"]),
                    torch.from_numpy(ds.positions.astype(np.int32)).to(devices["card"]),
                    torch.from_numpy(ds.pair_indices.astype(np.int64)).to(devices["card"]),
                    _inference_spec(ds))["input"].cpu()

    def forward(mode, name):
        dtype = predict.select_compute_dtype(mode, devices[name])
        storage, kwargs = _storage(dtype)
        served = serving_model(model, devices[name], dtype)
        with torch.inference_mode():
            y = apply_unet(served, x.to(devices[name], storage), **kwargs)
        return y.float().cpu().numpy()

    served = ("float32", "bfloat16") + SERVING_PRECISION_MODES
    cards = {mode: forward(mode, "card") for mode in served}
    cm = ds.dsm_std * 100.0          # a normalised unit in cm
    modes = {}
    for mode in served[1:]:
        cpu = forward(mode, "cpu")
        diff = float(np.abs(cards[mode] - cpu).mean())
        own = float(np.abs(cards[mode] - cards["float32"]).mean())
        controls = {other: float(np.abs(card - cpu).mean()) / own
                    for other, card in cards.items() if other != mode}
        nearest = min(controls, key=controls.get)
        scenes = [predict_linear_blend(model, ds, device=devices[name], batch_size=BATCH,
                                       compute_dtype=predict.select_compute_dtype(
                                           mode, devices[name]), use_pallas="fused")
                  for name in ("card", "cpu")]
        modes[mode] = {"card_vs_cpu_cm": diff * cm, "own_dev_cm": own * cm,
                       "share": diff / own, "bar_share": CROP_SHARES.get(mode),
                       "nearest": nearest, "nearest_share": controls[nearest],
                       "card_vs_cpu_max_cm": float(np.abs(cards[mode] - cpu).max()) * cm,
                       "stitched_card_vs_cpu_m": float(np.abs(scenes[0] - scenes[1]).mean()),
                       "finite": bool(np.isfinite(cards[mode]).all())}
    log("crop", f"serving modes on the crop's {len(ds.positions)} tiles, card vs CPU, "
        "UNet output mean |diff| as a share of the mode's own mean |dev| from "
        "float32 on the card, beside the nearest control (another compute dtype's "
        "card outputs against the mode's CPU outputs): " + "; ".join(
            f"{m} {r['card_vs_cpu_cm']:.3g} cm (max {r['card_vs_cpu_max_cm']:.3g}) against "
            f"own {r['own_dev_cm']:.3g} cm: {r['share']:.3g} (bar {r['bar_share']}; "
            f"nearest control {r['nearest']} {r['nearest_share']:.3g}); "
            f"stitched crop mean |diff| {r['stitched_card_vs_cpu_m']:.3g} m"
            for m, r in modes.items()))
    failed = {m: r for m, r in modes.items() if not r["finite"] or (
        r["bar_share"] is not None
        and not r["share"] <= r["bar_share"] < r["nearest_share"])}
    if failed:
        raise AssertionError(f"card and CPU differ on the crop's tiles above the "
                             f"bar, or a control passes it: {failed}")
    return modes


def phase_crop(work: str, scene: dict, model_path: str) -> dict:
    """The f32 refined scene of a 512x512 crop on the card (TF32 off) against
    the port's CPU path (plain stitch), within ``CROP_ULPS`` f32 ulps of the
    largest height, held after two more card scenes (K1, bfloat16) that
    leave K2's array unchanged and share no memory with it; then each serving
    mode on the crop, card against CPU (``_crop_modes``)."""
    from resdepth_tpu_torch.geo import raster as raster_mod
    from resdepth_tpu_torch.geo import tiff
    from resdepth_tpu_torch import predict
    from resdepth_tpu_torch.infer.tiled import predict_linear_blend
    from resdepth_tpu_torch.models import weights
    from resdepth_tpu_torch.models.unet import UNet, flagship_config

    crop_dir = os.path.join(work, "crop")
    os.makedirs(crop_dir, exist_ok=True)
    paths = dict(scene["paths"])
    images = []
    with open(paths["path_image_list"]) as f:
        sources = [line.strip() for line in f if line.strip()]
    for source in [paths["raster_in"]] + sources:
        src = raster_mod.open_raster(source)
        path = os.path.join(crop_dir, os.path.basename(source))
        tiff.write(path, src.band(1)[:CROP_SIZE, :CROP_SIZE],
                   geotransform=src.geotransform, nodata=src.nodata,
                   compress="none")
        images.append(path)
    paths["raster_in"] = images[0]
    paths["path_image_list"] = os.path.join(crop_dir, "imagelist.txt")
    with open(paths["path_image_list"], "w") as f:
        f.write("\n".join(images[1:]) + "\n")
    ds = _tile_dataset(paths, CROP_SIZE, scene["image_mean"], scene["image_std"])

    config = flagship_config("geom-stereo")
    model = UNet(config)
    model.load_state_dict(weights.load_state_dict(model_path, config))
    outputs = {}
    for name, device, use_pallas in (("cpu", torch.device("cpu"), None),
                                     ("k2", torch.device("cuda", 0), "fused"),
                                     ("k1", torch.device("cuda", 0), None),
                                     ("bf16", torch.device("cuda", 0), "fused")):
        dtype = predict.select_compute_dtype(
            "bfloat16" if name == "bf16" else "float32", device)
        outputs[name] = predict_linear_blend(model, ds, device=device,
                                             batch_size=BATCH, compute_dtype=dtype,
                                             use_pallas=use_pallas)
        if name == "k2":
            kept = outputs["k2"].copy()
    # Each card scene lands in pinned host memory of its own: the two later
    # scenes (K1's, then a bfloat16 one that differs by cm) leave K2's array
    # as it was, and share no memory with it.
    later = (outputs["k1"], outputs["bf16"])
    if (not np.array_equal(outputs["k2"], kept) or np.array_equal(outputs["bf16"], kept)
            or any(np.shares_memory(outputs["k2"], o) for o in later)):
        raise AssertionError("a later scene wrote to K2's scene array or shares "
                             "its memory")
    stats = getattr(torch.cuda, "host_memory_stats", dict)()
    log("crop", f"three {CROP_SIZE}^2 card scenes in a row: K2's array unchanged "
        "after K1's and a bfloat16 scene, no memory shared; pinned host memory "
        + ", ".join(f"{k} {v}" for k, v in stats.items() if "bytes" in k))
    # K2 sums each pixel in the plain stitch's order, so its difference is
    # the UNet's alone (cuDNN against the CPU's convs); K1's atomics may add
    # up to 2 more ulps on top, so it is reported, not held to the bar.
    errs = {k: float(np.abs(outputs[k] - outputs["cpu"]).max()) for k in ("k2", "k1")}
    bar = ulps(outputs["cpu"], CROP_ULPS)
    if not (np.isfinite(outputs["k2"]).all() and errs["k2"] <= bar):
        raise AssertionError(f"card (K2) and CPU differ by {errs['k2']} m on "
                             f"the crop (tolerance {CROP_ULPS} ulps = {bar:.3g} m)")
    log("crop", f"{CROP_SIZE}^2 crop, {len(ds.positions)} tiles, float32 with "
        f"TF32 off: card (K2) vs CPU (plain stitch) max |diff| {errs['k2']:.3g} m "
        f"= {errs['k2'] / ulps(outputs['cpu'], 1):.2f} ulps (tolerance {CROP_ULPS} "
        f"ulps = {bar:.3g} m); card with K1: {errs['k1']:.3g} m")
    modes = _crop_modes(model, ds)
    return {"float32_k2_max_m": errs["k2"], "modes": modes}


def phase_modes_cli(work: str, scene: dict, model: dict) -> dict:
    """One CLI run over the 4096^2 scene with ``general.compute_dtype:
    "balanced16"``: it writes its rasters and statistics, the scene is
    finite, and K3 ran at 3 passes three times a batch (its counters zeroed
    just before the run and read just after)."""
    from resdepth_tpu_torch.ops import conv

    n_batches = -(-(((SCENE_SIZE - TILE) // (TILE // 2) + 1) ** 2) // BATCH)
    out_dir = os.path.join(work, "eval", "balanced16")
    config = write_config(os.path.join(work, "config_balanced16.json"),
                          scene["paths"], model, out_dir, tile_size=TILE,
                          batch_size=BATCH, compute_dtype="balanced16")
    for key in conv.LAUNCHES:
        conv.LAUNCHES[key] = 0
    wall = run_cli(config, "cuda")
    launches = dict(conv.LAUNCHES)
    prediction = _check_outputs(out_dir, (SCENE_SIZE, SCENE_SIZE))
    want = k3_calls_a_forward("balanced16")[3] * n_batches
    if launches["k3_p3"] != want or launches["k3"] != want:
        raise AssertionError(f"the balanced16 CLI run launched K3 {launches}, "
                             f"expected {want} at 3 passes")
    log("modes-cli", f"python -m resdepth_tpu_torch.predict with compute_dtype "
        f"balanced16: CLI wall {wall:.2f} s, wrote "
        f"{', '.join(os.path.basename(p) for p in output_paths(out_dir).values())}; "
        f"K3 launches {launches}; scene finite, mean {float(prediction.mean()):.2f} m")
    return {"wall_s": wall, "launches": launches}


# Phase "streaming": the 4096^2 scene under a device budget of 1024 rows x
# 4096 columns x 3 raster planes: 5 row bands of 217, 217, 217, 217 and 93
# tiles whose windows overlap by 128 rows at 4 seams; 9 batches of 128 (the
# last band's 93 tiles padded to the resident batch) against the resident
# scene's 8.
STREAM_BUDGET = 1024 * SCENE_SIZE * 3
STREAM_BANDS = (217, 217, 217, 217, 93)
STREAM_RUNS = (("float32", "fused"), ("float32", None), ("balanced16", "fused"))


def stream_geometry(ds, budget: int) -> dict:
    """The row bands ``predict_linear_blend_streaming`` cuts ``ds`` into
    under ``budget``: tiles a band, windows, the seam rows (where two bands'
    windows overlap), batches (of the resident scene's size, ``BATCH``
    capped at the scene's tiles) and the bytes of rasters and canvas each
    band puts on the device."""
    from resdepth_tpu_torch.data.banded import resident_pixels
    from resdepth_tpu_torch.infer.tiled import _iter_bands

    rows, cols = ds.dsm_input.shape
    planes = resident_pixels(ds, include_target=False) // (rows * cols)
    bands = list(_iter_bands(ds, budget // (cols * planes)))
    windows = [(w.start, w.stop) for w, _, _ in bands]
    seams = np.zeros(rows, bool)
    for (_, stop), (start, _) in zip(windows, windows[1:]):
        seams[start:stop] = True
    tiles = tuple(len(idx) for _, idx, _ in bands)
    batch = min(BATCH, len(ds.positions))
    return {"tiles": tiles, "windows": windows, "seams": seams,
            "overlaps": [stop - start for (_, stop), (start, _)
                         in zip(windows, windows[1:])],
            "batches": sum(-(-n // batch) for n in tiles),
            "raster_bytes": [(b - a) * cols * planes * 4 for a, b in windows],
            "resident_raster_bytes": rows * cols * planes * 4,
            "canvas_bytes": [(b - a) * cols * 4 for a, b in windows]}


def hold_streamed(name: str, got: np.ndarray, want: np.ndarray, geometry: dict,
                  bar_ulps: int = 0) -> dict:
    """A streamed scene against another scene: within ``bar_ulps`` f32 ulps
    of the largest height (0: bitwise). Raises with where the largest
    difference sits; returns the largest difference in ulps in each band's
    window and on the seam rows (where a band's canvas starts from the sums
    of the band above)."""
    diff = np.abs(got.astype(np.float64) - want) / ulps(want, 1)
    bands = [float(diff[a:b].max()) for a, b in geometry["windows"]]
    if not (np.isfinite(got).all() and diff.max() <= bar_ulps):
        y, x = np.unravel_index(int(np.argmax(diff)), diff.shape)
        raise AssertionError(
            f"{name}: the streamed scene differs by {diff[y, x]:.3g} ulps (bar "
            f"{bar_ulps}), largest at row {y}, column {x}: {got[y, x]!r} against "
            f"{want[y, x]!r}; largest a band {bands}")
    return {"bands": bands, "seams": float(diff[geometry["seams"]].max())}


def phase_streaming(scene: dict, model_path: str) -> dict:
    """The 4096^2 scene through ``predict_linear_blend_streaming`` under
    ``STREAM_BUDGET``: the band geometry asserted (``STREAM_BANDS``, 128-row
    overlaps, 9 batches), then float32 with K2 and with K1 and balanced16
    with K2 (K3 in every band). Each streamed scene is held against the
    resident scene of the same dtype (``hold_streamed``: K2 bitwise; K1
    within K1's bar of the K2 streamed scene). The counters are zeroed just
    before each run's first streamed scene and read just after: 9 stitches
    of its kernel, and for balanced16 K3's 3 launches at 3 passes a batch.
    Then the scene time (median of 3 after the counted run; the fetch
    included), tiles/s and peak memory, streamed beside resident."""
    from resdepth_tpu_torch import predict
    from resdepth_tpu_torch.data.pipeline import device_put_dataset
    from resdepth_tpu_torch.infer.tiled import (predict_linear_blend,
                                                predict_linear_blend_streaming,
                                                serving_model)
    from resdepth_tpu_torch.models import weights
    from resdepth_tpu_torch.models.unet import UNet, flagship_config
    from resdepth_tpu_torch.ops import conv, stitch

    device = torch.device("cuda", 0)
    ds = _tile_dataset(scene["paths"], SCENE_SIZE, scene["image_mean"],
                       scene["image_std"])
    geometry = stream_geometry(ds, STREAM_BUDGET)
    if (geometry["tiles"] != STREAM_BANDS or geometry["overlaps"] != [TILE // 2] * 4
            or geometry["batches"] != 9):
        raise AssertionError(f"streamed bands {geometry['tiles']}, window overlaps "
                             f"{geometry['overlaps']}, {geometry['batches']} batches; "
                             f"expected {STREAM_BANDS}, 128 rows at 4 seams, 9")
    seams = geometry["seams"]
    log("streaming", f"budget {STREAM_BUDGET:,} px: {len(geometry['tiles'])} bands of "
        f"{', '.join(map(str, geometry['tiles']))} tiles, windows "
        f"{', '.join(f'{a}-{b}' for a, b in geometry['windows'])} (overlaps "
        f"{geometry['overlaps']} rows, {int(seams.sum())} seam rows), "
        f"{geometry['batches']} batches against "
        f"{-(-len(ds.positions) // BATCH)} resident; on the device a band: rasters "
        f"{', '.join(f'{b / 2**20:.1f}' for b in geometry['raster_bytes'])} MiB, canvas "
        f"{', '.join(f'{b / 2**20:.1f}' for b in geometry['canvas_bytes'])} MiB "
        f"(resident: rasters {geometry['resident_raster_bytes'] / 2**20:.1f} MiB, canvas "
        f"{ds.dsm_input.size * 4 / 2**20:.1f} MiB)")
    config = flagship_config("geom-stereo")
    base = UNet(config)
    base.load_state_dict(weights.load_state_dict(model_path, config))
    n_batches = geometry["batches"]
    result, scenes = {}, {}
    launches = {"k1": 0, "k2": 0, 3: 0, **{v: 0 for v in K3_COUNTED}}

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        walls = []
        for _ in range(3):
            start = time.perf_counter()
            out = fn()
            if isinstance(out, torch.Tensor):
                out.cpu()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
        return (float(np.median(walls)), walls,
                torch.cuda.max_memory_allocated(device) / 2**30)

    for dtype_name, use_pallas in STREAM_RUNS:
        name = f"{dtype_name}-{'k2' if use_pallas else 'k1'}"
        dtype = predict.select_compute_dtype(dtype_name, device)
        served = serving_model(base, device, dtype)
        rasters = device_put_dataset(ds, device)
        kwargs = dict(device=device, batch_size=BATCH, compute_dtype=dtype,
                      use_pallas=use_pallas, fold_bn=False)
        resident = predict_linear_blend(served, ds, rasters=rasters, **kwargs)
        resident_s, resident_walls, resident_peak = timed(
            lambda: predict_linear_blend(served, ds, rasters=rasters, as_numpy=False,
                                         **kwargs))
        del rasters
        torch.cuda.empty_cache()

        def streamed():
            return predict_linear_blend_streaming(
                served, ds, max_device_pixels=STREAM_BUDGET, **kwargs)

        for counters in (stitch.LAUNCHES, conv.LAUNCHES):
            for key in counters:
                counters[key] = 0
        got = streamed()
        counts = dict(stitch.LAUNCHES)
        k3 = conv.LAUNCHES["k3_p3"]
        kernel = "k2" if use_pallas else "k1"
        want_k3 = (0 if dtype_name == "float32"
                   else k3_calls_a_forward(dtype_name)[3] * n_batches)
        if (counts != {"k1": 0, "k2": 0, kernel: n_batches} or k3 != want_k3
                or conv.LAUNCHES["k3"] != want_k3):
            raise AssertionError(f"{name}: streamed scene launched {counts}, K3 "
                                 f"{conv.LAUNCHES}; expected {n_batches} {kernel} "
                                 f"and {want_k3} K3 at 3 passes")
        launches[kernel] += n_batches
        launches[3] += k3
        for variant in K3_COUNTED:
            launches[variant] += conv.LAUNCHES[f"k3_{variant}"]
        stream_s, stream_walls, stream_peak = timed(streamed)
        if use_pallas:
            held = hold_streamed(name, got, resident, geometry)
        else:
            held = hold_streamed(name, got, scenes["float32-k2"], geometry, k1_ulps(4))
            held["resident K1"] = float(np.abs(got - resident).max()) / ulps(resident, 1)
        scenes[name] = got
        n_tiles = len(ds.positions)
        result[name] = {"stream_s": stream_s, "resident_s": resident_s,
                        "stream_walls": stream_walls, "resident_walls": resident_walls,
                        "stream_tiles_per_s": n_tiles / stream_s,
                        "resident_tiles_per_s": n_tiles / resident_s,
                        "stream_peak_gib": stream_peak, "resident_peak_gib": resident_peak,
                        "launches": {kernel: n_batches, **({"k3_p3": k3} if k3 else {})},
                        "ulps": held}
        del served
        torch.cuda.empty_cache()
    log("streaming", "predict_linear_blend_streaming against predict_linear_blend "
        "(rasters resident), median of 3 after a counted run: " + "; ".join(
            f"{n} streamed {r['stream_s']:.3f} s ({r['stream_tiles_per_s']:.1f} tiles/s; "
            f"runs {', '.join(f'{w:.3f}' for w in r['stream_walls'])}), resident "
            f"{r['resident_s']:.3f} s ({r['resident_tiles_per_s']:.1f} tiles/s; runs "
            f"{', '.join(f'{w:.3f}' for w in r['resident_walls'])}), "
            f"{r['stream_s'] / r['resident_s']:.3f}x; peak {r['stream_peak_gib']:.2f} GiB "
            f"streamed, {r['resident_peak_gib']:.2f} resident; launches {r['launches']}; "
            f"max |diff| in f32 ulps of the largest height a band "
            f"{', '.join(f'{u:.2f}' for u in r['ulps']['bands'])}, on the seams "
            f"{r['ulps']['seams']:.2f}"
            + (f", against the resident K1 scene {r['ulps']['resident K1']:.2f}"
               if "resident K1" in r["ulps"] else "")
            for n, r in result.items())
        + f"; bars: K2 bitwise equal to the resident scene; K1 within {k1_ulps(4)} "
        "ulps of the K2 streamed scene")
    return {"runs": result, "launches": launches}


def phase_streaming_cli(work: str, scene: dict) -> dict:
    """The inference CLI's over-budget branch: ``python -m
    resdepth_tpu_torch.predict`` in this process on the 2048^2 training
    scene (its evaluation takes a quarter of the 4096^2 scene's host time)
    with ``predict.MAX_DEVICE_PIXELS`` lowered to half its rows x 3 planes, so
    that it streams 3 row bands, with K2 in float32. It must log the
    streaming branch and write its rasters; the K2 counter (zeroed just
    before, read just after) counts the bands' batches; the refined scene
    is held bitwise to ``predict_linear_blend`` with the rasters resident
    (``hold_streamed``)."""
    from resdepth_tpu_torch import predict
    from resdepth_tpu_torch.infer.tiled import predict_linear_blend
    from resdepth_tpu_torch.models import weights
    from resdepth_tpu_torch.models.unet import UNet, flagship_config
    from resdepth_tpu_torch.ops import stitch

    device = torch.device("cuda", 0)
    config = flagship_config("geom-stereo")
    model = write_model_artifacts(os.path.join(work, "model_streaming"), config,
                                  "geom-stereo", scene["image_mean"], scene["image_std"])
    ds = _tile_dataset(scene["paths"], TRAIN_SCENE, scene["image_mean"],
                       scene["image_std"])
    budget = TRAIN_SCENE // 2 * TRAIN_SCENE * 3
    geometry = stream_geometry(ds, budget)
    out_dir = os.path.join(work, "eval_streaming")
    cfg = write_config(os.path.join(work, "config_streaming.json"), scene["paths"],
                       model, out_dir, tile_size=TILE, batch_size=BATCH,
                       use_pallas="fused")
    for key in stitch.LAUNCHES:
        stitch.LAUNCHES[key] = 0
    original = predict.MAX_DEVICE_PIXELS
    predict.MAX_DEVICE_PIXELS = budget
    try:
        wall = run_cli(cfg, "cuda")
    finally:
        predict.MAX_DEVICE_PIXELS = original
    launches = dict(stitch.LAUNCHES)
    if launches != {"k1": 0, "k2": geometry["batches"]}:
        raise AssertionError(f"the streaming CLI run launched {launches}, expected "
                             f"{geometry['batches']} K2")
    with open(os.path.join(out_dir, "run.log")) as f:
        if "streaming row bands" not in f.read():
            raise AssertionError("the CLI did not take its streaming branch")
    prediction = _check_outputs(out_dir, (TRAIN_SCENE, TRAIN_SCENE))
    net = UNet(config)
    net.load_state_dict(weights.load_state_dict(model["weights"], config))
    want = predict_linear_blend(net, ds, device=device, batch_size=BATCH,
                                compute_dtype=predict.select_compute_dtype("float32", device),
                                use_pallas="fused")
    held = hold_streamed("streaming CLI", prediction, want, geometry)
    log("streaming-cli", f"python -m resdepth_tpu_torch.predict, float32 K2, "
        f"{TRAIN_SCENE}^2 scene, MAX_DEVICE_PIXELS lowered to {budget:,}: logged "
        f"'streaming row bands', {len(geometry['tiles'])} bands of "
        f"{', '.join(map(str, geometry['tiles']))} tiles, CLI wall {wall:.2f} s, wrote "
        f"{', '.join(os.path.basename(p) for p in output_paths(out_dir).values())}; "
        f"launches {launches}; against predict_linear_blend resident, max |diff| "
        f"in f32 ulps a band {', '.join(f'{u:.2f}' for u in held['bands'])}, on the "
        f"seams {held['seams']:.2f} (bar 0)")
    return {"wall_s": wall, "launches": launches}


def bf16_ulps(reference: np.ndarray, n: int = 2) -> float:
    """``n`` bfloat16 ulps at the largest magnitude of ``reference``."""
    top = float(np.abs(reference).max())
    return n * float(torch.finfo(torch.bfloat16).eps) * 2.0 ** np.floor(np.log2(top))


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float = PEAK_BF16) -> tuple:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate; and which bounds it."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / peak_ops * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def conv_bound(x, c_out: int, passes: int = 1, out_size: int | None = None) -> tuple:
    """K3's bound: x, the weights, bias and slopes read once and the output
    written once, in ``x.dtype`` (the output at ``out_size`` bytes an
    element where given); 2·N·H·W·9·Cin·Cout operations at the bf16 tensor
    rate for each of its bf16 passes."""
    n, h, w, c_in = x.shape
    size = x.element_size()
    n_bytes = ((x.numel() + 9 * c_in * c_out) * size + n * h * w * c_out * (out_size or size)
               + 8 * c_out)
    return bound_ms(n_bytes, passes * 2.0 * n * h * w * 9 * c_in * c_out)


def sass_counts(library: str) -> dict:
    """Counts of the wgmma (HGMMA) and TMA load (UTMALDG) instructions in
    the SASS of a built library (``cuobjdump -sass``)."""
    from resdepth_tpu_torch.ops import build

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    words = sass.split()
    return {op: sum(1 for w in words if w.split(".")[0] == op)
            for op in ("HGMMA", "UTMALDG")}


def _conv_inputs(generator, device, dtype, n, h, w, c_in, c_out):
    x = torch.randn((n, h, w, c_in), generator=generator, device=device).to(dtype)
    kernel = torch.randn((3, 3, c_in, c_out), generator=generator,
                         device=device) / (3.0 * c_in ** 0.5)
    bias = 0.1 * torch.randn(c_out, generator=generator, device=device)
    slope = 0.3 * torch.rand(c_out, generator=generator, device=device)
    return x, kernel, bias, slope


def _library_conv(x, kernel, bias):
    """One PyTorch call for the conv and its bias (cuDNN), on the NCHW view
    of ``x`` in ``x.dtype``: the yardstick ``library_ms`` times."""
    return F.conv2d(x.permute(0, 3, 1, 2), kernel.to(x.dtype).permute(3, 2, 0, 1),
                    bias.to(x.dtype), padding=1)


def phase_conv() -> dict:
    """K3 against the plain version at every 3x3 conv the serving modes
    hand it (``k3_cases``: the served flagship's own shapes, batch 128) and
    at ragged ones: float32 at 3, 1 and 2 bf16 passes, and bfloat16, each
    call on the kernel ``k3_variant`` routes it to; the SASS of the built
    library holds wgmma and TMA loads. The launch
    counters are zeroed before each case's one call through
    ``conv3x3_bias_act`` and read after it (a float32 call splits its
    weights in one launch, x in none); the timing launches come later and
    are not counted. Times, from CUDA events in turns: K3, the plain
    version, ``F.conv2d`` in ``x.dtype`` with TF32 off (``library_ms``) and,
    at 3 passes, cuDNN with TF32 on.
    Returns a record per variant, "float32" (3 passes), "float32_p1",
    "float32_p2" and "bfloat16": its times and bound summed over the
    shapes, each float32 shape weighted by its launches at that pass count
    in one forward of each mode (``k3_cases``; bfloat16, on no path, each
    shape once), and per mode the K3 time of one forward; and "wide_f32",
    "narrow" and "narrow_k": ``phase_conv_variant``'s rows for each, and
    each kernel's share of the float32 records (the shapes it takes); and
    "narrow_bf16": ``phase_conv_narrow_bf16``'s rows."""
    from resdepth_tpu_torch.models.unet import SERVING_PRECISION_MODES
    from resdepth_tpu_torch.ops import build, conv

    sass = sass_counts(build.library_path("conv"))
    report = [line.strip() for line in build.BUILD_LOGS.get("conv", "").splitlines()
              if "registers" in line or "spill" in line]
    log("conv", f"csrc/conv.cu SASS: {sass}; ptxas: {' | '.join(report) or 'reused build'}")
    if not (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0):
        raise AssertionError(f"the conv library lacks wgmma or TMA loads: {sass}")

    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    generator = torch.Generator(device=device).manual_seed(SEED)
    weights = k3_cases()
    cases = [(CONV_BATCH, h, h, c_in, c_out, act)
             for h, c_in, c_out, act in weights] + list(CONV_RAGGED)
    variants = [(f"float32{'' if p == 3 else f'_p{p}'}", torch.float32, p)
                for p in CONV_PASSES] + [("bfloat16", torch.bfloat16, None)]
    result = {}
    for name, dtype, passes in variants:
        rows, launches, splits = [], 0, 0
        for n, h, w, c_in, c_out, act in cases:
            x, kernel, bias, slope = _conv_inputs(generator, device, dtype, n, h, w,
                                                  c_in, c_out)
            for key in conv.LAUNCHES:
                conv.LAUNCHES[key] = 0
            got = conv.conv3x3_bias_act(x, kernel, bias, slope, act_fn=act, passes=passes)
            torch.cuda.synchronize()
            launches += conv.LAUNCHES["k3"]
            splits += conv.LAUNCHES["k3_split"]
            if passes and conv.LAUNCHES[f"k3_p{passes}"] != 1:
                raise AssertionError(f"K3 {name}: not counted at {passes} passes: "
                                     f"{conv.LAUNCHES}")
            want = conv.conv3x3_bias_act_plain(x, kernel, bias, slope, act_fn=act,
                                               passes=passes).float()
            want_np = want.cpu().numpy()
            err = float((got.float() - want).abs().max())
            bar = (1e-4 * float(np.abs(want_np).max()) if dtype == torch.float32
                   else bf16_ulps(want_np))
            shape = f"{n}x{h}x{w} {c_in}->{c_out} {act}"
            if not (np.isfinite(err) and err <= bar):
                raise AssertionError(f"K3 {name} {shape}: max |diff| {err} above {bar}")
            row = {"shape": shape, "key": (h, c_in, c_out, act), "err": err, "bar": bar}
            if passes:
                ieee = conv._activate(_library_conv(x, kernel, bias).permute(0, 2, 3, 1)
                                      .float(), act, slope)
                row["ieee_rel"] = float((got - ieee).abs().max() / ieee.abs().max())
                del ieee
            del got, want
            if n == CONV_BATCH:
                row.update(_conv_times(conv, x, kernel, bias, slope, act, c_out, passes))
                row["weight"] = weights[row["key"]][passes] if passes else 1
            rows.append(row)
            del x
        # a float32 call splits its weights (x on chip); bfloat16 nothing
        want_splits = len(cases) if dtype == torch.float32 else 0
        if launches != len(cases) or splits != want_splits:
            raise AssertionError(f"K3 launched {launches} times and its split "
                                 f"{splits} for {len(cases)} calls in {name}")
        timed = [r for r in rows if "ms" in r]
        total = {key: sum(r["weight"] * r[key] for r in timed)
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        ops_bound = sum(r["weight"] * r["bound_ms"] for r in timed
                        if r["bound_by"] == "operations")
        by_shape = {r["key"]: r["ms"] for r in timed}
        result[name] = {
            "passes": passes, "launches": launches,
            "max_abs_err": max(r["err"] for r in rows), **total,
            "bound_by": "operations" if ops_bound >= total["bound_ms"] / 2 else "bytes",
            "forward_ms": {mode: sum(by_shape[tuple(c[:4])] for c in mode_k3_convs(mode)
                                     if c[4] == passes)
                           for mode in SERVING_PRECISION_MODES} if passes else {},
            "rows": rows}
        log("conv", f"K3 {name}, CUDA events (mean of K3/plain/library/.../"
            "plain/K3 turns, 5 launches each): " + "; ".join(
                f"{r['shape']}: max |diff| {r['err']:.3g} (bar {r['bar']:.3g})"
                + (f", IEEE dev {r['ieee_rel']:.3g} rel" if "ieee_rel" in r else "")
                + (f", K3 {r['ms']:.3f} ms, plain {r['plain_ms']:.3f}, library "
                   f"{r['library_ms']:.3f}, bound {r['bound_ms']:.3f} ({r['bound_by']}, "
                   f"{100 * r['bound_ms'] / r['ms']:.0f} %), launches a forward of each "
                   f"mode {r['weight']}" if "ms" in r else "")
                + (f", TF32 cuDNN {r['tf32_ms']:.3f}" if "tf32_ms" in r else "")
                for r in rows)
            + f"; launches {launches}, split launches {splits}; summed over the shapes "
            f"{'by their launches a forward of each mode' if passes else 'once each'}: "
            f"K3 {total['ms']:.3f} ms, plain {total['plain_ms']:.3f}, library "
            f"{total['library_ms']:.3f}, bound {total['bound_ms']:.3f}"
            + (f"; K3 in one forward: " + ", ".join(
                f"{m} {t:.3f} ms" for m, t in result[name]["forward_ms"].items() if t)
               if passes else ""))
    torch.cuda.empty_cache()
    # each float32 kernel's share of the float32 rows above (the shapes it
    # takes, by their launches a forward of each mode), and its own cases
    layouts = served_layouts()
    for variant in K3_F32_VARIANTS:
        own = phase_conv_variant(generator, variant, layouts)
        timed = [r for v in list(result.values()) if v.get("passes") for r in v["rows"]
                 if "ms" in r and conv.k3_variant(torch.float32, *r["key"][1:3]) == variant]
        result[variant] = {
            **own, **{key: sum(r["weight"] * r[key] for r in timed)
                      for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
            "max_abs_err": max(r["err"] for r in timed + own["rows"]),
            "bound_by": ("operations" if sum(r["weight"] * r["bound_ms"] for r in timed
                                             if r["bound_by"] == "operations")
                         >= sum(r["weight"] * r["bound_ms"] for r in timed) / 2
                         else "bytes")}
    result["narrow_bf16"] = phase_conv_narrow_bf16(generator, layouts)
    return result


def _conv_times(conv, x, kernel, bias, slope, act, c_out, passes) -> dict:
    """CUDA-event times of one timed conv case (not counted launches)."""
    timers = {"k3": lambda: conv.conv3x3_bias_act(x, kernel, bias, slope, act_fn=act,
                                                  passes=passes),
              "plain": lambda: conv.conv3x3_bias_act_plain(x, kernel, bias, slope,
                                                           act_fn=act, passes=passes),
              "library": lambda: _library_conv(x, kernel, bias)}
    if passes == 3:
        def tf32():
            torch.backends.cudnn.allow_tf32 = True
            try:
                return _library_conv(x, kernel, bias)
            finally:
                torch.backends.cudnn.allow_tf32 = False

        timers["tf32"] = tf32
    bound, bound_by = conv_bound(x, c_out, passes or 1)
    return {**{("ms" if k == "k3" else f"{k}_ms"): v for k, v in _in_turns(timers).items()},
            "bound_ms": bound, "bound_by": bound_by}


def _in_turns(timers: dict) -> dict:
    """Each timer's mean CUDA-event ms over two turns, the timers in order
    and then reversed (5 launches after 2 warm-up ones each turn)."""
    order = list(timers)
    times = {name: [] for name in timers}
    for name in order + order[::-1]:
        times[name].append(cuda_ms(timers[name], iters=5, warmup=2))
    return {name: float(np.mean(v)) for name, v in times.items()}


def as_layout(x, layout: str):
    """``x`` (N, H, W, C) as the NHWC view of NCHW memory ("nchw") or as
    NHWC memory ("nhwc")."""
    if layout == "nchw":
        return x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    return x.contiguous()


def layout_of(x) -> str:
    """Which of ``NARROW_LAYOUTS`` an (N, H, W, C) tensor's memory is, or
    "other"."""
    n, h, w, c = x.shape
    if x.stride() == (c * h * w, w, 1, h * w):
        return "nchw"
    return "nhwc" if x.is_contiguous() else "other"


def served_layouts() -> dict:
    """The layout (``layout_of``) of x at each K3 call of one forward of
    the served flagship (seeded random weights, 2 tiles) that goes to a
    kernel other than the wide one, in each serving mode, as ``{mode: [(variant, H, Cin,
    Cout, layout), ...]}``."""
    from unittest import mock

    from resdepth_tpu_torch.infer.tiled import serving_model
    from resdepth_tpu_torch.models import unet
    from resdepth_tpu_torch.ops import conv

    device = torch.device("cuda", 0)
    config = unet.flagship_config("geom-stereo")
    base, found = random_model(config), {}
    x = torch.randn((2, TILE, TILE, config.n_input_channels),
                    generator=torch.Generator().manual_seed(SEED)).to(device)
    for mode in unet.SERVING_PRECISION_MODES:
        calls = found.setdefault(mode, [])

        def record(x, kernel, *args, **kwargs):
            variant = conv.k3_variant(x.dtype, x.shape[3], kernel.shape[3],
                                      kwargs.get("passes"))
            if variant != "wide":
                calls.append((variant, x.shape[1], x.shape[3], kernel.shape[3], layout_of(x)))
            return conv.conv3x3_bias_act(x, kernel, *args, **kwargs)

        served = serving_model(base, device, mode)
        with mock.patch.object(unet, "conv3x3_bias_act", record), torch.inference_mode():
            unet.apply_unet(served, x, **unet.serving_precision(mode).apply_kwargs())
    return found


def phase_conv_variant(generator, variant: str, layouts: dict) -> dict:
    """One of K3's float32 kernels: "wide_f32" (every call the narrow ones
    do not take) at the trunk's convs (batch 128) and ``WIDE_F32_RAGGED``,
    "narrow" (Cout <= 8) at the composed top's convs (batch 128) and
    ``NARROW_RAGGED``, or "narrow_k" (Cin <= 4, 8 < Cout <= 64) at encoder0
    (batch 128) and ``NARROW_K_CASES``; the served flagship's shapes are
    those of ``k3_cases`` that ``k3_variant`` routes to it. Each in both of
    ``NARROW_LAYOUTS``, at 1, 2 and 3 passes: two counted calls through
    ``conv3x3_bias_act`` (counters zeroed just before, read just after: 2
    launches of the kernel and 2 splits, the weights') bitwise equal, each
    within 1e-4 of the largest output of the plain version. At batch 20 and
    above, times in turns (CUDA events): the kernel, for the narrow ones
    the wide_f32 kernel on the same call (``wide_ms``), the plain version,
    ``F.conv2d`` in float32 with TF32 off (``library_ms``) and on bf16
    copies of the operands; the bound (``conv_bound``). ``layouts``
    (``served_layouts``) is logged beside the rows. Returns the rows and
    the kernel's served layouts."""
    from resdepth_tpu_torch.ops import conv

    device = torch.device("cuda", 0)
    served = [(CONV_BATCH, h, h, c_in, c_out, act) for h, c_in, c_out, act in k3_cases()
              if conv.k3_variant(torch.float32, c_in, c_out) == variant]
    cases = served + list({"wide_f32": WIDE_F32_RAGGED, "narrow": NARROW_RAGGED,
                           "narrow_k": NARROW_K_CASES}[variant])
    rows = []
    for n, h, w, c_in, c_out, act in cases:
        for layout in NARROW_LAYOUTS:
            for passes in CONV_PASSES:
                x, kernel, bias, slope = _conv_inputs(generator, device, torch.float32,
                                                      n, h, w, c_in, c_out)
                x = as_layout(x, layout)
                for key in conv.LAUNCHES:
                    conv.LAUNCHES[key] = 0
                got, again = (conv.conv3x3_bias_act(x, kernel, bias, slope, act_fn=act,
                                                    passes=passes) for _ in range(2))
                torch.cuda.synchronize()
                counted = {k: v for k, v in conv.LAUNCHES.items() if v}
                want = conv.conv3x3_bias_act_plain(x, kernel, bias, slope, act_fn=act,
                                                   passes=passes)
                err = float((got - want).abs().max())
                bar = 1e-4 * float(want.abs().max())
                shape = f"{n}x{h}x{w} {c_in}->{c_out} {act} {layout} {passes}p"
                expected = {"k3": 2, f"k3_p{passes}": 2, f"k3_{variant}": 2, "k3_split": 2}
                if not (np.isfinite(err) and err <= bar and torch.equal(got, again)
                        and counted == expected):
                    raise AssertionError(
                        f"K3 {variant} {shape}: max |diff| {err} (bar {bar}), bitwise "
                        f"across two launches {torch.equal(got, again)}, launches {counted}")
                row = {"shape": shape, "key": (h, c_in, c_out, act), "passes": passes,
                       "layout": layout, "err": err, "bar": bar}
                del got, again, want
                if n >= TRAIN_BATCH:
                    b, a = conv._epilogue_vectors(x, kernel, bias, slope)
                    x_bf16, k_bf16 = x.to(torch.bfloat16), kernel.to(torch.bfloat16)
                    timers = {
                        "ms": lambda: conv.conv3x3_bias_act(x, kernel, bias, slope,
                                                            act_fn=act, passes=passes),
                        "wide_ms": lambda: conv._launch_in_place("wide_f32", x, kernel, b, a,
                                                                 act, passes),
                        "plain_ms": lambda: conv.conv3x3_bias_act_plain(
                            x, kernel, bias, slope, act_fn=act, passes=passes),
                        "library_ms": lambda: _library_conv(x, kernel, bias),
                        "bf16_library_ms": lambda: _library_conv(x_bf16, k_bf16, bias)}
                    if variant == "wide_f32":
                        del timers["wide_ms"]
                    row.update(_in_turns(timers))
                    row["bound_ms"], row["bound_by"] = conv_bound(x, c_out, passes)
                    del x_bf16, k_bf16
                rows.append(row)
                del x
        torch.cuda.empty_cache()
    mine = {m: sorted({c[1:] for c in calls if c[0] == variant})
            for m, calls in layouts.items()}
    log("conv", f"K3 {variant} variant, two counted launches a case, bitwise equal, "
        "against the plain version; at batch 20 and above CUDA events in turns (5 "
        "launches each): " + "; ".join(
            f"{r['shape']}: max |diff| {r['err']:.3g} (bar {r['bar']:.3g})"
            + (f", {variant} {r['ms']:.3f} ms ({100 * r['bound_ms'] / r['ms']:.0f} % of "
               f"bound {r['bound_ms']:.3f}, {r['bound_by']})"
               + (f", wide_f32 {r['wide_ms']:.3f}" if "wide_ms" in r else "")
               + f", plain {r['plain_ms']:.3f}, library f32 {r['library_ms']:.3f}, bf16 "
               f"{r['bf16_library_ms']:.3f}" if "ms" in r else "")
            for r in rows)
        + f"; the layouts of x at the {variant} calls of one served flagship forward: "
        + "; ".join(f"{m} {c}" for m, c in mine.items()))
    return {"rows": rows, "layouts": mine}


# Phase 6, K3's narrow_bf16 variant (bfloat16 x with passes, Cout <= 8):
# the composed top's convs at batch 128 as the served flagship hands them
# on the bf16 trunk, ``NARROW_RAGGED`` (Cin 3 and 5: pixels TMA cannot
# take, so the upcast route; Cin 80 direct) and ``NARROW_BF16_RAGGED``,
# each as NHWC memory (what the trunk's epilogue writes) and as its
# H/W-transposed view (a rotation's strides).
NARROW_BF16_VIEWS = ("nhwc", "rotated")
# Ragged shapes TMA reads where they lie (N, H, W, Cin, Cout, activation,
# channels of the memory the view is cut from): Cin 8 and 20, a part-full
# last chunk of 16 (20 as a view of 24-channel memory whose other 4 hold
# NaN: TMA's zero fill past Cin, not the memory, must feed the chunk),
# H and W off the 32 x 32 tile, batch 1 to 3.
NARROW_BF16_RAGGED = ((1, 40, 9, 8, 1, "prelu", 8), (3, 33, 70, 20, 3, "lrelu", 24),
                      (2, 33, 70, 8, 7, "none", 8))


def narrow_bf16_weights() -> dict:
    """The launches of K3's narrow_bf16 kernel in one forward of each
    serving mode, by ``(H, Cin, Cout, act, passes)``: the forwards traced on
    meta tensors (``_meta_forward``), the wrapper swapped for a recorder
    that routes each call as ``conv.k3_variant`` does."""
    from collections import Counter

    from resdepth_tpu_torch.models.unet import SERVING_PRECISION_MODES
    from resdepth_tpu_torch.ops import conv

    weights = Counter()

    def record(x, kernel, bias=None, act_param=None, *, act_fn="relu", passes=None):
        if conv.k3_variant(x.dtype, kernel.shape[2], kernel.shape[3], passes) == "narrow_bf16":
            weights[(x.shape[1], kernel.shape[2], kernel.shape[3], act_fn, passes)] += 1
        return x.new_zeros(x.shape[:3] + (kernel.shape[3],),
                           dtype=torch.float32 if passes else x.dtype)

    for mode in SERVING_PRECISION_MODES:
        _meta_forward(mode, None, 1, record)
    return dict(weights)


def phase_conv_narrow_bf16(generator, layouts: dict) -> dict:
    """K3's narrow_bf16 variant at the composed top's two convs (batch
    128; the float32 narrow variant's shapes of ``k3_cases``),
    ``NARROW_RAGGED`` and ``NARROW_BF16_RAGGED``, in each of
    ``NARROW_BF16_VIEWS``, at 1, 2 and 3 passes: two counted calls through
    ``conv3x3_bias_act`` (counters zeroed just before, read just after: 2
    launches of the kernel and 2 weight splits, or where TMA cannot take x
    2 of the narrow variant on ``x.float()`` and 2 ``k3_bf16_upcast``),
    bitwise equal to each other and to the route before the kernel
    (``x.float()`` into the float32 narrow kernel), within 1e-4 of the
    largest output of the plain version. Every case but Cin 3 and 5 must
    take the kernel. At batch 20 and above, times in turns (CUDA events):
    the kernel, that route (``upcast_ms``: the copy and the float32
    kernel), the float32 kernel alone on the copy (``narrow_ms``), the plain
    version (``plain_ms``) and bf16 cuDNN (``library_ms``), beside the
    bound at bf16's 2 bytes an element of x and a float32 output
    (``conv_bound``) and the float32 kernel's. ``layouts``
    (``served_layouts``) is logged beside the rows. Returns the rows, the
    kernel's served layouts, and the times and bound summed over the NHWC
    rows by their launches a forward of each mode
    (``narrow_bf16_weights``), with the largest error of every row."""
    from resdepth_tpu_torch.ops import conv

    device = torch.device("cuda", 0)
    served = [(CONV_BATCH, h, h, c_in, c_out, act, c_in)
              for h, c_in, c_out, act in k3_cases()
              if conv.k3_variant(torch.float32, c_in, c_out) == "narrow"]
    cases = served + [(*c, c[3]) for c in NARROW_RAGGED] + list(NARROW_BF16_RAGGED)
    rows = []
    for n, h, w, c_in, c_out, act, c_mem in cases:
        for view in NARROW_BF16_VIEWS:
            for passes in CONV_PASSES:
                rotated = view == "rotated"
                x, kernel, bias, slope = _conv_inputs(generator, device, torch.bfloat16, n,
                                                      w if rotated else h,
                                                      h if rotated else w, c_mem, c_out)
                if c_mem > c_in:     # a view of the first c_in channels; NaN past them
                    x[..., c_in:] = float("nan")
                    x, kernel = x[..., :c_in], kernel[:, :, :c_in]
                x = x.transpose(1, 2) if rotated else x
                direct = conv.tma_takes_bf16(x)
                for key in conv.LAUNCHES:
                    conv.LAUNCHES[key] = 0
                got, again = (conv.conv3x3_bias_act(x, kernel, bias, slope, act_fn=act,
                                                    passes=passes) for _ in range(2))
                torch.cuda.synchronize()
                counted = {k: v for k, v in conv.LAUNCHES.items() if v}
                b, a = conv._epilogue_vectors(x, kernel, bias, slope)
                x32 = x.float()
                before = conv._launch_in_place("narrow", x32, kernel, b, a, act, passes)
                want = conv.conv3x3_bias_act_plain(x, kernel, bias, slope, act_fn=act,
                                                   passes=passes)
                err = float((got - want).abs().max())
                bar = 1e-4 * float(want.abs().max())
                shape = f"{n}x{h}x{w} {c_in}->{c_out} {act} {view} {passes}p"
                expected = {"k3": 2, f"k3_p{passes}": 2, "k3_split": 2,
                            **({"k3_narrow_bf16": 2} if direct
                               else {"k3_narrow": 2, "k3_bf16_upcast": 2})}
                same = torch.equal(got, again) and torch.equal(got, before)
                if not (np.isfinite(err) and err <= bar and same and counted == expected
                        and got.dtype == torch.float32 and direct == (c_in not in (3, 5))):
                    raise AssertionError(
                        f"K3 narrow_bf16 {shape}: max |diff| {err} (bar {bar}), bitwise "
                        f"across two launches {torch.equal(got, again)}, to the upcast "
                        f"route {torch.equal(got, before)}, launches {counted}, read "
                        f"where it lies {direct}")
                row = {"shape": shape, "key": (h, c_in, c_out, act), "passes": passes,
                       "view": view, "direct": direct, "err": err, "bar": bar}
                del got, again, want, before
                if n >= TRAIN_BATCH:
                    row.update(_in_turns({
                        "ms": lambda: conv.conv3x3_bias_act(x, kernel, bias, slope,
                                                            act_fn=act, passes=passes),
                        "upcast_ms": lambda: conv._launch_in_place(
                            "narrow", x.float(), kernel, b, a, act, passes),
                        "narrow_ms": lambda: conv._launch_in_place(
                            "narrow", x32, kernel, b, a, act, passes),
                        "plain_ms": lambda: conv.conv3x3_bias_act_plain(
                            x, kernel, bias, slope, act_fn=act, passes=passes),
                        "library_ms": lambda: _library_conv(x, kernel, bias)}))
                    row["bound_ms"], row["bound_by"] = conv_bound(x, c_out, passes, 4)
                    row["f32_bound_ms"] = conv_bound(x32, c_out, passes)[0]
                rows.append(row)
                del x, x32
        torch.cuda.empty_cache()
    weights = narrow_bf16_weights()
    timed = [(weights[r["key"] + (r["passes"],)], r) for r in rows
             if "ms" in r and r["view"] == "nhwc" and r["key"] + (r["passes"],) in weights]
    if sum(wt for wt, _ in timed) != sum(weights.values()):
        raise AssertionError(f"K3 narrow_bf16: the modes' forwards launch it at {weights}, "
                             f"not all timed here")
    total = {key: sum(wt * r[key] for wt, r in timed)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    mine = {m: sorted({c[1:] for c in calls if c[0] == "narrow_bf16"})
            for m, calls in layouts.items()}
    log("conv", "K3 narrow_bf16 variant, two counted launches a case, bitwise equal to "
        "each other and to x.float() into the float32 narrow kernel; at batch 20 and "
        "above CUDA events in turns (5 launches each): " + "; ".join(
            f"{r['shape']}{'' if r['direct'] else ' (upcast route)'}: max |diff| "
            f"{r['err']:.3g} (bar {r['bar']:.3g})"
            + (f", narrow_bf16 {r['ms']:.3f} ms ({100 * r['bound_ms'] / r['ms']:.0f} % of "
               f"bound {r['bound_ms']:.3f}, {r['bound_by']}), upcast + narrow "
               f"{r['upcast_ms']:.3f}, narrow alone {r['narrow_ms']:.3f} (f32 bound "
               f"{r['f32_bound_ms']:.3f}), plain {r['plain_ms']:.3f}, bf16 cuDNN "
               f"{r['library_ms']:.3f}" if "ms" in r else "")
            for r in rows)
        + "; the layouts of x at the narrow_bf16 calls of one served flagship forward: "
        + "; ".join(f"{m} {c}" for m, c in mine.items())
        + f"; launches a forward of each mode {weights}, summed by them: narrow_bf16 "
        f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f}, bf16 cuDNN "
        f"{total['library_ms']:.3f}, bound {total['bound_ms']:.3f}")
    return {"rows": rows, "layouts": mine, **total,
            "max_abs_err": max(r["err"] for r in rows),
            "bound_by": ("operations" if sum(wt * r["bound_ms"] for wt, r in timed
                                             if r["bound_by"] == "operations")
                         >= total["bound_ms"] / 2 else "bytes")}


def epilogue_bytes(kind: str, shape, pool: bool) -> int:
    """The least bytes of one epilogue call (``csrc/epilogue.cu``): its
    inputs read once (bf16 y, u and skip; f32 y for a cast), its outputs
    written once in bf16, the (C,) bias in float32."""
    n, c, h, w = shape
    elements = n * c * h * w
    reads = {"block": 2, "cast": 4, "skip": 4}[kind] * elements
    writes = 2 * elements + (2 * n * c * (h // 2) * (w // 2) if pool else 0)
    return reads + writes + (0 if kind == "cast" else 4 * c)


def _epilogue_case(generator, device, kind, shape, act_fn, pool):
    """Seeded inputs of one epilogue call in channels-last memory, each
    with NaN, +inf, -inf and -0.0 planted (and -0.0 on a grid of channel
    0, whose bias is -0.0, so that a -0.0 sum reaches the activation), and
    the two calls: the kernel and the plain version (the ATen ops)."""
    from resdepth_tpu_torch.ops import epilogue

    n, c, h, w = shape

    def draw(dtype):
        t = torch.randn((n, h, w, c), generator=generator, device=device)
        flat = t.view(-1)
        spots = torch.randint(flat.numel(), (16,), generator=generator, device=device)
        flat[spots] = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0],
                                   device=device).repeat(4)
        t[:, ::2, ::3, 0] = -0.0
        return t.to(dtype).permute(0, 3, 1, 2)

    bias = 0.1 * torch.randn(c, generator=generator, device=device)
    bias[0] = -0.0
    slope = 0.3 * torch.rand(c, generator=generator, device=device)
    if kind == "skip":
        u, skip = draw(torch.bfloat16), draw(torch.bfloat16)
        return (lambda: (epilogue.skip_add_epilogue(u, bias, skip), None),
                lambda: (epilogue.skip_add_epilogue_plain(u, bias, skip), None))
    y = draw(torch.float32 if kind == "cast" else torch.bfloat16)
    args = (y,) if kind == "cast" else (y, bias, slope)
    return (lambda: epilogue.trunk_epilogue(*args, act_fn=act_fn, pool=pool),
            lambda: epilogue.trunk_epilogue_plain(*args, act_fn=act_fn, pool=pool))


def _same_bits(got, want) -> bool:
    """Whether two tensors (or two Nones) hold the same values bit for bit."""
    if got is None or want is None:
        return got is None and want is None
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    bits = {2: torch.int16, 4: torch.int32}[got.element_size()]
    return torch.equal(got.contiguous().view(bits), want.contiguous().view(bits))


def phase_epilogue(work: str) -> dict:
    """The trunk epilogue kernel against its plain version (the ATen ops it
    fuses), bitwise, at the 14 calls of a balanced16 forward of the served
    flagship at batch 128 (``epilogue_calls``) and at ``EPILOGUE_RAGGED``,
    one counted launch a call; times of the kernel and of the ATen ops
    (CUDA graphs, in turns) beside the byte bound. Then a balanced16 forward
    at batch 128 with the kernel and with the ATen ops in its place: device
    time by kernel name (``device_breakdown``) and bits; the forwards of
    ``EPILOGUE_MODELS``, bitwise the ATen ops'; then a seeded
    ``EPILOGUE_SCENE``² scene through ``predict_linear_blend`` (K2) at each
    of ``EPILOGUE_TTA``, whose launches must be 14 a batch and rotation and
    whose canvas must equal the ATen ops' bitwise. Returns the rows and the
    totals over a forward. (The launches of the main path are counted in
    phase "modes".)"""
    from unittest import mock

    from resdepth_tpu_torch.infer.tiled import predict_linear_blend, serving_model
    from resdepth_tpu_torch.models import unet
    from resdepth_tpu_torch.ops import build, epilogue

    report = [line.strip() for line in build.BUILD_LOGS.get("epilogue", "").splitlines()
              if "registers" in line or "spill" in line]
    log("epilogue", f"ptxas: {' | '.join(report) or 'reused build'}")
    device = torch.device("cuda", 0)
    generator = torch.Generator(device=device).manual_seed(SEED)
    calls = epilogue_calls("balanced16")
    if len(calls) != 14:
        raise AssertionError(f"a balanced16 forward makes {len(calls)} epilogue calls, not 14")
    rows = []
    for case in calls + list(EPILOGUE_RAGGED):
        kind, shape, act_fn, pool = case
        kernel, plain = _epilogue_case(generator, device, kind, shape, act_fn, pool)
        epilogue.LAUNCHES["epilogue"] = 0
        got = kernel()
        torch.cuda.synchronize()
        if epilogue.LAUNCHES["epilogue"] != 1:
            raise AssertionError(f"epilogue {case}: {epilogue.LAUNCHES['epilogue']} launches")
        want = plain()
        same = [_same_bits(g, w) for g, w in zip(got, want)]
        label = f"{kind} {'x'.join(map(str, shape))} {act_fn}{' pool' if pool else ''}"
        if not all(same):
            bad = next(i for i, ok in enumerate(same) if not ok)
            diff = (got[bad].float() - want[bad].float()).abs().nan_to_num(float("inf"))
            raise AssertionError(f"epilogue {label}: {('skip', 'pooled')[bad]} differs from "
                                 f"the ATen ops at {int((diff != 0).sum())} places")
        row = {"label": label, "case": case}
        if shape[0] == CONV_BATCH:
            times = {"kernel": [], "plain": []}
            for name in ("kernel", "plain", "plain", "kernel"):
                times[name].append(graph_ms(kernel if name == "kernel" else plain,
                                            iters=10, replays=5))
            row.update(ms=float(np.mean(times["kernel"])),
                       plain_ms=float(np.mean(times["plain"])),
                       bound_ms=epilogue_bytes(kind, shape, pool) / PEAK_BYTES * 1e3)
        rows.append(row)
        del got, want, kernel, plain
    timed = [r for r in rows if "ms" in r]
    total = {k: sum(r[k] for r in timed) for k in ("ms", "plain_ms", "bound_ms")}
    log("epilogue", "bitwise equal to the ATen ops at every call; CUDA graphs, kernel / "
        "ATen ops / bound ms (share of bound): " + "; ".join(
            f"{r['label']}: {r['ms']:.4f} / {r['plain_ms']:.4f} / {r['bound_ms']:.4f} "
            f"({100 * r['bound_ms'] / r['ms']:.0f} %)" for r in timed)
        + f"; a forward's 14 calls: {total['ms']:.3f} / {total['plain_ms']:.3f} / "
        f"{total['bound_ms']:.3f} ms; ragged cases bitwise: "
        + ", ".join(r["label"] for r in rows if "ms" not in r))
    torch.cuda.empty_cache()

    config = unet.flagship_config("geom-stereo")
    base = random_model(config)
    served = serving_model(base, device, "balanced16")
    kwargs = unet.serving_precision("balanced16").apply_kwargs()
    x = torch.randn((CONV_BATCH, TILE, TILE, config.n_input_channels),
                    generator=generator, device=device)
    aten = mock.patch.multiple(epilogue, trunk_epilogue=epilogue.trunk_epilogue_plain,
                               skip_add_epilogue=epilogue.skip_add_epilogue_plain)
    with torch.inference_mode():
        forward = {}
        for name in ("kernel", "aten", "aten", "kernel"):
            with (aten if name == "aten" else contextlib.nullcontext()):
                forward.setdefault(name, []).append(
                    cuda_ms(lambda: unet.apply_unet(served, x, **kwargs), iters=5, warmup=2))
        with aten:
            want = unet.apply_unet(served, x, **kwargs)
            aten_breakdown = device_breakdown(lambda: unet.apply_unet(served, x, **kwargs))
        got = unet.apply_unet(served, x, **kwargs)
        breakdown = device_breakdown(lambda: unet.apply_unet(served, x, **kwargs))
    if not _same_bits(got, want):
        raise AssertionError("the balanced16 forward with the kernel differs from the ATen ops")
    for name, b in (("kernel", breakdown), ("aten", aten_breakdown)):
        walls = ", ".join(f"{v:.2f}" for v in forward[name])
        top = sorted(b.get("names", {}).items(), key=lambda kv: -kv[1])[:16]
        log("epilogue", f"a balanced16 forward at batch {CONV_BATCH} with the {name} "
            f"epilogue: {float(np.mean(forward[name])):.2f} ms (CUDA events: {walls}); "
            "device ms by kernel: " + "; ".join(f"{k} {v:.3f}" for k, v in top))
    del x, got, want
    torch.cuda.empty_cache()

    small = []
    for up_mode, folded in EPILOGUE_MODELS:
        small_config = unet.UNetConfig(n_input_channels=3, start_kernel=4, max_filter_depth=16,
                                       depth=3, act_fn_encoder="prelu",
                                       act_fn_decoder="lrelu", up_mode=up_mode)
        model = random_model(small_config).to(device)
        if folded:
            model = unet.fold_serving(model)
        x = torch.randn((4, 64, 64, 3), generator=generator, device=device)
        for mode in ("mixed", "balanced16", "bf16_compute", "bf16_storage"):
            args = ((x.to(torch.bfloat16),), {}) if mode.startswith("bf16") else (
                (x,), unet.serving_precision(mode).apply_kwargs())
            # bf16_storage comes last: ``.to`` converts the model in place
            served = model.to(torch.bfloat16) if mode == "bf16_storage" else model
            epilogue.LAUNCHES["epilogue"] = 0
            with torch.inference_mode():
                got = unet.apply_unet(served, *args[0], **args[1])
                with aten:
                    want = unet.apply_unet(served, *args[0], **args[1])
            torch.cuda.synchronize()
            label = f"{up_mode} {'folded' if folded else 'unfolded'} {mode}"
            if not _same_bits(got, want):
                raise AssertionError(f"small model, {label}: the forward with the kernel "
                                     f"differs from the ATen ops")
            small.append(f"{label} ({epilogue.LAUNCHES['epilogue']} launches)")
    log("epilogue", "small models' forwards bitwise the ATen ops': " + ", ".join(small))

    scene = write_scene(os.path.join(work, "epilogue_scene"), EPILOGUE_SCENE, EPILOGUE_SCENE)
    ds = _tile_dataset(scene["paths"], EPILOGUE_SCENE, scene["image_mean"],
                       scene["image_std"])
    n_batches = -(-len(ds.positions) // EPILOGUE_SCENE_BATCH)
    models = {mode: serving_model(base, device, mode) for mode, _ in EPILOGUE_TTA}

    def run(mode, tta):
        return predict_linear_blend(models[mode], ds, device=device,
                                    batch_size=EPILOGUE_SCENE_BATCH, compute_dtype=mode,
                                    use_pallas="fused", fold_bn=False, tta=tta, as_numpy=False)

    scenes = []
    for mode, tta in EPILOGUE_TTA:
        label = str(mode).removeprefix("torch.")
        epilogue.LAUNCHES["epilogue"] = 0
        canvas = run(mode, tta)
        torch.cuda.synchronize()
        launches = epilogue.LAUNCHES["epilogue"]
        if launches != 14 * n_batches * tta:
            raise AssertionError(f"{label} at tta {tta}: the scene's {n_batches} batches "
                                 f"launched the epilogue {launches} times, not "
                                 f"{14 * n_batches * tta}")
        with aten:
            want = run(mode, tta)
        if not _same_bits(canvas, want):
            raise AssertionError(f"{label} at tta {tta}: the scene with the kernel differs "
                                 f"from the ATen ops' (K2)")
        scenes.append(f"{label} tta {tta} ({launches} launches)")
        del canvas, want
    log("epilogue", f"{EPILOGUE_SCENE}^2 scene, {len(ds.positions)} tiles in {n_batches} "
        f"batches, canvas bitwise the ATen ops' (K2), 14 launches a batch and rotation: "
        + ", ".join(scenes))
    return {"rows": rows, **total,
            "forward_ms": {k: float(np.mean(v)) for k, v in forward.items()}}


def upconv_bytes(n: int, h: int, w: int, c_in: int, c_out: int) -> int:
    """The least bytes of one upconv call (``csrc/upconv.cu``): x read once,
    the skip read once and the result written once, all float32."""
    return 4 * n * h * w * c_in + 2 * 4 * n * (2 * h) * (2 * w) * c_out


def _upconv_case(generator, device, n, h, w, c_in, c_out):
    """Seeded float32 x (N, H, W, Cin) and skip (N, 2H, 2W, Cout) in NHWC
    memory, as K3 writes them, and an ``nn.ConvTranspose2d``'s weight and
    bias."""
    x = torch.randn((n, h, w, c_in), generator=generator, device=device)
    skip = torch.randn((n, 2 * h, 2 * w, c_out), generator=generator, device=device)
    weight = torch.randn((c_in, c_out, 2, 2), generator=generator, device=device) / (2 * c_in ** 0.5)
    bias = 0.1 * torch.randn(c_out, generator=generator, device=device)
    return x, weight, bias, skip


def _library_upconv(x, weight, bias, skip):
    """One cuDNN call computing the same function in IEEE float32 (TF32
    off), with the skip add: the library's yardstick."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight, bias, stride=2)
    return skip + y.permute(0, 2, 3, 1)


def phase_upconv(work: str) -> dict:
    """The upconv kernel against its plain version (the decoder's ops
    before it) at ``UPCONV_LEVELS`` (batch CONV_BATCH) and ``UPCONV_RAGGED``,
    at 1, 2 and 3 passes: within ``UPCONV_BAR`` of the largest |plain|
    value, bitwise across two launches, one counted launch (and one split)
    a call; the levels timed in turns beside the plain version and one
    cuDNN float32 transposed conv with the skip add, and the byte bound.
    Then a ``balanced`` forward of the served flagship at batch CONV_BATCH
    with the kernel and with the plain version, device time by kernel; the
    4096^2 scene served at ``balanced`` resident and streamed (K2), bitwise
    equal, 4 launches a batch; the resdepth-0 model's ``balanced`` forward,
    4 launches; and none on the other cells' paths: a ``balanced16``
    forward, a float32 forward and ``balanced`` and ``balanced16`` train
    steps."""
    from unittest import mock

    from resdepth_tpu_torch import predict
    from resdepth_tpu_torch.data.pipeline import device_put_dataset
    from resdepth_tpu_torch.infer.tiled import (predict_linear_blend,
                                                predict_linear_blend_streaming,
                                                serving_model)
    from resdepth_tpu_torch.models import unet
    from resdepth_tpu_torch.ops import build, upconv

    report = [line.strip() for line in build.BUILD_LOGS.get("upconv", "").splitlines()
              if "registers" in line or "spill" in line or "C7520" in line]
    log("upconv", f"ptxas: {' | '.join(report) or 'reused build'}")
    if any("C7520" in line for line in report):
        raise AssertionError("ptxas serialised the upconv kernel's wgmmas (C7520)")
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    generator = torch.Generator(device=device).manual_seed(SEED)
    rows = []
    cases = [(CONV_BATCH, *level) for level in UPCONV_LEVELS] + list(UPCONV_RAGGED)
    for case in cases:
        args = _upconv_case(generator, device, *case)
        label = "x".join(map(str, case))
        row = {"label": label, "case": case}
        with torch.inference_mode():
            for passes in (1, 2, 3):
                for key in upconv.LAUNCHES:
                    upconv.LAUNCHES[key] = 0
                got = upconv.upconv2x2_skip(*args, passes)
                again = upconv.upconv2x2_skip(*args, passes)
                torch.cuda.synchronize()
                want = {"upconv": 2, "upconv_split": 2, f"upconv_p{passes}": 2}
                if {k: v for k, v in upconv.LAUNCHES.items() if v} != want:
                    raise AssertionError(f"upconv {label} at {passes} passes: launches "
                                         f"{upconv.LAUNCHES}, expected {want}")
                if not _same_bits(got, again):
                    raise AssertionError(f"upconv {label} at {passes} passes: two launches "
                                         f"differ")
                plain = upconv.upconv2x2_skip_plain(*args, passes)
                err = float((got - plain).abs().max())
                scale = float(plain.abs().max())
                if not err <= UPCONV_BAR * scale:
                    raise AssertionError(f"upconv {label} at {passes} passes: off the plain "
                                         f"version by {err:.3g} (bar {UPCONV_BAR} x "
                                         f"{scale:.3g})")
                row[f"rel_err_p{passes}"] = err / scale
                if case[0] == CONV_BATCH:
                    timers = {"kernel": lambda: upconv.upconv2x2_skip(*args, passes),
                              "plain": lambda: upconv.upconv2x2_skip_plain(*args, passes),
                              "library": lambda: _library_upconv(*args)}
                    times = _in_turns(timers)
                    row[f"p{passes}"] = {"ms": times["kernel"], "plain_ms": times["plain"],
                                         "library_ms": times["library"]}
                del got, again, plain
        if case[0] == CONV_BATCH:
            row["bound_ms"] = upconv_bytes(*case) / PEAK_BYTES * 1e3
        rows.append(row)
        del args
        torch.cuda.empty_cache()
    timed = [r for r in rows if "bound_ms" in r]
    total = {"bound_ms": sum(r["bound_ms"] for r in timed)}
    for passes in (1, 2, 3):
        total[f"p{passes}"] = {k: sum(r[f"p{passes}"][k] for r in timed)
                               for k in ("ms", "plain_ms", "library_ms")}
    log("upconv", f"within {UPCONV_BAR} of the largest |plain| value and bitwise across two "
        "launches at every case and pass count (largest relative gap "
        f"{max(max(r[f'rel_err_p{p}'] for p in (1, 2, 3)) for r in rows):.3g}); kernel / "
        "plain / cuDNN f32 + skip add ms (share of the byte bound) at 1, 2, 3 passes: "
        + "; ".join(
            f"{r['label']} (bound {r['bound_ms']:.4f}): " + ", ".join(
                f"{r[f'p{p}']['ms']:.4f} / {r[f'p{p}']['plain_ms']:.4f} / "
                f"{r[f'p{p}']['library_ms']:.4f} ({100 * r['bound_ms'] / r[f'p{p}']['ms']:.0f} %)"
                for p in (1, 2, 3)) for r in timed)
        + f"; the four levels: bound {total['bound_ms']:.4f}, " + ", ".join(
            f"{p} pass{'es' if p > 1 else ''} {total[f'p{p}']['ms']:.4f} / "
            f"{total[f'p{p}']['plain_ms']:.4f} / {total[f'p{p}']['library_ms']:.4f}"
            for p in (1, 2, 3))
        + "; ragged cases: " + ", ".join(r["label"] for r in rows if "bound_ms" not in r))

    plain_patch = mock.patch.object(upconv, "upconv2x2_skip", upconv.upconv2x2_skip_plain)
    config = unet.flagship_config("geom-stereo")
    base = random_model(config)
    served = serving_model(base, device, "balanced")
    kwargs = unet.serving_precision("balanced").apply_kwargs()
    x = torch.randn((CONV_BATCH, TILE, TILE, config.n_input_channels),
                    generator=generator, device=device)
    with torch.inference_mode():
        forward = {}
        for name in ("kernel", "plain", "plain", "kernel"):
            with (plain_patch if name == "plain" else contextlib.nullcontext()):
                forward.setdefault(name, []).append(
                    cuda_ms(lambda: unet.apply_unet(served, x, **kwargs), iters=5, warmup=2))
        with plain_patch:
            plain_breakdown = device_breakdown(lambda: unet.apply_unet(served, x, **kwargs))
        breakdown = device_breakdown(lambda: unet.apply_unet(served, x, **kwargs))
    for name, b in (("kernel", breakdown), ("plain", plain_breakdown)):
        walls = ", ".join(f"{v:.2f}" for v in forward[name])
        top = sorted(b.get("names", {}).items(), key=lambda kv: -kv[1])[:12]
        log("upconv", f"a balanced forward at batch {CONV_BATCH} with the {name} upconv: "
            f"{float(np.mean(forward[name])):.2f} ms (CUDA events: {walls}); device ms by "
            "kernel: " + "; ".join(f"{k[:90]} {v:.3f}" for k, v in top))
    del x
    torch.cuda.empty_cache()

    counts = {}
    zero_config = unet.flagship_config("geom")
    zero = serving_model(random_model(zero_config), device, "balanced")
    x = torch.randn((4, TILE, TILE, 1), generator=generator, device=device)
    for name, model, mode, x_in in (("resdepth-0 balanced", zero, "balanced", x),
                                    ("balanced16", serving_model(base, device, "balanced16"),
                                     "balanced16", None),
                                    ("float32", serving_model(base, device, torch.float32),
                                     None, None)):
        x_in = x_in if x_in is not None else torch.randn(
            (4, TILE, TILE, 3), generator=generator, device=device)
        upconv.LAUNCHES["upconv"] = 0
        with torch.inference_mode():
            unet.apply_unet(model, x_in, **(unet.serving_precision(mode).apply_kwargs()
                                            if mode else {}))
        counts[name] = upconv.LAUNCHES["upconv"]
    for policy in ("balanced", "balanced16"):
        model = random_model(config).to(device)
        upconv.LAUNCHES["upconv"] = 0
        y, _ = unet.apply_unet(model, torch.randn((2, TILE, TILE, 3), generator=generator,
                                                  device=device),
                               train=True, **unet.serving_precision(policy).apply_kwargs())
        y.float().sum().backward()
        counts[f"train {policy}"] = upconv.LAUNCHES["upconv"]
    want_counts = {"resdepth-0 balanced": 4, "balanced16": 0, "float32": 0,
                   "train balanced": 0, "train balanced16": 0}
    if counts != want_counts:
        raise AssertionError(f"upconv launches a forward or step {counts}, expected "
                             f"{want_counts}")
    log("upconv", f"launches a batch: {counts}")
    del zero, x
    torch.cuda.empty_cache()

    scene = write_scene(os.path.join(work, "upconv_scene"), SCENE_SIZE, SCENE_SIZE)
    ds = _tile_dataset(scene["paths"], SCENE_SIZE, scene["image_mean"], scene["image_std"])
    geometry = stream_geometry(ds, STREAM_BUDGET)
    dtype = predict.select_compute_dtype("balanced", device)
    scene_kwargs = dict(device=device, batch_size=BATCH, compute_dtype=dtype,
                        use_pallas="fused", fold_bn=False)
    rasters = device_put_dataset(ds, device)
    n_batches = -(-len(ds.positions) // BATCH)
    upconv.LAUNCHES["upconv"] = 0
    resident = predict_linear_blend(served, ds, rasters=rasters, **scene_kwargs)
    resident_launches = upconv.LAUNCHES["upconv"]
    with plain_patch:
        plain_scene = predict_linear_blend(served, ds, rasters=rasters, **scene_kwargs)
    del rasters
    torch.cuda.empty_cache()
    upconv.LAUNCHES["upconv"] = 0
    streamed = predict_linear_blend_streaming(served, ds, max_device_pixels=STREAM_BUDGET,
                                              **scene_kwargs)
    streamed_launches = upconv.LAUNCHES["upconv"]
    if (resident_launches, streamed_launches) != (4 * n_batches, 4 * geometry["batches"]):
        raise AssertionError(f"the balanced scene launched the upconv {resident_launches} "
                             f"times resident ({n_batches} batches) and {streamed_launches} "
                             f"streamed ({geometry['batches']} batches): not 4 a batch")
    hold_streamed("balanced upconv scene", streamed, resident, geometry)
    gap = float(np.abs(resident.astype(np.float64) - plain_scene).max())
    log("upconv", f"{SCENE_SIZE}^2 balanced scene (K2), {len(ds.positions)} tiles: resident "
        f"{resident_launches} launches in {n_batches} batches, streamed "
        f"{streamed_launches} in {geometry['batches']}, bitwise equal; largest gap to the "
        f"scene with the plain upconv {gap:.3g} m ({gap / ulps(plain_scene, 1):.1f} ulps)")
    return {"rows": rows, **total,
            "forward_ms": {k: float(np.mean(v)) for k, v in forward.items()},
            "launches": resident_launches + streamed_launches + counts["resdepth-0 balanced"]}


@contextlib.contextmanager
def _timed_train_steps():
    """Wrap the train CLI's train step with CUDA events while the block
    runs; yields a list of (start, end, metric) per step."""
    from resdepth_tpu_torch.train import cli

    records = []
    original = cli.make_train_step

    def make(*args, **kwargs):
        step = original(*args, **kwargs)

        def timed(*step_args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metric = step(*step_args)
            end.record()
            records.append((start, end, metric))
            return metric
        return timed

    cli.make_train_step = make
    try:
        yield records
    finally:
        cli.make_train_step = original


# Phase 7's train config (float32 'high'; the epochs are set where it is used).
TRAIN_CLI = dict(
    n_samples=TRAIN_SAMPLES,
    training={"tile_size": TILE, "batch_size": TRAIN_BATCH, "augment": True},
    stereopair_settings={"permute_images_within_pair": True},
    optimizer={"name": "Adam", "learning_rate": 2e-4, "weight_decay": 1e-5},
    scheduler={"enabled": True, "name": "StepLR",
               "settings": {"step_size": 2, "gamma": 0.5}},
    tpu={"train_precision": "high", "compute_dtype": "float32"})


def phase_train(work: str, scene: dict) -> dict:
    """Train, resume and serve the flagship through the CLIs."""
    from resdepth_tpu_torch import train
    from resdepth_tpu_torch.ops import stitch

    device = torch.device("cuda", 0)
    out_root = os.path.join(work, "runs")
    config = write_train_config(
        os.path.join(work, "train.json"), scene["paths"], out_root, suffix="first",
        general={"evaluate_rate": 1, "save_model_rate": 3, "random_seed": SEED},
        **{**TRAIN_CLI, "training": {**TRAIN_CLI["training"], "n_epochs": 2}})
    torch.cuda.reset_peak_memory_stats(device)
    start = time.perf_counter()
    with _timed_train_steps() as records:
        trainer = train.main([config, "--device", "cuda"])
    wall = time.perf_counter() - start
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on after a float32 training run")
    metrics = [float(m) for _, _, m in records]
    if not all(np.isfinite(metrics)) or len(metrics) != 2 * TRAIN_SAMPLES // TRAIN_BATCH:
        raise AssertionError(f"train metrics {metrics}")
    step_ms = [s.elapsed_time(e) for s, e, _ in records]
    steady = step_ms[TRAIN_WARMUP:]
    first_run = run_dir_of(out_root, "first")
    expected = ["config.json", "config.json.orig", "model_config.json",
                "DSM_normalization_parameters.p", "Image_normalization_parameters.p",
                "run.log", "training.log", "metrics.jsonl",
                "checkpoints/Model_best.npz", "checkpoints/Model_last.npz"]
    missing = [f for f in expected if not os.path.exists(os.path.join(first_run, f))]
    if missing:
        raise AssertionError(f"the train CLI did not write {missing}")
    val = list(trainer.val_history)

    resume = write_train_config(
        os.path.join(work, "resume.json"), scene["paths"], out_root, suffix="resumed",
        model={"pretrained_path": os.path.join(first_run, "checkpoints",
                                               "Model_last.npz")},
        general={"evaluate_rate": 1, "save_model_rate": 3, "random_seed": SEED},
        **{**TRAIN_CLI, "training": {**TRAIN_CLI["training"], "n_epochs": 1}})
    resumed = train.main([resume, "--device", "cuda"])
    second_run = run_dir_of(out_root, "resumed")
    if [e for e, _ in resumed.val_history] != [2] or resumed.start_epoch != 2:
        raise AssertionError(f"the resumed run validated epochs "
                             f"{resumed.val_history}, expected epoch 2")
    if not os.path.exists(os.path.join(second_run, "checkpoints",
                                       "Model_after_3_epochs.npz")):
        raise AssertionError("no periodic checkpoint after the third epoch")
    val += resumed.val_history
    if not all(np.isfinite([v for _, v in val])):
        raise AssertionError(f"non-finite val MAE {val}")

    for key in stitch.LAUNCHES:
        stitch.LAUNCHES[key] = 0
    eval_dir = os.path.join(work, "eval_trained")
    serve = write_config(os.path.join(work, "serve_trained.json"), scene["paths"],
                         serving_model_artifacts(second_run), eval_dir,
                         tile_size=TILE, batch_size=BATCH)
    run_cli(serve, "cuda")
    prediction = _check_outputs(eval_dir, (TRAIN_SCENE, TRAIN_SCENE))
    if stitch.LAUNCHES["k1"] == 0:
        raise AssertionError("serving the trained model launched no K1")
    samples_per_s = TRAIN_BATCH / (float(np.mean(steady)) / 1000.0)
    log("train", f"flagship geom-stereo, {TRAIN_SCENE}^2 scene, tile {TILE}, batch "
        f"{TRAIN_BATCH}, {TRAIN_SAMPLES // TRAIN_BATCH} steps an epoch, float32 TF32 "
        f"off: steady step {float(np.mean(steady)):.2f} ms (CUDA events, mean of "
        f"{len(steady)} after {TRAIN_WARMUP}; min {min(steady):.2f}, max "
        f"{max(steady):.2f}), {samples_per_s:.1f} samples/s; peak {peak:.2f} GiB; "
        f"CLI wall {wall:.1f} s for 2 epochs; val MAE per epoch "
        + ", ".join(f"{e}: {v:.4f} m" for e, v in val)
        + f"; resumed at epoch 2; served Model_best.npz with K1 "
        f"({stitch.LAUNCHES['k1']} launches), scene finite, mean "
        f"{float(prediction.mean()):.2f} m")
    return {"step_ms": float(np.mean(steady)), "samples_per_s": samples_per_s,
            "peak_gib": peak, "val": val}


def _train_dataset(scene: dict, size: int, tile: int, n_samples: int):
    """A 'train'-strategy TileDataset over the top-left ``size`` square of
    the scene, with its ground truth, as the train CLI builds one."""
    from resdepth_tpu_torch.data import control_files
    from resdepth_tpu_torch.data.dataset import TileDataset

    entry = {"raster_gt": scene["paths"]["raster_gt"],
             "raster_in": scene["paths"]["raster_in"],
             "image_list": control_files.read_imagelist_from_file(
                 scene["paths"]["path_image_list"]),
             "image_pairs": [(0, 1)], "n_samples": n_samples,
             "area_defn": {"x_extent": [(0, size - 1)], "y_extent": [(0, size - 1)]}}
    return TileDataset(entry, input_channels="geom-stereo", tile_size=tile,
                       sampling_strategy="train", dsm_std=DSM_STD,
                       ortho_mean=scene["image_mean"], ortho_std=scene["image_std"],
                       seed=SEED)


@contextlib.contextmanager
def _recorded_k3_calls():
    """Record each K3 call ``(x shape, kernel shape, passes, x's layout)``
    (``layout_of``) while the block runs (the wrapper is called through)."""
    from unittest import mock

    from resdepth_tpu_torch.ops import conv

    calls, k3 = [], conv.conv3x3_bias_act

    def record(x, kernel, *args, passes=None, **kwargs):
        calls.append((tuple(x.shape), tuple(kernel.shape), passes, layout_of(x)))
        return k3(x, kernel, *args, passes=passes, **kwargs)

    with mock.patch.object(conv, "conv3x3_bias_act", record):
        yield calls


def phase_train_precisions(scene: dict) -> dict:
    """The train step (``make_train_step``) of the flagship at each training
    policy (``TRAIN_POLICIES``) on the 2048^2 scene, batch 20 of 256 px
    tiles, augmentation on: ``TRAIN_STEPS`` steps, the K3 launch counters
    zeroed just before them and read just after (they must be
    ``k3_launches_a_step`` a step), the steady step time from CUDA events
    after ``TRAIN_WARMUP``, samples/s, peak memory and a finite loss. One
    more step runs under ``torch.profiler`` with K3's calls recorded: K3's
    device time in it by pass count. Then K3 against its plain version at
    every call shape the policies' steps hand it (forward and dx), with
    their times, the plain version's, one ``F.conv2d``'s and the bound, and
    K3's time a step of each policy from them."""
    from resdepth_tpu_torch.data.pipeline import (GeneratorDraws, batch_spec_for,
                                                  device_put_dataset)
    from resdepth_tpu_torch.models.unet import flagship_config, init_unet
    from resdepth_tpu_torch.ops import conv
    from resdepth_tpu_torch.train.step import (init_train_state, make_train_step,
                                               select_train_precision)

    device = torch.device("cuda", 0)
    ds = _train_dataset(scene, TRAIN_SCENE, TILE, TRAIN_BATCH * (TRAIN_STEPS + 1))
    spec = batch_spec_for(ds, augment=True)
    rasters = device_put_dataset(ds, device, include_target=True)
    config = flagship_config("geom-stereo")
    batches = [(ds.positions[i:i + TRAIN_BATCH], ds.pair_indices[i:i + TRAIN_BATCH],
                np.zeros((TRAIN_BATCH, 4), np.int32), np.ones(TRAIN_BATCH, np.float32))
               for i in range(0, TRAIN_BATCH * (TRAIN_STEPS + 1), TRAIN_BATCH)]
    result, shapes, launches = {}, {}, {1: 0, 2: 0, 3: 0, **{v: 0 for v in K3_COUNTED}}
    for policy, (train_precision, compute_dtype) in TRAIN_POLICIES.items():
        kwargs, dtype = select_train_precision(train_precision, compute_dtype, device)
        model = init_unet(config, torch.Generator().manual_seed(SEED), device)
        state = init_train_state(model, "Adam", 2e-4, 1e-5)
        step = make_train_step(spec, weighted_bn=False, compute_dtype=dtype, **kwargs)
        draws = GeneratorDraws(torch.Generator(device=device).manual_seed(SEED))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        for key in conv.LAUNCHES:
            conv.LAUNCHES[key] = 0
        events, metrics = [], []
        for batch in batches[:TRAIN_STEPS]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics.append(step(state, rasters, *batch, draws))
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        counts = {p: conv.LAUNCHES[f"k3_p{p}"] for p in (1, 2, 3)}
        want = {p: n * TRAIN_STEPS for p, n in k3_launches_a_step(policy).items()}
        if ({p: c for p, c in counts.items() if c} != want
                or conv.LAUNCHES["k3"] != sum(want.values())):
            raise AssertionError(f"{policy}: K3 launches {conv.LAUNCHES} in "
                                 f"{TRAIN_STEPS} steps, expected {want} by pass count")
        for p, c in counts.items():
            launches[p] += c
        for variant in K3_COUNTED:
            launches[variant] += conv.LAUNCHES[f"k3_{variant}"]
        metrics = [float(m) for m in metrics]
        if not all(np.isfinite(metrics)):
            raise AssertionError(f"{policy}: train metrics {metrics}")
        steady = [s.elapsed_time(e) for s, e in events][TRAIN_WARMUP:]
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        with _recorded_k3_calls() as calls:
            breakdown = device_breakdown(lambda: step(state, rasters, *batches[-1],
                                                      draws))
        for key in calls:
            shapes.setdefault(key, {}).setdefault(policy, 0)
            shapes[key][policy] += 1
        step_ms = float(np.mean(steady))
        result[policy] = {
            "step_ms": step_ms, "min_ms": min(steady), "max_ms": max(steady),
            "samples_per_s": TRAIN_BATCH / (step_ms / 1000.0), "peak_gib": peak,
            "loss_first": metrics[0], "loss_last": metrics[-1],
            "launches_a_step": {p: n // TRAIN_STEPS for p, n in want.items()},
            "k3_in_step_ms": k3_ms_by_passes(breakdown.get("names", {})),
            "busy_ms": sum(breakdown.get("ms", {}).values())}
        del model, state, step
        torch.cuda.empty_cache()
    checks = _train_k3_checks(shapes)
    for policy, r in result.items():
        r["k3_ms"] = {p: sum(c["ms"] * c["calls"].get(policy, 0) for c in checks
                             if c["passes"] == p) for p in (1, 3)}
        r["k3_ms"] = {p: t for p, t in r["k3_ms"].items() if t}
    log("train-precisions", f"flagship geom-stereo, {TRAIN_SCENE}^2 scene, batch "
        f"{TRAIN_BATCH} of {TILE} px, augmentation on, make_train_step, "
        f"{TRAIN_STEPS} steps a policy, CUDA events after {TRAIN_WARMUP}: " + "; ".join(
            f"{p} step {r['step_ms']:.2f} ms (min {r['min_ms']:.2f}, max {r['max_ms']:.2f}), "
            f"{r['samples_per_s']:.1f} samples/s, peak {r['peak_gib']:.2f} GiB, K3 launches "
            f"a step by passes {r['launches_a_step']}, K3 a step (its calls timed alone) "
            + ", ".join(f"{k} pass {t:.2f} ms ({100 * t / r['step_ms']:.1f} %)"
                        for k, t in r["k3_ms"].items())
            + ", in the profiled step " + ", ".join(
                f"{k}{'' if k == 'split' else ' pass'} {t:.2f} ms"
                for k, t in r["k3_in_step_ms"].items())
            + f" of {r['busy_ms']:.2f} ms busy; loss {r['loss_first']:.4f} -> "
            f"{r['loss_last']:.4f} m" for p, r in result.items())
        + f"; K3 launches of the train steps by passes {launches}")
    return {"policies": result, "launches": launches, "checks": checks}


def _train_k3_checks(shapes: dict, phase: str = "train-precisions") -> list:
    """K3 against its plain version (``conv3x3_bias_act_plain``) at each
    call the train steps recorded (``(x shape, kernel shape, passes, x's
    layout)``, with their calls a step by policy; x made in that layout),
    activation none and no bias as the training convs call it: within 1e-4
    of the largest output,
    and CUDA-event times of K3, the plain version and ``F.conv2d`` (TF32
    off), in turns, beside K3's bound. The launches here are not counted."""
    from resdepth_tpu_torch.ops import conv

    device = torch.device("cuda", 0)
    generator = torch.Generator(device=device).manual_seed(SEED + 1)
    rows = []
    for (x_shape, k_shape, passes, layout), calls in shapes.items():
        x = torch.randn(x_shape, generator=generator, device=device)
        if layout in NARROW_LAYOUTS:
            x = as_layout(x, layout)
        kernel = torch.randn(k_shape, generator=generator, device=device) / (
            3.0 * k_shape[2] ** 0.5)
        zeros = torch.zeros(k_shape[3], device=device)
        got = conv.conv3x3_bias_act(x, kernel, act_fn="none", passes=passes)
        want = conv.conv3x3_bias_act_plain(x, kernel, act_fn="none", passes=passes)
        err = float((got - want).abs().max())
        bar = 1e-4 * float(want.abs().max())
        shape = (f"{x_shape[0]}x{x_shape[1]}x{x_shape[2]} {k_shape[2]}->{k_shape[3]} p{passes} "
                 f"{layout}")
        if not (np.isfinite(err) and err <= bar):
            raise AssertionError(f"K3 at the train step's {shape}: max |diff| {err} "
                                 f"above {bar}")
        timers = {"k3": lambda: conv.conv3x3_bias_act(x, kernel, act_fn="none",
                                                      passes=passes),
                  "plain": lambda: conv.conv3x3_bias_act_plain(x, kernel, act_fn="none",
                                                               passes=passes),
                  "library": lambda: _library_conv(x, kernel, zeros)}
        times = {name: [] for name in timers}
        for name in list(timers) + list(timers)[::-1]:
            times[name].append(cuda_ms(timers[name], iters=5, warmup=2))
        bound, bound_by = conv_bound(x, k_shape[3], passes)
        rows.append({"shape": shape, "passes": passes, "calls": calls, "err": err,
                     "bar": bar, "ms": float(np.mean(times["k3"])),
                     "plain_ms": float(np.mean(times["plain"])),
                     "library_ms": float(np.mean(times["library"])),
                     "bound_ms": bound, "bound_by": bound_by})
        del x, kernel, got, want
    torch.cuda.empty_cache()
    batches = sorted({x_shape[0] for x_shape, *_ in shapes})
    log(phase, f"K3 at the train steps' call shapes (forward and dx, batch "
        f"{', '.join(map(str, batches))}) against its plain version, CUDA events (5 "
        "launches, 2 turns): "
        + "; ".join(f"{r['shape']} (calls a step {r['calls']}): max |diff| {r['err']:.3g} "
                    f"(bar {r['bar']:.3g}), K3 {r['ms']:.3f} ms, plain {r['plain_ms']:.3f}, "
                    f"library {r['library_ms']:.3f}, bound {r['bound_ms']:.3f} "
                    f"({r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.0f} %)"
                    for r in rows))
    return rows


def balanced16_cli_config(work: str, scene: dict, out_root: str, suffix: str,
                          **tpu) -> str:
    """Phase "train-balanced16-cli"'s train config: one epoch of
    ``TRAIN_SAMPLES`` at ``tpu.train_precision`` 'balanced16', with ``tpu``
    merged into its ``tpu`` section; runs go to ``out_root``."""
    return write_train_config(
        os.path.join(work, f"train_{suffix}.json"), scene["paths"], out_root,
        suffix=suffix, n_samples=TRAIN_SAMPLES,
        training={"tile_size": TILE, "batch_size": TRAIN_BATCH, "augment": True,
                  "n_epochs": 1},
        optimizer={"name": "Adam", "learning_rate": 2e-4, "weight_decay": 1e-5},
        scheduler={"enabled": True, "name": "StepLR",
                   "settings": {"step_size": 2, "gamma": 0.5}},
        general={"evaluate_rate": 1, "save_model_rate": 3, "random_seed": SEED},
        tpu={"train_precision": "balanced16", **tpu})


def phase_train_balanced16_cli(work: str, scene: dict) -> dict:
    """The train CLI for one epoch at ``tpu.train_precision: "balanced16"``
    (the K3 counters zeroed just before and read just after: 3 launches at
    3 passes a step, none in validation, which runs the float32 policy),
    then its ``Model_best.npz`` served by the inference CLI with K1."""
    from resdepth_tpu_torch import train
    from resdepth_tpu_torch.ops import conv, stitch

    out_root = os.path.join(work, "runs_balanced16")
    config = balanced16_cli_config(work, scene, out_root, "balanced16")
    for key in conv.LAUNCHES:
        conv.LAUNCHES[key] = 0
    start = time.perf_counter()
    trainer = train.main([config, "--device", "cuda"])
    wall = time.perf_counter() - start
    launches = dict(conv.LAUNCHES)
    steps = TRAIN_SAMPLES // TRAIN_BATCH
    want = k3_launches_a_step("balanced16")[3] * steps
    if launches["k3_p3"] != want or launches["k3"] != want:
        raise AssertionError(f"the balanced16 train CLI launched K3 {launches}, "
                             f"expected {want} at 3 passes ({steps} steps)")
    val = list(trainer.val_history)
    if [e for e, _ in val] != [0] or not np.isfinite(val[0][1]):
        raise AssertionError(f"the balanced16 run validated {val}")
    run = run_dir_of(out_root, "balanced16")
    for key in stitch.LAUNCHES:
        stitch.LAUNCHES[key] = 0
    eval_dir = os.path.join(work, "eval_balanced16")
    serve = write_config(os.path.join(work, "serve_balanced16.json"), scene["paths"],
                         serving_model_artifacts(run), eval_dir, tile_size=TILE,
                         batch_size=BATCH)
    run_cli(serve, "cuda")
    prediction = _check_outputs(eval_dir, (TRAIN_SCENE, TRAIN_SCENE))
    if stitch.LAUNCHES["k1"] == 0:
        raise AssertionError("serving the balanced16-trained model launched no K1")
    log("train-balanced16", f"train CLI, tpu.train_precision balanced16, 1 epoch of "
        f"{steps} steps: CLI wall {wall:.1f} s, K3 launches {launches}, val MAE "
        f"{val[0][1]:.4f} m; served Model_best.npz with K1 "
        f"({stitch.LAUNCHES['k1']} launches), scene finite, mean "
        f"{float(prediction.mean()):.2f} m")
    return {"wall_s": wall, "val": val, "launches": launches}


def trace_steps(path: str) -> dict:
    """Read a train trace (``utils/profiler.py``): its ``train#N`` step
    annotations and device activity. Each kernel, copy and memset is given
    to the last step whose device work began at or before it: a step's
    device work begins with the first device op launched from inside its
    annotation (runtime and driver calls link to their ops by
    ``correlation``). Returns the annotation names, the K3 kernel count (by
    name: launched through ctypes, K3 has no operator above it), and per
    step its device-busy ms (the union of its ops' intervals), its device
    span and the host gap before it: the device's idle time from the
    previous step's last op (for the first step, from its annotation's
    start) to this step's first."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    steps = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith("train#")),
                   key=lambda e: e["ts"])
    ops = sorted((e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                         "gpu_memset")),
                 key=lambda e: e["ts"])
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    begins = []
    for step in steps:
        inside = [op["ts"] for op in ops
                  if step["ts"] <= launched.get(op.get("args", {}).get("correlation"), -1)
                  <= step["ts"] + step["dur"]]
        begins.append(min(inside) if inside else None)
    if None in begins:
        raise AssertionError(f"{path}: a step launched no device op: {begins}")
    per_step = [[] for _ in steps]
    for op in ops:
        index = sum(1 for b in begins if b <= op["ts"]) - 1
        if index >= 0:
            per_step[index].append((op["ts"], op["ts"] + op["dur"]))
    rows, previous_end = [], None
    for step, begin, intervals in zip(steps, begins, per_step):
        busy, reach = 0.0, begin
        for start, end in intervals:
            busy += max(0.0, end - max(start, reach))
            reach = max(reach, end)
        end = max(e for _, e in intervals)
        gap_from = step["ts"] if previous_end is None else previous_end
        rows.append({"name": step["name"], "busy_ms": busy / 1e3,
                     "span_ms": (end - begin) / 1e3, "gap_ms": (begin - gap_from) / 1e3,
                     "host_ms": step["dur"] / 1e3})
        previous_end = end
    return {"annotations": [s["name"] for s in steps], "steps": rows,
            "k3": sum(1 for e in events if e.get("cat") == "kernel"
                      and any(k in str(e.get("name", "")) for k in K3_KERNEL_NAMES))}


def phase_profile(work: str, scene: dict) -> dict:
    """The train CLI with ``tpu.profile_dir`` (``utils/profiler.py``) on the
    2048^2 scene. One epoch at 'balanced16' (phase "train-balanced16-cli"'s
    config) traced, and its untraced twin, both under deterministic cuDNN:
    the trace parses, holds one ``train#N`` annotation a step and as many
    K3 kernels as K3's counters counted (3 a step; the counters zeroed just
    before each run and read just after), and the traced run's
    ``Model_last.npz`` (weights, BatchNorm statistics, Adam moments) is
    bitwise the twin's. Then phase 7's float32 'high' epoch traced. For
    both traces, each step's device-busy ms and the host gap before it
    (``trace_steps``)."""
    from resdepth_tpu_torch import train
    from resdepth_tpu_torch.ops import conv
    from resdepth_tpu_torch.train import checkpoint as ckpt_io

    steps = TRAIN_SAMPLES // TRAIN_BATCH
    runs = {}

    def run(name, config, trace_dir):
        for key in conv.LAUNCHES:
            conv.LAUNCHES[key] = 0
        start = time.perf_counter()
        trainer = train.main([config, "--device", "cuda"])
        wall = time.perf_counter() - start
        runs[name] = {"wall": wall, "k3": dict(conv.LAUNCHES),
                      "val": list(trainer.val_history),
                      "last": ckpt_io.load_checkpoint(os.path.join(
                          trainer.checkpoint_dir, "Model_last.npz"))}
        if trace_dir:
            files = os.listdir(trace_dir)
            if len(files) != 1 or not files[0].endswith(".pt.trace.json"):
                raise AssertionError(f"{name}: the trace directory holds {files}")
            path = os.path.join(trace_dir, files[0])
            start = time.perf_counter()
            runs[name]["trace"] = trace_steps(path)
            runs[name]["trace_mb"] = os.path.getsize(path) / 2**20
            runs[name]["parse_s"] = time.perf_counter() - start

    torch.backends.cudnn.deterministic = True
    try:
        for name, traced in (("balanced16", True), ("twin", False)):
            trace_dir = os.path.join(work, f"trace_{name}") if traced else None
            out_root = os.path.join(work, f"runs_profile_{name}")
            run(name, balanced16_cli_config(work, scene, out_root, f"profile_{name}",
                                            **({"profile_dir": trace_dir} if traced else {})),
                trace_dir)
    finally:
        torch.backends.cudnn.deterministic = False
    trace_dir = os.path.join(work, "trace_high")
    high = write_train_config(
        os.path.join(work, "train_profile_high.json"), scene["paths"],
        os.path.join(work, "runs_profile_high"), suffix="profile_high",
        general={"evaluate_rate": 1, "save_model_rate": 3, "random_seed": SEED},
        **{**TRAIN_CLI, "training": {**TRAIN_CLI["training"], "n_epochs": 1},
           "tpu": {**TRAIN_CLI["tpu"], "profile_dir": trace_dir}})
    run("high", high, trace_dir)

    traced, twin = runs["balanced16"], runs["twin"]
    want = [f"train#{i}" for i in range(steps)]
    k3 = k3_launches_a_step("balanced16")[3] * steps
    same = {tree: _same_trees(traced["last"][tree], twin["last"][tree])
            for tree in ("params", "bn_state")}
    same["adam"] = all(_same_trees(a, b) for a, b in zip(traced["last"]["adam"][:2],
                                                        twin["last"]["adam"][:2]))
    problems = []
    for name in ("balanced16", "high"):
        if sorted(runs[name]["trace"]["annotations"],
                  key=lambda n: int(n.split("#")[1])) != want:
            problems.append(f"{name} annotations {runs[name]['trace']['annotations']}")
    if not (traced["k3"]["k3"] == traced["k3"]["k3_p3"] == twin["k3"]["k3_p3"]
            == traced["trace"]["k3"] == k3):
        problems.append(f"K3: counted {traced['k3']} traced, {twin['k3']} untraced, "
                        f"{traced['trace']['k3']} kernels in the trace, expected {k3}")
    if runs["high"]["trace"]["k3"] or runs["high"]["k3"]["k3"]:
        problems.append(f"float32 'high' launched K3: {runs['high']['k3']}")
    if not all(same.values()) or traced["val"] != twin["val"]:
        problems.append(f"traced against untraced: bitwise {same}, val {traced['val']} / "
                        f"{twin['val']}")
    for name in ("balanced16", "high"):
        r = runs[name]
        log("profile", f"{name} epoch traced by the train CLI (tpu.profile_dir): trace "
            f"{r['trace_mb']:.1f} MiB, parsed in {r['parse_s']:.1f} s, CLI wall "
            f"{r['wall']:.1f} s; by step (train#N, from the trace): " + "; ".join(
                f"{row['name']} device busy {row['busy_ms']:.2f} ms, span "
                f"{row['span_ms']:.2f}, host gap before {row['gap_ms']:.2f}, host "
                f"{row['host_ms']:.2f}" for row in r["trace"]["steps"]))
    log("profile", f"balanced16 traced against its untraced twin, deterministic cuDNN: "
        f"walls {traced['wall']:.1f} / {twin['wall']:.1f} s, K3 {traced['trace']['k3']} "
        f"kernels in the trace, counted {traced['k3']['k3_p3']} at 3 passes, "
        f"Model_last.npz bitwise {same}, val {traced['val']}")
    if problems:
        raise AssertionError("; ".join(problems))
    return {"launches": {3: traced["k3"]["k3_p3"] + twin["k3"]["k3_p3"],
                         **{v: traced["k3"][f"k3_{v}"] + twin["k3"][f"k3_{v}"]
                            for v in K3_COUNTED}},
            "steps": {name: runs[name]["trace"]["steps"] for name in ("balanced16", "high")}}


# Phase "channel-modes": the channel modes whose first conv is not 3 wide
# (geom 1, geom-mono and stereo 2, geom-multiview 3-view 4), each with the
# flagship's seeded random weights (``random_model``; no outer skip for
# stereo) on a 1024^2 city with three views (``channel_modes_study``).
CHANNEL_MODES = ("geom", "geom-mono", "stereo", "geom-multiview")
CHANNEL_SCENE = 1024


def phase_channel_modes(work: str) -> dict:
    """For each of ``CHANNEL_MODES``: K3 against its plain version at the
    mode's encoder0 conv (batch 128 of 256^2 tiles, Cin -> 64, relu) at 1
    and 3 passes, within 1e-4 of the largest output (launches counted per
    call, not on the path); the mode's seeded flagship serving the
    ``CHANNEL_SCENE``^2 scene with K2 at float32 and 'balanced16' (rasters
    resident; the counters zeroed just before a counted run and read just
    after: K2 once a batch, K3 the mode's 'balanced16' launches a batch by
    pass count, ``mode_k3_convs``; then the median of 3 timed runs, host
    clock), tiles/s, 'balanced16''s mean deviation from float32; and a
    512^2 crop refined at float32 on the card (K2) and on the CPU, within
    ``CROP_ULPS`` f32 ulps of its largest height."""
    from collections import Counter

    from resdepth_tpu_torch import predict
    from resdepth_tpu_torch.data.pipeline import device_put_dataset
    from resdepth_tpu_torch.infer.tiled import predict_linear_blend, serving_model
    from resdepth_tpu_torch.ops import conv, stitch
    from resdepth_tpu_torch.studies import channel_modes_study as study

    device = torch.device("cuda", 0)
    generator = torch.Generator(device=device).manual_seed(SEED + 2)
    scene = study.make_scene(os.path.join(work, "channel_modes"), TILE + 32, TILE + 32,
                             CHANNEL_SCENE, SEED)
    result, failures, k3_launches, k2_launches = {}, [], Counter(), 0
    for mode in CHANNEL_MODES:
        config = study.mode_config(mode)
        r = {"cin": config.n_input_channels, "k3": {}}
        for passes in (1, 3):
            x, kernel, bias, slope = _conv_inputs(generator, device, torch.float32,
                                                  CONV_BATCH, TILE, TILE,
                                                  config.n_input_channels,
                                                  config.start_kernel)
            for key in conv.LAUNCHES:
                conv.LAUNCHES[key] = 0
            got = conv.conv3x3_bias_act(x, kernel, bias, act_fn="relu", passes=passes)
            torch.cuda.synchronize()
            counted = conv.LAUNCHES[f"k3_p{passes}"]
            want = conv.conv3x3_bias_act_plain(x, kernel, bias, act_fn="relu",
                                               passes=passes)
            err = float((got - want).abs().max())
            bar = 1e-4 * float(want.abs().max())
            r["k3"][passes] = {"err": err, "bar": bar,
                               **_conv_times(conv, x, kernel, bias, slope, "relu",
                                             config.start_kernel, passes)}
            if counted != 1 or not (np.isfinite(err) and err <= bar):
                failures.append(f"{mode} K3 encoder0 at {passes} passes: max |diff| "
                                f"{err} (bar {bar}), counted {counted}")
            del x, got, want
        model = random_model(config)
        ds = study.dev_dataset(mode, scene, TILE)
        rasters = device_put_dataset(ds, device)
        n_batches = -(-len(ds.positions) // BATCH)
        scenes = {}
        for name in ("float32", "balanced16"):
            dtype = predict.select_compute_dtype(name, device)
            served = serving_model(model, device, dtype)

            def scene_run():
                return predict_linear_blend(served, ds, device=device, batch_size=BATCH,
                                            compute_dtype=dtype, rasters=rasters,
                                            use_pallas="fused", fold_bn=False)

            for key in conv.LAUNCHES:
                conv.LAUNCHES[key] = 0
            for key in stitch.LAUNCHES:
                stitch.LAUNCHES[key] = 0
            scenes[name] = scene_run()
            counts = ({p: conv.LAUNCHES[f"k3_p{p}"] for p in (1, 2, 3)
                       if conv.LAUNCHES[f"k3_p{p}"]}, stitch.LAUNCHES["k2"])
            for variant in K3_COUNTED:
                k3_launches[variant] += conv.LAUNCHES[f"k3_{variant}"]
            want = ({p: n * n_batches for p, n in Counter(
                c[4] for c in mode_k3_convs(name, config)).items()}
                    if name != "float32" else {}, n_batches)
            if counts != want or not np.isfinite(scenes[name]).all():
                failures.append(f"{mode} {name} scene: K3 and K2 launches {counts}, "
                                f"expected {want}; finite {np.isfinite(scenes[name]).all()}")
            k3_launches.update(counts[0])
            k2_launches += counts[1]
            walls = []
            for _ in range(3):
                start = time.perf_counter()
                scene_run()
                walls.append(time.perf_counter() - start)
            r[f"{name}_tiles_per_s"] = len(ds.positions) / float(np.median(walls))
        valid = scene["dev_gt"] != -9999.0
        r["balanced16_dev_cm"] = 100 * float(
            np.abs(scenes["balanced16"] - scenes["float32"])[valid].mean())

        crop = study.dev_dataset(mode, scene, TILE, {"x_extent": [(0, CROP_SIZE - 1)],
                                                     "y_extent": [(0, CROP_SIZE - 1)]})
        outputs = {name: predict_linear_blend(model, crop, device=on, batch_size=BATCH,
                                              compute_dtype=predict.select_compute_dtype(
                                                  "float32", on), use_pallas="fused")
                   for name, on in (("card", device), ("cpu", torch.device("cpu")))}
        r["crop_err"] = float(np.abs(outputs["card"] - outputs["cpu"]).max())
        r["crop_ulps"] = r["crop_err"] / ulps(outputs["cpu"], 1)
        if not (np.isfinite(outputs["card"]).all() and r["crop_ulps"] <= CROP_ULPS):
            failures.append(f"{mode} crop: card against CPU {r['crop_err']} m = "
                            f"{r['crop_ulps']:.2f} ulps (bar {CROP_ULPS})")
        result[mode] = r
        del model, rasters
        torch.cuda.empty_cache()
    log("channel-modes", f"seeded flagship at each channel mode, {CHANNEL_SCENE}^2 scene "
        f"({n_batches} batch of up to {BATCH}), K2: " + "; ".join(
            f"{m} (Cin {r['cin']}): K3 encoder0 {CONV_BATCH}x{TILE}^2 {r['cin']}->64 relu "
            + ", ".join(f"{p} pass{'es' if p > 1 else ''} max |diff| {k['err']:.3g} (bar "
                        f"{k['bar']:.3g}), K3 {k['ms']:.3f} ms, plain {k['plain_ms']:.3f}, "
                        f"library {k['library_ms']:.3f}, bound {k['bound_ms']:.3f} "
                        f"({k['bound_by']})" for p, k in r["k3"].items())
            + f"; serving float32 {r['float32_tiles_per_s']:.1f} tiles/s, balanced16 "
            f"{r['balanced16_tiles_per_s']:.1f} tiles/s (host clock, median of 3), "
            f"balanced16 mean |dev| from float32 {r['balanced16_dev_cm']:.4f} cm; "
            f"{CROP_SIZE}^2 crop float32 card (K2) vs CPU max |diff| {r['crop_err']:.3g} m "
            f"= {r['crop_ulps']:.2f} ulps (bar {CROP_ULPS})" for m, r in result.items())
        + f"; counted launches K3 {dict(k3_launches)}, K2 {k2_launches}")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"modes": result, "launches": {**k3_launches, "k2": k2_launches}}


# Phases "studies" and "config-smoke": the studies of
# ``resdepth_tpu_torch/studies`` at small sizes, and sampled CLI cases of
# narrow models, with every kernel call held to its plain version.
STUDY_STEPS = 24                 # training steps of the state cache
STUDY_SCENE = 1024               # the stride and TTA x stride studies' city
SMOKE_SEED, SMOKE_CASES = 21, 3  # config_smoke's draws: 16-px tiles, Cout 4 and 8


def _zero_counters() -> None:
    from resdepth_tpu_torch.ops import conv, stitch

    for counters in (conv.LAUNCHES, stitch.LAUNCHES):
        for key in counters:
            counters[key] = 0


def _read_counters() -> dict:
    """The launches since ``_zero_counters``: K3 by float32 pass count
    (1, 2, 3), its kernels counted by name (``K3_COUNTED``), and "k1",
    "k2"."""
    from resdepth_tpu_torch.ops import conv, stitch

    counts = {p: conv.LAUNCHES[f"k3_p{p}"] for p in (1, 2, 3) if conv.LAUNCHES[f"k3_p{p}"]}
    for variant in K3_COUNTED:
        if conv.LAUNCHES[f"k3_{variant}"]:
            counts[variant] = conv.LAUNCHES[f"k3_{variant}"]
    counts.update(stitch.LAUNCHES)
    return counts


@contextlib.contextmanager
def held_kernels(record: dict):
    """While the block runs, every kernel call on the card is held to its
    plain version on the same inputs, as it is made: K3 (its wrapper as
    ``models.unet`` and ``ops.passes`` call it) to ``conv3x3_bias_act_plain``
    within 1e-4 of the largest output, K2 bitwise and K1 within
    ``k1_ulps`` of the cover to the plain stitch on the CPU over a copy of
    the canvas, the trunk epilogue bitwise to its plain version, the upconv
    to ``upconv2x2_skip_plain`` within 1e-4 of the largest output. The
    plain versions launch no kernel, so the counters see only the path's
    launches. ``record["k3"]`` gets ``(x shape, Cout, passes, err, bar)`` a
    call, ``record["upconv"]`` the same, ``record["k1"]``/``["k2"]``
    ``(tile, batch, canvas shape, err, bar)``, ``record["epilogue"]``
    ``(shape, 0.0, 0.0)``; a call out of its bar raises."""
    from unittest import mock

    from resdepth_tpu_torch.models import unet
    from resdepth_tpu_torch.ops import conv, epilogue, stitch, upconv

    k3, stitch_call = conv.conv3x3_bias_act, stitch.stitch_tiles
    trunk, skip_add = epilogue.trunk_epilogue, epilogue.skip_add_epilogue
    up = upconv.upconv2x2_skip
    for key in ("k1", "k2", "k3", "epilogue", "upconv"):
        record.setdefault(key, [])

    def held(kernel, plain, first, *args, **kwargs):
        got = kernel(first, *args, **kwargs)
        if first.device.type == "cuda":
            want = plain(first, *args, **kwargs)
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            if not all(_same_bits(g, w) for g, w in pairs):
                raise AssertionError(f"the trunk epilogue at {tuple(first.shape)} differs "
                                     f"from its plain version")
            record["epilogue"].append((tuple(first.shape), 0.0, 0.0))
        return got

    def k3_held(x, kernel, bias=None, act_param=None, *, act_fn="relu", passes=None):
        y = k3(x, kernel, bias, act_param, act_fn=act_fn, passes=passes)
        if x.device.type == "cuda":
            want = conv.conv3x3_bias_act_plain(x, kernel, bias, act_param, act_fn=act_fn,
                                               passes=passes)
            err = float((y.float() - want.float()).abs().max())
            bar = 1e-4 * float(want.abs().max())
            record["k3"].append((tuple(x.shape), int(kernel.shape[3]), passes, err, bar))
            if not err <= bar:
                raise AssertionError(f"K3 at {tuple(x.shape)} -> {kernel.shape[3]} "
                                     f"({passes} passes): max |diff| {err} above {bar}")
        return y

    def upconv_held(x, weight, bias, skip, passes):
        y = up(x, weight, bias, skip, passes)
        if x.device.type == "cuda":
            want = upconv.upconv2x2_skip_plain(x, weight, bias, skip, passes)
            err = float((y - want).abs().max())
            bar = 1e-4 * float(want.abs().max())
            record["upconv"].append((tuple(x.shape), int(weight.shape[1]), passes, err, bar))
            if not err <= bar:
                raise AssertionError(f"the upconv at {tuple(x.shape)} -> {weight.shape[1]} "
                                     f"({passes} passes): max |diff| {err} above {bar}")
        return y

    def stitch_held(scene, tiles, positions, wy, wx, means, sigma, use_pallas=None,
                    bounds=None):
        if scene.device.type != "cuda":
            return stitch_call(scene, tiles, positions, wy, wx, means, sigma,
                               use_pallas=use_pallas, bounds=bounds)
        before = scene.cpu()
        stitch_call(scene, tiles, positions, wy, wx, means, sigma, use_pallas=use_pallas,
                    bounds=bounds)
        got = scene.cpu().numpy()
        batch = {k: v.cpu() for k, v in (("tiles", tiles), ("positions", positions),
                                         ("wy", wy), ("wx", wx), ("means", means))}
        want = stitch.stitch_tiles_plain(before, *_stitch_args(batch, "cpu"),
                                         float(sigma)).numpy()
        err = float(np.abs(got - want).max())
        key = "k2" if use_pallas == "fused" else "k1"
        bar = 0.0 if key == "k2" else ulps(want, k1_ulps(max_cover([batch], want.shape)))
        record[key].append((tiles.shape[-1], tiles.shape[0], want.shape, err, bar))
        if not (err <= bar and (key == "k1" or np.array_equal(got, want))):
            raise AssertionError(f"{key.upper()} at T={tiles.shape[-1]} B={tiles.shape[0]} "
                                 f"on {want.shape}: max |diff| {err} above {bar}")
        return scene

    with mock.patch.object(conv, "conv3x3_bias_act", k3_held), \
            mock.patch.object(unet, "conv3x3_bias_act", k3_held), \
            mock.patch.object(stitch, "stitch_tiles", stitch_held), \
            mock.patch.object(epilogue, "trunk_epilogue", functools.partial(
                held, trunk, epilogue.trunk_epilogue_plain)), \
            mock.patch.object(epilogue, "skip_add_epilogue", functools.partial(
                held, skip_add, epilogue.skip_add_epilogue_plain)), \
            mock.patch.object(upconv, "upconv2x2_skip", upconv_held):
        yield record


def _held_summary(record: dict) -> str:
    parts = []
    for key in ("k3", "k2", "k1", "epilogue", "upconv"):
        calls = record.get(key, [])
        if calls:
            worst = max(calls, key=lambda c: c[-2] / c[-1] if c[-1] else c[-2])
            parts.append(f"{key.upper()} {len(calls)} calls held, worst max |diff| "
                         f"{worst[-2]:.3g} (bar {worst[-1]:.3g})")
    return "; ".join(parts) or "no kernel call"


def phase_studies(work: str) -> dict:
    """The studies on the card at small sizes, each run with the launch
    counters zeroed just before and read just after: ``precision_study``'s
    state cache (``STUDY_STEPS`` 'default' steps of the flagship on its
    512x768 city) written and read back bitwise, and ``--attrib`` on it
    (``run_attribution``: K3 at 3 and 1 passes held at every conv it is
    handed, ``held_kernels``); ``stride_study`` and ``tta_stride_study`` on a
    ``STUDY_SCENE``^2 city, strides 128 and 192 x TTA 1 and 4 at
    'balanced16' (K2 bitwise the plain stitch at every call, K3 held);
    ``bilinear_study`` at 8 steps (its ``balanced16`` forward hands K3 two
    convs: no composed top); ``train_throughput_study`` at 'default' batch
    20 and ``train_roofline --measure`` at 'balanced16' batch 20."""
    from resdepth_tpu_torch.studies import (bilinear_study, precision_study,
                                            stride_study, train_roofline,
                                            train_throughput_study, tta_stride_study)

    device = torch.device("cuda", 0)
    os.makedirs(work, exist_ok=True)
    cache = os.path.join(work, "study_state_s3.npz")
    config = precision_study.study_config()
    key = precision_study.study_key(3, STUDY_STEPS, 512, 768, TRAIN_BATCH, "default")
    launches, lines, held = {}, [], {}

    def counted(name, fn):
        _zero_counters()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = _read_counters()
        lines.append(f"{name} {time.perf_counter() - start:.1f} s, launches {launches[name]}")
        return out

    _, train_ds, test_ds = precision_study._scene(work, 512, 768, 3, TILE)
    model, first, last = counted("cache training", lambda: precision_study._train(
        config, train_ds, device, STUDY_STEPS, TRAIN_BATCH, 3, "default"))
    precision_study.save_state_cache(cache, model, key)
    loaded, _ = precision_study.load_state_cache(cache, config, device, key)
    if not all(torch.equal(v, loaded.state_dict()[k]) for k, v in model.state_dict().items()):
        raise AssertionError("the state cache does not read back bitwise")
    with held_kernels(held.setdefault("attrib", {})):
        attrib = counted("attrib", lambda: precision_study.run_attribution(
            loaded, test_ds, train_ds.dsm_std, device))
    if not (launches["attrib"].get(1) and launches["attrib"].get(3)):
        raise AssertionError(f"--attrib launched K3 {launches['attrib']}: 1 and 3 passes "
                             "expected")
    city = ["--state-cache", cache, "--rows", str(STUDY_SCENE), "--cols", str(STUDY_SCENE),
            "--mode", "balanced16", "--strides", "128", "192"]
    with held_kernels(held.setdefault("stride", {})):
        stride = counted("stride_study", lambda: stride_study.main(city))
    with held_kernels(held.setdefault("tta_stride", {})):
        grid = counted("tta_stride_study", lambda: tta_stride_study.main(
            city + ["--ttas", "1", "4"]))
    for name in ("stride_study", "tta_stride_study"):
        if not (launches[name].get("k2") and launches[name].get(3)):
            raise AssertionError(f"{name} launched {launches[name]}: K2 and K3 expected")
    with held_kernels(held.setdefault("bilinear", {})):
        bilinear = counted("bilinear_study", lambda: bilinear_study.main(
            ["--steps", "8", "--batch", "4", "--dev-rows", "512", "--bench-batch", "32",
             "--iters", "2"]))
    throughput = counted("train_throughput_study", lambda: train_throughput_study.main(
        ["--modes", "default", "--batches", str(TRAIN_BATCH), "-K", "4", "--windows", "2"]))
    roofline = counted("train_roofline", lambda: train_roofline.main(
        ["--modes", "balanced16", "--batches", str(TRAIN_BATCH), "--measure"]))
    if not np.isfinite([c["mae_m"] for c in stride["cells"] + grid["cells"]]).all():
        raise AssertionError("a study cell's MAE is not finite")
    top = ", ".join(f"{n} {attrib['solo_cm'][n]:.4f}" for n in attrib["ranked"][:3])
    log("studies", f"state cache {STUDY_STEPS} 'default' steps (train MAE {first:.3f} -> "
        f"{last:.3f} m), read back bitwise; attrib {attrib['tiles']} tiles: all-DEFAULT "
        f"{attrib['all_default_cm']:.4f} cm, first of the ranked solo demotions {top} cm; "
        "stride study " + ", ".join(
            f"{c['stride']}: {c['tiles']} tiles {c['device_s']:.4f} s MAE {c['mae_m']:.4f} m"
            for c in stride["cells"])
        + "; TTA x stride " + ", ".join(
            f"({c['stride']}, {c['tta']}) {c['device_s']:.4f} s MAE {c['mae_m']:.4f}"
            for c in grid["cells"])
        + f"; bilinear balanced16 dev {bilinear['bilinear_balanced16_dev_cm']:.4f} cm, "
        f"tiles/s f32 {bilinear['bilinear_f32_tiles_s']:.1f} (transpose "
        f"{bilinear['transpose_f32_tiles_s']:.1f}); throughput default B=20 "
        f"{throughput[0]['step_ms']:.2f} ms a step; roofline balanced16 B=20 measured "
        f"{roofline[0]['measured_samples_per_s']:.1f} samples/s = "
        f"{roofline[0]['pct_of_roofline']:.1f} % of {roofline[0]['ceiling_samples_per_s']:.1f}"
        f", {roofline[0]['pct_of_achievable']:.1f} % of the achievable "
        f"{roofline[0]['achievable_samples_per_s']:.1f}; " + "; ".join(lines)
        + "; held: " + "; ".join(f"{k}: {_held_summary(v)}" for k, v in held.items()))
    total = {}
    for counts in launches.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return {"launches": total}


def phase_config_smoke(work: str) -> dict:
    """``studies/config_smoke.py``'s first ``SMOKE_CASES`` cases of seed
    ``SMOKE_SEED`` on the card through the CLIs in this process (narrow
    models on 16- and 32-px tiles: training at 'high', 'default' and
    'balanced', serving 'mixed', 'balanced' and bfloat16 with K1), then
    each served case again with K2 (``use_pallas: "fused"``); every kernel
    call held (``held_kernels``), the counters zeroed just before and read
    just after. K3 must have met 4 and 8 output channels and 16-px images,
    K2 and K1 16-px windows."""
    from resdepth_tpu_torch.studies import config_smoke

    root = os.path.join(work, "config_smoke")
    record = {}
    _zero_counters()
    start = time.perf_counter()
    with held_kernels(record):
        result = config_smoke.run_cases(SMOKE_SEED, SMOKE_CASES, root, "cuda",
                                        run=config_smoke.run_in_process)
        fused = 0
        for i, case in enumerate(result["cases"]):
            if case["eval"] is None:
                continue
            cfg = json.loads(json.dumps(case["eval"]))
            cfg["general"]["use_pallas"] = "fused"
            cfg["output"]["directory"] += "_k2"
            path = os.path.join(root, f"case{i}", "eval_k2.json")
            with open(path, "w") as f:
                json.dump(cfg, f)
            code, output = config_smoke.run_in_process("resdepth_tpu_torch.predict", path,
                                                       "cuda")
            if code != 0:
                raise AssertionError(f"case{i} served with K2 failed: {output}")
            fused += 1
    launches = _read_counters()
    seconds = time.perf_counter() - start
    if result["fails"]:
        raise AssertionError(f"config smoke: {result['fails']} of {SMOKE_CASES} cases failed")
    k3_couts = {c[1] for c in record["k3"]}
    k3_tiles = {c[0][1] for c in record["k3"]}
    if not ({4, 8} <= k3_couts and 16 in k3_tiles and launches.get("k2")
            and any(c[0] == 16 for c in record["k2"]) and any(c[0] == 16 for c in record["k1"])):
        raise AssertionError(f"config smoke: K3 met Cout {sorted(k3_couts)} at sizes "
                             f"{sorted(k3_tiles)}, K2 {len(record['k2'])} calls, K1 "
                             f"{len(record['k1'])}: the narrow shapes did not all run")
    log("config-smoke", f"seed {SMOKE_SEED}, {SMOKE_CASES} cases in {seconds:.1f} s: "
        + "; ".join(c["tag"] + (f" served {c['eval']['general']}" if c["eval"] else "")
                    for c in result["cases"])
        + f"; {fused} served again with K2; launches {launches}; K3 shapes (x, Cout, "
        f"passes): {sorted({(c[0], c[1], c[2]) for c in record['k3']})}; "
        f"{_held_summary(record)}")
    return {"launches": launches}


# Phase "train-banded": one epoch of the 2048^2 training scene (4 raster
# planes, 16,777,216 px resident) under banded residency at a 1-D budget
# (768-row windows) and a 2-D one (627^2 windows), at float32 'high' and
# 'balanced16', each against its band_resident=False twin.
BANDED_BUDGETS = {"1-D": 6_291_456, "2-D": 1_572_864}
BANDED_POLICIES = ("high", "balanced16")


def _max_rel_diff(a: dict, b: dict) -> float:
    """The largest relative L2 difference between two state dicts' tensors."""
    return max(float((a[k].double() - b[k].double()).norm()
                     / max(float(b[k].double().norm()), 1e-30)) for k in b)


def phase_train_banded(work: str, scene: dict, resident: dict) -> dict:
    """The ``Trainer`` for one epoch (augmentation on) on
    ``make_banded_loaders`` at each of ``BANDED_BUDGETS`` and
    ``BANDED_POLICIES``, and on its ``band_resident=False`` twin (the same
    windows, seeds and batch order, the full scene resident), from the same
    seeded weights. The steps are not deterministic as they run (cuDNN's
    weight gradients), so the two are first run with
    ``torch.backends.cudnn.deterministic``: the banded weights after the
    epoch must be bitwise the twin's. Then both run as the train CLI runs
    them, timed; the gap between their weights is reported (largest
    relative L2 over the tensors). Each banded run's source uploads each
    window once and holds none after ``train()``; the K3 counters are
    zeroed just before each banded run and read just after
    (``k3_launches_a_step`` a step). Reported: windows, steps, samples/s
    over the epoch (host clock, synchronised) beside the twin's and the
    resident figure of "train-precisions" (``resident``), the steady step
    time (CUDA events) and peak memory. Then the train CLI for one epoch
    under ``tpu.max_device_pixels``: it logs its bands and writes
    ``Model_best.npz``."""
    import logging

    from resdepth_tpu_torch import train
    from resdepth_tpu_torch.data import banded
    from resdepth_tpu_torch.data.pipeline import batch_spec_for
    from resdepth_tpu_torch.models.unet import flagship_config, init_unet
    from resdepth_tpu_torch.ops import conv
    from resdepth_tpu_torch.train.step import (init_train_state, make_train_step,
                                               select_train_precision)
    from resdepth_tpu_torch.train.trainer import Trainer

    device = torch.device("cuda", 0)
    ds = _train_dataset(scene, TRAIN_SCENE, TILE, TRAIN_SAMPLES)
    spec = batch_spec_for(ds, augment=True)
    config = flagship_config("geom-stereo")
    quiet = logging.getLogger("chip_smoke.train_banded")
    quiet.setLevel(logging.WARNING)

    def run(policy, budget, band_resident, tag):
        kwargs, dtype = select_train_precision(*TRAIN_POLICIES[policy], device)
        model = init_unet(config, torch.Generator().manual_seed(SEED), device)
        step = make_train_step(spec, weighted_bn=True, compute_dtype=dtype, **kwargs)
        events = []

        def timed_step(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metric = step(*args)
            end.record()
            events.append((start, end, metric))
            return metric

        loaders = banded.make_banded_loaders(ds, TRAIN_BATCH, max_device_pixels=budget,
                                             seed=SEED, device=device,
                                             band_resident=band_resident)
        trainer = Trainer(state=init_train_state(model, "Adam", 2e-4, 1e-5),
                          train_step=timed_step, eval_step=None,
                          train_loaders=loaders, val_loaders=[], n_epochs=1,
                          checkpoint_dir=os.path.join(work, "banded", tag),
                          rng_seed=SEED, logger=quiet, group_chunks_by_loader=True)
        epoch = trainer.train_one_epoch
        walls = []

        def timed_epoch(index, **kwargs):
            start = time.perf_counter()
            meter = epoch(index, **kwargs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
            return meter

        trainer.train_one_epoch = timed_epoch
        for key in conv.LAUNCHES:
            conv.LAUNCHES[key] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        trainer.train()
        k3 = conv.LAUNCHES["k3"]
        narrow = {v: conv.LAUNCHES[f"k3_{v}"] for v in K3_COUNTED}
        metrics = [float(m) for _, _, m in events]
        if not np.isfinite(metrics).all():
            raise AssertionError(f"{tag}: train metrics {metrics}")
        step_ms = [s.elapsed_time(e) for s, e, _ in events]
        out = {"windows": len(loaders), "steps": len(events), "k3": k3, "narrow": narrow,
               "samples_per_s": TRAIN_SAMPLES / walls[0], "epoch_s": walls[0],
               "step_ms": float(np.mean(step_ms[TRAIN_WARMUP:] or step_ms)),
               "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
               "weights": {k: v.detach().cpu() for k, v in model.state_dict().items()}}
        if band_resident:
            source = loaders[0][0].source
            out["uploads"], out["resident_after"] = source.uploads, source._resident
            out["window"] = (source.window_rows, source.window_cols)
        del trainer, model, loaders
        torch.cuda.empty_cache()
        return out

    def checked(tag, policy, b):
        want_k3 = sum(k3_launches_a_step(policy).values()) * b["steps"]
        if (b["uploads"] != b["windows"] or b["resident_after"] is not None
                or b["k3"] != want_k3):
            raise AssertionError(
                f"train-banded {tag}: {b['uploads']} uploads for {b['windows']} "
                f"windows, a window left resident: {b['resident_after'] is not None}, "
                f"K3 launched {b['k3']} times in {b['steps']} steps (expected {want_k3})")
        for v, c in b["narrow"].items():
            narrow[v] += c
        return b["k3"]

    result, lines, launches, narrow = {}, [], 0, {v: 0 for v in K3_COUNTED}
    for policy in BANDED_POLICIES:
        for budget_name, budget in BANDED_BUDGETS.items():
            tag = f"{policy}-{budget_name}"
            torch.backends.cudnn.deterministic = True
            try:
                exact = {"banded": run(policy, budget, True, f"{tag}-banded-exact"),
                         "twin": run(policy, budget, False, f"{tag}-twin-exact")}
            finally:
                torch.backends.cudnn.deterministic = False
            launches += checked(tag, policy, exact["banded"])
            exact_gap = _max_rel_diff(exact["banded"]["weights"], exact["twin"]["weights"])
            if not all(torch.equal(a, exact["twin"]["weights"][k])
                       for k, a in exact["banded"]["weights"].items()):
                raise AssertionError(f"train-banded {tag}: with deterministic cuDNN the "
                                     f"banded weights differ from the twin's by "
                                     f"{exact_gap:.3g} (largest relative L2)")
            twin = run(policy, budget, False, f"{tag}-twin")
            b = run(policy, budget, True, f"{tag}-banded")
            launches += checked(tag, policy, b)
            if b["steps"] != twin["steps"]:
                raise AssertionError(f"train-banded {tag}: {b['steps']} steps, the "
                                     f"twin {twin['steps']}")
            gap = _max_rel_diff(b["weights"], twin["weights"])
            result[tag] = {"gap": gap, **{k: v for k, v in b.items() if k != "weights"},
                           "twin_samples_per_s": twin["samples_per_s"],
                           "twin_step_ms": twin["step_ms"],
                           "twin_peak_gib": twin["peak_gib"]}
            lines.append(
                f"{tag}: {b['windows']} windows of {b['window'][0]}x{b['window'][1]} px, "
                f"{b['steps']} steps, uploads {b['uploads']}; weights bitwise the "
                f"twin's with deterministic cuDNN; as the CLI runs: epoch "
                f"{b['epoch_s']:.2f} s = {b['samples_per_s']:.1f} samples/s (twin "
                f"{twin['samples_per_s']:.1f}; resident \"train-precisions\" "
                f"{resident[policy]['samples_per_s']:.1f} at 10 full steps), step "
                f"{b['step_ms']:.2f} ms (twin {twin['step_ms']:.2f}), peak "
                f"{b['peak_gib']:.2f} GiB (twin {twin['peak_gib']:.2f}), K3 "
                f"{b['k3'] // b['steps']} a step; weights vs twin {gap:.3g} rel L2 "
                f"(cuDNN's nondeterminism over the epoch)")
    log("train-banded", f"Trainer, one epoch of {TRAIN_SAMPLES} samples (batch "
        f"{TRAIN_BATCH}, augmentation on), banded residency against its resident "
        "twin: " + "; ".join(lines))

    out_root = os.path.join(work, "runs_banded")
    budget = BANDED_BUDGETS["1-D"]
    cfg = write_train_config(
        os.path.join(work, "train_banded.json"), scene["paths"], out_root,
        suffix="banded", n_samples=TRAIN_SAMPLES,
        training={"tile_size": TILE, "batch_size": TRAIN_BATCH, "augment": True,
                  "n_epochs": 1},
        optimizer={"name": "Adam", "learning_rate": 2e-4, "weight_decay": 1e-5},
        scheduler={"enabled": True, "name": "StepLR",
                   "settings": {"step_size": 2, "gamma": 0.5}},
        general={"evaluate_rate": 1, "save_model_rate": 3, "random_seed": SEED},
        tpu={"train_precision": "balanced16", "max_device_pixels": budget})
    for key in conv.LAUNCHES:
        conv.LAUNCHES[key] = 0
    start = time.perf_counter()
    trainer = train.main([cfg, "--device", "cuda"])
    wall = time.perf_counter() - start
    cli_k3 = conv.LAUNCHES["k3"]
    if not (cli_k3 > 0 and cli_k3 == conv.LAUNCHES["k3_p3"]
            and cli_k3 % k3_launches_a_step("balanced16")[3] == 0):
        raise AssertionError(f"the banded balanced16 train CLI launched K3 {conv.LAUNCHES}")
    run_dir = run_dir_of(out_root, "banded")
    with open(os.path.join(run_dir, "run.log")) as f:
        banded_lines = [line.strip() for line in f if "banded residency," in line]
    if (not any(line.startswith("train region") for line in banded_lines)
            or not os.path.exists(os.path.join(run_dir, "checkpoints", "Model_best.npz"))
            or not np.isfinite(trainer.val_history[0][1])):
        raise AssertionError(f"the banded train CLI run logged {banded_lines}, val "
                             f"{trainer.val_history}, wrote "
                             f"{os.listdir(os.path.join(run_dir, 'checkpoints'))}")
    launches += cli_k3
    for v in narrow:
        narrow[v] += conv.LAUNCHES[f"k3_{v}"]
    log("train-banded", f"train CLI, balanced16, tpu.max_device_pixels {budget:,}, 1 "
        f"epoch: CLI wall {wall:.1f} s; {' | '.join(banded_lines)}; val MAE "
        f"{trainer.val_history[0][1]:.4f} m; K3 launches {cli_k3}; wrote Model_best.npz")
    return {"runs": result, "launches": {3: launches, **narrow}}


def _share_decisions(model, card: dict | None = None):
    """Forward hooks on ``model``'s max-pools and ReLUs.

    Without ``card`` they record each module's discrete decisions (pooling
    argmax, ReLU mask) in the returned dict. With ``card``, the decisions
    such hooks recorded on the card, each module takes the card's decision
    (its output, and so its gradient, is what it would be had it decided
    so) and counts the places where it would have decided otherwise."""
    decisions, flips = {}, {"pool": 0, "relu": 0}
    modules = [("pool", m) for m in model.modules() if isinstance(m, nn.MaxPool2d)]
    modules += [("relu", m) for m in model.modules() if isinstance(m, nn.ReLU)]
    for index, (kind, module) in enumerate(modules):
        def hook(mod, inputs, output, index=index, kind=kind):
            x = inputs[0]
            own = (F.max_pool2d(x, 2, 2, return_indices=True)[1] if kind == "pool"
                   else x > 0)
            if card is None:
                decisions[index] = own.cpu()
                return None
            chosen = card[index].to(x.device)
            flips[kind] += int((own != chosen).sum())
            if kind == "pool":
                pooled = x.flatten(2).gather(2, chosen.flatten(2)).view_as(output)
                # in the module's own layout: the next conv sums in the order
                # its layout picks
                channels_last = output.is_contiguous(memory_format=torch.channels_last)
                return pooled.contiguous(
                    memory_format=torch.channels_last if channels_last
                    else torch.contiguous_format)
            return x * chosen.to(x.dtype)
        module.register_forward_hook(hook)
    return decisions, flips


def phase_train_vs_cpu(scene: dict) -> dict:
    """One flagship train step (2 tiles of 128 px, augmentation off) on the
    card and on the CPU from the same weights and batch, at each training
    policy (``TRAIN_POLICIES``).

    A step's gradient is not a continuous function of rounding: where two
    pooled values or a ReLU input lie within an f32 rounding of a tie, the
    card and the CPU may route a gradient differently, and one such place
    moves a whole weight gradient by about 1e-3 (measured on this batch).
    So the CPU step takes the card's pooling and ReLU decisions, the number
    of places it would have decided otherwise is printed, and what is held
    is the arithmetic: for float32 'high' the loss, gradients, BatchNorm
    statistics and Adam moments within 1e-4 relative per tensor. The other
    policies round operands to bf16 (each pass's operands, or the bf16
    trunk's activations), and an activation that the two devices sum in
    another order rounds the other way now and then: their batch
    statistics' relative L2 card against CPU is held to
    ``TRAIN_ROUNDED_SHARE`` of the policy's own gap to the float32 step on
    the card, a bar the float32 step's, in the policy's place, must miss;
    the same shares of their gradients are printed."""
    from resdepth_tpu_torch.data.pipeline import (GeneratorDraws, batch_spec_for,
                                                  device_put_dataset)
    from resdepth_tpu_torch.models.unet import flagship_config, init_unet
    from resdepth_tpu_torch.train.step import (init_train_state, make_train_step,
                                               select_train_precision)

    ds = _train_dataset(scene, 512, 128, 2)
    # A fixed DSM mean (the region's): the per-tile masked means sum in
    # another order on each device, and with it both devices take the same
    # batch bit for bit (phase 5 holds the per-tile means on the card).
    region = ds.dsm_input[:512, :512]
    spec = dataclasses.replace(batch_spec_for(ds), dsm_mean=float(
        region[region != ds.nodata].mean()))
    batch = (ds.positions, ds.pair_indices, np.zeros((2, 4), np.int32),
             np.ones(2, np.float32))
    runs, flips = {}, {}
    for policy, (train_precision, compute_dtype) in TRAIN_POLICIES.items():
        card_decisions = None
        for name in ("cuda", "cpu"):
            device = torch.device(name, 0) if name == "cuda" else torch.device("cpu")
            kwargs, dtype = select_train_precision(train_precision, compute_dtype, device)
            model = init_unet(flagship_config("geom-stereo"),
                              torch.Generator().manual_seed(SEED), device)
            decisions, flips[policy] = _share_decisions(model, card_decisions)
            card_decisions = card_decisions or decisions
            state = init_train_state(model, "Adam", 2e-4, 1e-5)
            rasters = device_put_dataset(ds, device, include_target=True)
            metric = make_train_step(spec, compute_dtype=dtype, **kwargs)(
                state, rasters, *batch, GeneratorDraws(torch.Generator(device=device)))
            runs[policy, name] = {
                "metric": float(metric),
                "grads": {n: p.grad.detach().cpu().numpy()
                          for n, p in model.named_parameters()},
                "buffers": {n: b.detach().cpu().numpy()
                            for n, b in model.named_buffers()
                            if n.endswith(("running_mean", "running_var"))},
                # second moments as their square roots, at the gradients'
                # scale and relative error
                "moments": {**{f"{n}.exp_avg": state.optimizer.state[p][
                                   "exp_avg"].cpu().numpy()
                               for n, p in model.named_parameters()},
                            **{f"{n}.sqrt_exp_avg_sq": state.optimizer.state[p][
                                   "exp_avg_sq"].sqrt().cpu().numpy()
                               for n, p in model.named_parameters()}},
                "params": {n: p.detach().cpu().numpy()
                           for n, p in model.named_parameters()}}
            del model, state, rasters
        torch.cuda.empty_cache()

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    def flat(run, group):
        return np.concatenate([v.ravel() for _, v in sorted(run[group].items())])

    result, failed, lines = {}, {}, []
    for policy in TRAIN_POLICIES:
        card, cpu = runs[policy, "cuda"], runs[policy, "cpu"]
        loss_err = abs(card["metric"] - cpu["metric"]) / abs(cpu["metric"])
        worst = {}
        for group in ("grads", "buffers", "moments"):
            errs = {n: rel(card[group][n], cpu[group][n]) for n in cpu[group]}
            name = max(errs, key=errs.get)
            worst[group] = (name, errs[name])
        param_err = max(float(np.abs(card["params"][n] - cpu["params"][n]).max())
                        for n in cpu["params"])
        r = {"loss_rel": loss_err, "flips": flips[policy],
             **{g: v[1] for g, v in worst.items()}}
        line = (f"{policy}: loss card {card['metric']:.6f} m, CPU {cpu['metric']:.6f} m "
                f"(rel {loss_err:.3g}); places the CPU would have pooled or rectified "
                f"otherwise: {flips[policy]}; worst relative L2 per tensor "
                + ", ".join(f"{g} {v[1]:.3g} ({v[0]})" for g, v in worst.items())
                + f"; max |weight diff| after the step {param_err:.3g}")
        if policy == "high":
            if any(v[1] > 1e-4 for v in worst.values()) or not loss_err <= 1e-4:
                failed[policy] = r
            line += " (bar 1e-4)"
        else:
            f32 = runs["high", "cuda"]
            for group in ("buffers", "grads"):
                own = rel(flat(card, group), flat(f32, group))
                r[f"{group}_share"] = (rel(flat(card, group), flat(cpu, group)) / own,
                                       rel(flat(f32, group), flat(cpu, group)) / own, own)
            share, control, own = r["buffers_share"]
            if not share <= TRAIN_ROUNDED_SHARE < control:
                failed[policy] = r
            line += (f"; BatchNorm statistics card vs CPU {share:.3g} of the policy's "
                     f"own gap to the float32 step ({own:.3g} relative L2; bar "
                     f"{TRAIN_ROUNDED_SHARE}, the float32 step in its place "
                     f"{control:.3g}); gradients {r['grads_share'][0]:.3g} of their own "
                     f"gap ({r['grads_share'][2]:.3g}), the float32 step's "
                     f"{r['grads_share'][1]:.3g}")
        result[policy] = r
        lines.append(line)
    log("train-vs-cpu", "flagship, 2 tiles of 128 px, one Adam step a policy, card "
        "against CPU with the card's pooling and ReLU decisions shared: "
        + "; ".join(lines))
    if failed:
        raise AssertionError(f"card against CPU above the bar: {failed}")
    return result


# Phases "dp-nccl-1" and "dp-2-on-1": data parallelism (``parallel/``: one
# process per GPU over torch.distributed). One card cannot hold a world of
# several cards over NCCL: "dp-nccl-1" runs the CLIs in a world of one
# process over NCCL (every collective a copy), "dp-2-on-1" two ranks that
# share the card over gloo (passed by argument), with K1, K2 and K3 in both.
DP_RANKS = 2
DP_STEPS = 5
DP_WARMUP = 2
DP_POLICIES = ("high", "balanced16")
DP_LR = 2e-4
DP_TIMEOUT = 900                 # seconds the ranks' processes may take
DP_COLLECTIVE_TIMEOUT = 300      # seconds a rank's collective waits for its peer
# Ranks against one process. The metric at the bars of
# tests/test_torch_parallel.py (float32 rtol 2e-4, balanced16 5e-3). The
# weights and running statistics at those bars (float32 rtol 1e-3, atol
# 2e-5; balanced16 rtol 5e-3, atol 1e-4), or, where they miss them, no
# further than DP_CONTROL times the control's miss: one process on the same
# batches with each batch's samples reversed, the same sums grouped
# otherwise. On the card the control misses the CPU tests' bars itself
# (float32 weights by 4.9e-4, statistics by 4.8e-3 after 5 steps, on an
# NVIDIA H100 80GB HBM3, 700.00 W): batch 20 and batch 10 round
# differently, and Adam turns a near-zero gradient's rounding into a step of
# lr. The first step's gradients (before Adam): relative L2 within
# DP_CONTROL times the control's; the weight updates too, or (balanced16)
# within the CPU tests' 0.1.
DP_BARS = {"high": dict(metric=2e-4, rtol=1e-3, atol=2e-5, update=0.0),
           "balanced16": dict(metric=5e-3, rtol=5e-3, atol=1e-4, update=0.1)}
DP_CONTROL = 2
# The scene-sharded scene on the rows two bands share, against the streamed
# one (whose band canvases start from the band above's sums): f32 ulps of
# the largest height.
DP_SEAM_ULPS = 2


@contextlib.contextmanager
def _world_of_one():
    """``RESDEPTH_DIST_*`` for a world of one process at a free localhost
    port while the block runs; the process group the CLIs' bootstrap forms
    is destroyed after it."""
    import torch.distributed as dist

    from resdepth_tpu_torch.parallel import bootstrap

    names = ("RESDEPTH_DIST_COORDINATOR", "RESDEPTH_DIST_NUM_PROCESSES",
             "RESDEPTH_DIST_PROCESS_ID")
    saved = {name: os.environ.get(name) for name in names}
    os.environ.update(zip(names, (f"localhost:{bootstrap.free_port()}", "1", "0")))
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def _same_trees(a: dict, b: dict) -> bool:
    from resdepth_tpu_torch.models.weights import flatten_keystr

    a, b = flatten_keystr(a), flatten_keystr(b)
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def phase_dp_nccl_1(work: str, scene: dict) -> dict:
    """The train CLI for one epoch at 'balanced16' (deterministic cuDNN),
    then the inference CLI (float32, K2) serving its ``Model_best.npz`` on
    the 2048^2 scene, each without a process group and in a world of one
    process over NCCL that the CLIs' bootstrap forms from
    ``RESDEPTH_DIST_*`` (``_world_of_one``). Every collective runs, as a
    copy, so each world run must be bitwise its twin: the weights, running
    statistics and Adam moments of ``Model_last.npz``, the val MAE, the
    refined raster. The counters are zeroed just before each world run and
    read just after: K3 3 launches a step at 3 passes, K2 one a batch."""
    import torch.distributed as dist

    from resdepth_tpu_torch import train
    from resdepth_tpu_torch.ops import conv, stitch
    from resdepth_tpu_torch.train import checkpoint as ckpt_io

    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name in ("alone", "world"):
            out_root = os.path.join(work, f"runs_dp_{name}")
            config = write_train_config(
                os.path.join(work, f"train_dp_{name}.json"), scene["paths"], out_root,
                suffix="dp", n_samples=TRAIN_SAMPLES,
                training={"tile_size": TILE, "batch_size": TRAIN_BATCH, "augment": True,
                          "n_epochs": 1},
                optimizer={"name": "Adam", "learning_rate": DP_LR, "weight_decay": 1e-5},
                scheduler={"enabled": True, "name": "StepLR",
                           "settings": {"step_size": 2, "gamma": 0.5}},
                general={"evaluate_rate": 1, "save_model_rate": 3, "random_seed": SEED},
                tpu={"train_precision": "balanced16"})
            for key in conv.LAUNCHES:
                conv.LAUNCHES[key] = 0
            start = time.perf_counter()
            with _world_of_one() if name == "world" else contextlib.nullcontext():
                trainer = train.main([config, "--device", "cuda"])
                group = ((dist.get_world_size(), dist.get_backend())
                         if dist.is_initialized() else None)
            runs[name] = {"wall": time.perf_counter() - start, "group": group,
                          "k3": dict(conv.LAUNCHES), "val": list(trainer.val_history),
                          "run": run_dir_of(out_root, "dp")}
    finally:
        torch.backends.cudnn.deterministic = False
    alone, world = runs["alone"], runs["world"]
    steps = TRAIN_SAMPLES // TRAIN_BATCH
    want_k3 = k3_launches_a_step("balanced16")[3] * steps
    last = {name: ckpt_io.load_checkpoint(os.path.join(r["run"], "checkpoints",
                                                       "Model_last.npz"))
            for name, r in runs.items()}
    same = {tree: _same_trees(last["alone"][tree], last["world"][tree])
            for tree in ("params", "bn_state")}
    same["adam"] = all(_same_trees(a, b) for a, b in zip(last["alone"]["adam"][:2],
                                                        last["world"]["adam"][:2]))
    if (alone["group"] is not None or world["group"] != (1, "nccl")
            or world["k3"]["k3_p3"] != want_k3 or world["k3"]["k3"] != want_k3
            or world["val"] != alone["val"] or not all(same.values())):
        raise AssertionError(
            f"dp-nccl-1 train CLI: groups {alone['group']} / {world['group']}, K3 in the "
            f"world run {world['k3']} (expected {want_k3} at 3 passes), val "
            f"{alone['val']} / {world['val']}, bitwise {same}")

    served = {}
    for name in ("alone", "world"):
        out_dir = os.path.join(work, f"eval_dp_{name}")
        cfg = write_config(os.path.join(work, f"serve_dp_{name}.json"), scene["paths"],
                           serving_model_artifacts(alone["run"]), out_dir, tile_size=TILE,
                           batch_size=BATCH, use_pallas="fused")
        for key in stitch.LAUNCHES:
            stitch.LAUNCHES[key] = 0
        with _world_of_one() if name == "world" else contextlib.nullcontext():
            wall = run_cli(cfg, "cuda")
        with open(os.path.join(out_dir, "run.log")) as f:
            mesh_line = "Inference mesh: {'data': 1}" in f.read()
        served[name] = {"wall": wall, "k2": stitch.LAUNCHES["k2"], "mesh_line": mesh_line,
                        "raster": _check_outputs(out_dir, (TRAIN_SCENE, TRAIN_SCENE))}
    n_batches = -(-((TRAIN_SCENE - TILE) // (TILE // 2) + 1) ** 2 // BATCH)
    if (not np.array_equal(served["world"]["raster"], served["alone"]["raster"])
            or served["world"]["k2"] != n_batches or not served["world"]["mesh_line"]
            or served["alone"]["mesh_line"]):
        diff = float(np.abs(served["world"]["raster"] - served["alone"]["raster"]).max())
        raise AssertionError(f"dp-nccl-1 predict CLI: the world run's raster differs by "
                             f"{diff} m, K2 {served['world']['k2']} (expected "
                             f"{n_batches}), mesh logged "
                             f"{served['world']['mesh_line']} / {served['alone']['mesh_line']}")
    log("dp-nccl-1", f"RESDEPTH_DIST_* world of 1 process over NCCL formed by the CLIs' "
        f"bootstrap, against no process group: train CLI, balanced16, 1 epoch of {steps} "
        f"steps, deterministic cuDNN: walls {alone['wall']:.1f} s alone, "
        f"{world['wall']:.1f} s in the world; Model_last.npz weights, running statistics "
        f"and Adam moments bitwise, val MAE {world['val'][0][1]:.6f} m both; K3 "
        f"{world['k3']['k3_p3']} launches at 3 passes; predict CLI float32 K2 on the "
        f"{TRAIN_SCENE}^2 scene: walls {served['alone']['wall']:.2f} s alone, "
        f"{served['world']['wall']:.2f} s in the world, raster bitwise, K2 "
        f"{served['world']['k2']} launches")
    return {"launches": {"k2": served["world"]["k2"], 3: world["k3"]["k3_p3"],
                         **{v: world["k3"][f"k3_{v}"] for v in K3_COUNTED}}}


def dp_train(policy: str, scene: dict, device, group, reverse: bool = False) -> dict:
    """``DP_STEPS`` steps of ``make_train_step`` on the flagship at batch
    ``TRAIN_BATCH`` (this rank's share under ``group``) of the 2048^2 scene,
    augmentation off, BatchNorm unweighted as the train CLI runs full
    batches, from the seeded weights. The K3 counters are zeroed just
    before the steps and read just after; K3's call shapes are recorded,
    and the first step's gradients (summed over the group). ``reverse``
    hands each batch's samples in reverse order: the same sums, grouped
    otherwise."""
    from resdepth_tpu_torch.data.pipeline import (GeneratorDraws, batch_spec_for,
                                                  device_put_dataset)
    from resdepth_tpu_torch.models.unet import flagship_config, init_unet
    from resdepth_tpu_torch.ops import conv
    from resdepth_tpu_torch.train.step import (init_train_state, make_train_step,
                                               select_train_precision)

    ds = _train_dataset(scene, TRAIN_SCENE, TILE, TRAIN_BATCH * DP_STEPS)
    rasters = device_put_dataset(ds, device, include_target=True)
    kwargs, dtype = select_train_precision(*TRAIN_POLICIES[policy], device)
    model = init_unet(flagship_config("geom-stereo"), torch.Generator().manual_seed(SEED),
                      device)
    state = init_train_state(model, "Adam", DP_LR, 1e-5)
    step = make_train_step(batch_spec_for(ds, augment=False), weighted_bn=False,
                           compute_dtype=dtype, group=group, **kwargs)
    draws = GeneratorDraws(torch.Generator(device=device).manual_seed(SEED))
    events, metrics = [], []
    torch.cuda.synchronize()
    for key in conv.LAUNCHES:
        conv.LAUNCHES[key] = 0
    order = slice(None, None, -1 if reverse else 1)
    grads = None
    with _recorded_k3_calls() as calls:
        for i in range(0, TRAIN_BATCH * DP_STEPS, TRAIN_BATCH):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics.append(step(state, rasters,
                                np.ascontiguousarray(ds.positions[i:i + TRAIN_BATCH][order]),
                                np.ascontiguousarray(ds.pair_indices[i:i + TRAIN_BATCH][order]),
                                np.zeros((TRAIN_BATCH, 4), np.int32),
                                np.ones(TRAIN_BATCH, np.float32), draws))
            end.record()
            events.append((start, end))
            if grads is None:
                grads = {name: p.grad.detach().cpu().clone()
                         for name, p in model.named_parameters()}
    torch.cuda.synchronize()
    return {"metrics": [float(m) for m in metrics], "k3": dict(conv.LAUNCHES),
            "step_ms": [s.elapsed_time(e) for s, e in events],
            "calls": calls[:len(calls) // DP_STEPS], "grads": grads,
            "state": {k: v.detach().cpu() for k, v in model.state_dict().items()}}


def dp_serve(plan: dict, device, group) -> dict:
    """The 4096^2 scene tile-sharded over ``group`` (``predict_linear_blend``)
    in each of ``STREAM_RUNS`` (float32 with K2 and K1, balanced16 with K2),
    and scene-sharded (``predict_linear_blend_scene_sharded``, float32, K2)
    under ``STREAM_BUDGET``: each scene, this rank's launches by kernel
    (counters zeroed just before the counted run and read just after) and
    the host-clock seconds of the counted run and one more."""
    from resdepth_tpu_torch import predict
    from resdepth_tpu_torch.data.pipeline import device_put_dataset
    from resdepth_tpu_torch.infer.tiled import (predict_linear_blend,
                                                predict_linear_blend_scene_sharded,
                                                serving_model)
    from resdepth_tpu_torch.models import weights
    from resdepth_tpu_torch.models.unet import UNet, flagship_config
    from resdepth_tpu_torch.ops import conv, stitch

    scene = plan["scene"]
    ds = _tile_dataset(scene["paths"], SCENE_SIZE, scene["image_mean"], scene["image_std"])
    config = flagship_config("geom-stereo")
    base = UNet(config)
    base.load_state_dict(weights.load_state_dict(plan["model_weights"], config))
    out = {}

    def counted(name, fn):
        for counters in (stitch.LAUNCHES, conv.LAUNCHES):
            for key in counters:
                counters[key] = 0
        walls, launches = [], None
        for _ in range(2):
            torch.cuda.synchronize()
            start = time.perf_counter()
            got = fn()
            if isinstance(got, torch.Tensor):
                got = got.cpu().numpy()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
            if launches is None:
                launches = {**stitch.LAUNCHES, "k3_p3": conv.LAUNCHES["k3_p3"],
                            "k3": conv.LAUNCHES["k3"],
                            **{f"k3_{v}": conv.LAUNCHES[f"k3_{v}"] for v in K3_COUNTED}}
        out[name] = {"scene": None if got is None else torch.from_numpy(got),
                     "launches": launches, "walls": walls}

    for dtype_name, use_pallas in STREAM_RUNS:
        dtype = predict.select_compute_dtype(dtype_name, device)
        served = serving_model(base, device, dtype)
        rasters = device_put_dataset(ds, device)
        kwargs = dict(device=device, batch_size=BATCH, compute_dtype=dtype,
                      use_pallas=use_pallas, fold_bn=False, group=group)
        counted(f"tiled-{dtype_name}-{'k2' if use_pallas else 'k1'}",
                lambda: predict_linear_blend(served, ds, rasters=rasters, as_numpy=False,
                                             **kwargs))
        del rasters
        if (dtype_name, use_pallas) == ("float32", "fused"):
            counted("sharded", lambda: predict_linear_blend_scene_sharded(
                served, ds, max_device_pixels=STREAM_BUDGET, **kwargs))
        del served
        torch.cuda.empty_cache()
    return out


def dp_rank(plan_path: str) -> int:
    """One rank of phase dp-2-on-1 (``--dp-rank``): joins the gloo group on
    the card through ``RESDEPTH_DIST_*`` with ``backend="gloo"``, runs
    ``dp_train`` at each of ``DP_POLICIES`` (deterministic cuDNN) and
    ``dp_serve``, and writes what it found to ``<out>.r<rank>.pt``."""
    import datetime

    import torch.distributed as dist

    from resdepth_tpu_torch.parallel import bootstrap, mesh

    with open(plan_path) as f:
        plan = json.load(f)
    if not bootstrap.maybe_initialize_distributed(
            device="cuda", backend="gloo",
            timeout=datetime.timedelta(seconds=DP_COLLECTIVE_TIMEOUT)):
        raise RuntimeError("--dp-rank needs RESDEPTH_DIST_*")
    group = mesh.data_mesh()
    rank = mesh.rank(group)
    device = torch.device("cuda", torch.cuda.current_device())
    out = {"rank": rank, "world": mesh.size(group), "backend": dist.get_backend(group),
           "device": str(device), "train": {}}
    torch.backends.cudnn.deterministic = True
    try:
        for policy in DP_POLICIES:
            out["train"][policy] = dp_train(policy, plan["train_scene"], device, group)
    finally:
        torch.backends.cudnn.deterministic = False
    out["serve"] = dp_serve(plan, device, group)
    torch.save(out, f"{plan['out']}.r{rank}.pt")
    dist.destroy_process_group()
    return 0


def _dp_gaps(got: dict, alone: dict, start: dict, bar: dict) -> dict:
    """How far a run (``dp_train``'s result) lies from one process: the
    metric's largest relative gap, the worst excess over ``bar``'s atol +
    rtol |want| among the running statistics and the weights (with the
    tensor that sets it), the weights' largest |diff|, the relative L2 of
    the weight updates and of the first step's gradients (all, and the
    worst tensor's)."""
    stats = [k for k in alone["state"] if k.endswith(("running_mean", "running_var"))]
    params = [k for k in alone["state"] if k not in stats
              and not k.endswith("num_batches_tracked")]

    def excess(keys):   # the worst |diff| over atol + rtol |want|, per element
        worst = {k: float(((got["state"][k] - alone["state"][k]).abs() - bar["atol"]
                           - bar["rtol"] * alone["state"][k].abs()).max()) for k in keys}
        key = max(worst, key=worst.get)
        return worst[key], key

    def flat(tensors, keys, origin=None):
        return torch.cat([(tensors[k] - (0 if origin is None else origin[k])).double().ravel()
                          for k in keys])

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    gaps = {"metric": max(abs(a / b - 1) for a, b in zip(got["metrics"], alone["metrics"]))}
    gaps["stats_excess"], gaps["stats_worst"] = excess(stats)
    gaps["params_excess"], gaps["params_worst"] = excess(params)
    gaps["max_abs"] = max(float((got["state"][k] - alone["state"][k]).abs().max())
                          for k in params)
    gaps["update_rel_l2"] = rel(flat(got["state"], params, start),
                                flat(alone["state"], params, start))
    names = list(alone["grads"])
    gaps["grad_rel_l2"] = rel(flat(got["grads"], names), flat(alone["grads"], names))
    worst = {k: rel(got["grads"][k].double(), alone["grads"][k].double()) for k in names}
    gaps["grad_worst"] = max(worst, key=worst.get)
    gaps["grad_worst_rel_l2"] = worst[gaps["grad_worst"]]
    return gaps


def _hold_dp_training(policy: str, ranks: list, alone: dict, control: dict,
                      start: dict) -> tuple:
    """The ranks' first-step gradients, and their weights and running
    statistics after ``DP_STEPS`` steps, against one process at ``DP_BARS``
    or within ``DP_CONTROL`` times ``control``'s gaps (one process with each
    batch reversed) -> ``(gaps, control's gaps, failure or None)``."""
    bar = DP_BARS[policy]
    got = ranks[0]["train"][policy]
    for other in ranks[1:]:
        theirs = other["train"][policy]
        if theirs["metrics"] != got["metrics"] or not all(
                torch.equal(v, got["state"][k]) for k, v in theirs["state"].items()):
            return {}, {}, f"dp-2-on-1 {policy}: the ranks' weights differ"
    gaps, floor = _dp_gaps(got, alone, start, bar), _dp_gaps(control, alone, start, bar)
    over = [k for k in ("stats_excess", "params_excess")
            if gaps[k] > max(0.0, DP_CONTROL * floor[k])]
    if gaps["grad_rel_l2"] > DP_CONTROL * floor["grad_rel_l2"]:
        over.append("grad_rel_l2")
    if gaps["update_rel_l2"] > max(bar["update"], DP_CONTROL * floor["update_rel_l2"]):
        over.append("update_rel_l2")
    if gaps["metric"] > bar["metric"]:
        over.append("metric")
    failure = (f"dp-2-on-1 {policy}: 2 ranks against one process {gaps} over the bars at "
               f"{over} (bars {bar}, or {DP_CONTROL} x one process with each batch "
               f"reversed: {floor})") if over else None
    return gaps, floor, failure


def phase_dp_2_on_1(work: str, scene: dict, model: dict, train_scene: dict,
                    device=None) -> dict:
    """Two ranks on the one card over gloo (``dp_rank``), against this
    process alone on the same card:

    * training: ``dp_train`` at float32 'high' and 'balanced16', batch 20
      (10 a rank), deterministic cuDNN; the ranks' weights bitwise each
      other's and held to one process at batch 20 (``_hold_dp_training``:
      the CPU tests' bars, or twice as far as one process with each batch
      reversed); K3 3 launches a step a rank at balanced16; K3 against its
      plain version at the ranks' call shapes (batch 10);
    * serving: the 4096^2 scene tile-sharded in each of ``STREAM_RUNS``,
      every rank holding the scene, within K1's bar (``k1_ulps(4)``) of the
      resident K2 scene of its dtype;
    * scene sharding: under ``STREAM_BUDGET`` (5 bands, 3 waves of 2 ranks),
      the chief's scene bitwise the streamed K2 scene off the seam rows and
      within ``DP_SEAM_ULPS`` on them; the other rank returns None.

    Every check runs and logs before the first failure raises. Times: each rank's step ms and scene seconds. Two ranks share one card,
    so they are no speeds of training or serving on two cards. ``device``
    is this process's (default: the card)."""
    from resdepth_tpu_torch import predict
    from resdepth_tpu_torch.infer.tiled import (predict_linear_blend,
                                                predict_linear_blend_streaming,
                                                serving_model)
    from resdepth_tpu_torch.models import weights
    from resdepth_tpu_torch.models.unet import UNet, flagship_config, init_unet
    from resdepth_tpu_torch.parallel import bootstrap

    device = device or torch.device("cuda", 0)
    config = flagship_config("geom-stereo")
    alone, control = {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for policy in DP_POLICIES:
            alone[policy] = dp_train(policy, train_scene, device, None)
            control[policy] = dp_train(policy, train_scene, device, None, reverse=True)
    finally:
        torch.backends.cudnn.deterministic = False
    start = init_unet(config, torch.Generator().manual_seed(SEED)).state_dict()
    ds = _tile_dataset(scene["paths"], SCENE_SIZE, scene["image_mean"], scene["image_std"])
    base = UNet(config)
    base.load_state_dict(weights.load_state_dict(model["weights"], config))
    resident = {}
    for dtype_name in ("float32", "balanced16"):
        dtype = predict.select_compute_dtype(dtype_name, device)
        served = serving_model(base, device, dtype)
        kwargs = dict(device=device, batch_size=BATCH, compute_dtype=dtype,
                      use_pallas="fused", fold_bn=False)
        resident[dtype_name] = predict_linear_blend(served, ds, **kwargs)
        if dtype_name == "float32":
            streamed = predict_linear_blend_streaming(
                served, ds, max_device_pixels=STREAM_BUDGET, **kwargs)
        del served
    for r in (*alone.values(), *control.values()):
        r.pop("calls")
    torch.cuda.empty_cache()

    plan = os.path.join(work, "dp_plan.json")
    with open(plan, "w") as f:
        json.dump({"scene": scene, "train_scene": train_scene,
                   "model_weights": model["weights"], "out": os.path.join(work, "dp")}, f)
    begin = time.perf_counter()
    try:
        bootstrap.run_world([sys.executable, os.path.abspath(__file__), "--dp-rank", plan],
                            DP_RANKS, timeout=DP_TIMEOUT, cwd=REPO, log_dir=work)
    except bootstrap.WorldFailed as exc:
        raise AssertionError(f"dp-2-on-1: {exc}") from None
    ranks = [torch.load(f"{os.path.join(work, 'dp')}.r{r}.pt", weights_only=False)
             for r in range(DP_RANKS)]
    wall = time.perf_counter() - begin
    if [(r["rank"], r["world"], r["backend"]) for r in ranks] != [
            (i, DP_RANKS, "gloo") for i in range(DP_RANKS)]:
        raise AssertionError(f"dp-2-on-1: the ranks reported "
                             f"{[(r['rank'], r['world'], r['backend']) for r in ranks]}")

    def fmt(gaps):
        return ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                         for k, v in gaps.items())

    lines, failures, launches = [], [], {"k1": 0, "k2": 0, 3: 0,
                                         **{v: 0 for v in K3_COUNTED}}
    for policy in DP_POLICIES:
        gaps, floor, failure = _hold_dp_training(policy, ranks, alone[policy],
                                                 control[policy], start)
        if failure:
            failures.append(failure)
        want_k3 = k3_launches_a_step(policy).get(3, 0) * DP_STEPS
        k3 = [r["train"][policy]["k3"] for r in ranks]
        if any(c["k3_p3"] != want_k3 or c["k3"] != want_k3 for c in k3):
            raise AssertionError(f"dp-2-on-1 {policy}: K3 launches a rank {k3}, expected "
                                 f"{want_k3} at 3 passes")
        launches[3] += sum(c["k3_p3"] for c in k3)
        for variant in K3_COUNTED:
            launches[variant] += sum(c[f"k3_{variant}"] for c in k3)
        step_ms = [float(np.mean(r["train"][policy]["step_ms"][DP_WARMUP:])) for r in ranks]
        lines.append(
            f"train {policy}: metric {ranks[0]['train'][policy]['metrics'][-1]:.6f} m after "
            f"{DP_STEPS} steps (one process {alone[policy]['metrics'][-1]:.6f}); gaps to one "
            f"process {fmt(gaps)}; one process with each batch reversed: {fmt(floor)}; "
            "K3 a rank "
            f"{k3[0]['k3_p3']} at 3 passes; step ms a rank "
            f"{', '.join(f'{t:.2f}' for t in step_ms)} (one process at batch 20 "
            f"{float(np.mean(alone[policy]['step_ms'][DP_WARMUP:])):.2f})")
    shapes = {}
    for x_shape, k_shape, passes, layout in ranks[0]["train"]["balanced16"]["calls"]:
        shapes.setdefault((tuple(x_shape), tuple(k_shape), passes, layout),
                          {"balanced16": 0})["balanced16"] += 1
    _train_k3_checks(shapes, "dp-2-on-1")

    bar = k1_ulps(4)
    for dtype_name, use_pallas in STREAM_RUNS:
        name = f"tiled-{dtype_name}-{'k2' if use_pallas else 'k1'}"
        runs = [r["serve"][name] for r in ranks]
        got = runs[0]["scene"].numpy()
        want = resident[dtype_name]
        diff = float(np.abs(got.astype(np.float64) - want).max()) / ulps(want, 1)
        kernel = "k2" if use_pallas else "k1"
        n_steps = -(-len(ds.positions) // (BATCH * DP_RANKS))
        want_k3 = k3_calls_a_forward(dtype_name)[3] * n_steps if dtype_name != "float32" else 0
        counts = [r["launches"] for r in runs]
        if (not all(torch.equal(r["scene"], runs[0]["scene"]) for r in runs)
                or not np.isfinite(got).all() or diff > bar
                or any(c[kernel] != n_steps or c["k3_p3"] != want_k3 for c in counts)):
            failures.append(f"dp-2-on-1 {name}: {diff:.3g} ulps from the resident K2 "
                            f"scene (bar {bar}), launches a rank {counts} (expected "
                            f"{n_steps} {kernel}, {want_k3} K3)")
        launches[kernel] += sum(c[kernel] for c in counts)
        launches[3] += sum(c["k3_p3"] for c in counts)
        for variant in K3_COUNTED:
            launches[variant] += sum(c[f"k3_{variant}"] for c in counts)
        lines.append(f"{name}: {diff:.2f} ulps from the resident K2 scene (bar {bar}), "
                     f"launches a rank {counts[0]}, scene s a rank (counted run, then one "
                     "more) " + "; ".join(", ".join(f"{w:.3f}" for w in r["walls"])
                                          for r in runs))
    runs = [r["serve"]["sharded"] for r in ranks]
    got = runs[0]["scene"]
    geometry = stream_geometry(ds, STREAM_BUDGET)
    seams = geometry["seams"]
    if got is None or any(r["scene"] is not None for r in runs[1:]):
        raise AssertionError("dp-2-on-1 scene-sharded: the chief alone should hold the scene")
    got = got.numpy()
    seam_ulps = float(np.abs(got[seams].astype(np.float64) - streamed[seams]).max()
                      ) / ulps(streamed, 1)
    bands = len(geometry["tiles"])
    padded = -(-max(geometry["tiles"]) // BATCH)
    want_k2 = [len(range(r, bands, DP_RANKS)) * padded for r in range(DP_RANKS)]
    counts = [r["launches"] for r in runs]
    if (not np.array_equal(got[~seams], streamed[~seams]) or not np.isfinite(got).all()
            or seam_ulps > DP_SEAM_ULPS or [c["k2"] for c in counts] != want_k2):
        failures.append(
            f"dp-2-on-1 scene-sharded: off the seams bitwise "
            f"{np.array_equal(got[~seams], streamed[~seams])}, on them {seam_ulps:.3g} ulps "
            f"(bar {DP_SEAM_ULPS}), K2 a rank {[c['k2'] for c in counts]} (expected {want_k2})")
    launches["k2"] += sum(want_k2)
    lines.append(f"scene-sharded float32 K2, {bands} bands of "
                 f"{', '.join(map(str, geometry['tiles']))} tiles in waves of {DP_RANKS}: "
                 f"bitwise the streamed scene off the {int(seams.sum())} seam rows, "
                 f"{seam_ulps:.2f} ulps on them (bar {DP_SEAM_ULPS}); K2 a rank "
                 f"{[c['k2'] for c in counts]}; scene s a rank "
                 + "; ".join(", ".join(f"{w:.3f}" for w in r["walls"]) for r in runs))
    log("dp-2-on-1", f"{DP_RANKS} ranks on one card over gloo, processes of "
        f"chip_smoke.py --dp-rank, {wall:.1f} s with their start; times are of ranks that "
        "share the card, no speeds on two cards: " + "; ".join(lines))
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": launches}


# ``resdepth_tpu_torch/graft_entry.py``: the flagship forward and the dry run.
DRYRUN_RANKS = 4                 # ranks of the shared-card world: every leg runs
DRYRUN_FORWARD_BAR = 1e-5        # of the largest output: the port's f32 forward bar
DRYRUN_TIMEOUT = 300             # seconds a dry run's world may take


def dryrun_rank(plan_path: str) -> int:
    """One rank of phase dryrun (``--dryrun-rank``): ``graft_entry.rank_main``
    under ``held_kernels``; adds each kernel's held calls (count, worst
    error and its bar) to the rank's result file."""
    from resdepth_tpu_torch import graft_entry

    with open(plan_path) as f:
        plan = json.load(f)
    record = {}
    with held_kernels(record):
        graft_entry.rank_main(plan_path)
    path = f"{plan['out']}.r{os.environ['RESDEPTH_DIST_PROCESS_ID']}.json"
    with open(path) as f:
        result = json.load(f)
    result["held"] = {}
    for key, calls in record.items():
        # the call farthest into its bar, and the largest |diff| of any call
        worst = max(calls, key=lambda c: c[-2] / c[-1] if c[-1] else c[-2],
                    default=(0.0, 0.0))
        largest = max(calls, key=lambda c: c[-2], default=(0.0, 0.0))
        result["held"][key] = {"calls": len(calls), "worst": worst[-2], "bar": worst[-1],
                               "largest": largest[-2], "largest_bar": largest[-1]}
    with open(path, "w") as f:
        json.dump(result, f)
    return 0


def phase_dryrun() -> dict:
    """``entry()``'s forward on the card against the CPU, then the dry run in
    a world of one over NCCL and in ``DRYRUN_RANKS`` ranks sharing the card
    over gloo (``graft_entry.dryrun_multichip``, which checks the legs'
    bars), each rank a ``--dryrun-rank`` process holding every kernel call
    to its plain version. Asserts the launches of each leg in every rank:
    K3 at 1 pass in the train legs (``k3_launches_a_step('default', depth)``
    a step), K1 in the tile-sharded leg, K2 in the scene-sharded leg (a
    rank with bands), and no other kernel. Returns the launches by kernel
    and the forward's ms."""
    from resdepth_tpu_torch import graft_entry

    start = time.perf_counter()
    torch.cuda.empty_cache()   # the ranks share the card with this process
    fn, (model, x) = graft_entry.entry()
    torch.backends.cudnn.allow_tf32 = False
    x_dev = torch.from_numpy(x).cuda()
    ms = cuda_ms(lambda: fn(model, x_dev), iters=10)
    got = fn(model, x_dev).cpu().numpy()
    cpu_model = graft_entry.entry("cpu")[1][0]
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    want = fn(cpu_model, x).numpy()
    err = float(np.abs(got - want).max())
    bar = DRYRUN_FORWARD_BAR * float(np.abs(want).max())
    if not (got.shape == want.shape == (4, 256, 256, 1) and np.isfinite(got).all()
            and err <= bar):
        raise AssertionError(f"dryrun: entry forward card vs CPU max |diff| {err:.3g} "
                             f"(bar {bar:.3g}), shape {got.shape}")
    log("dryrun", f"entry(): flagship forward on 4x256^2x3 {ms:.2f} ms (CUDA events, "
        f"TF32 off), card vs CPU max |diff| {err:.3g} (bar {bar:.3g})")
    del model, x_dev
    torch.cuda.empty_cache()

    argv = [sys.executable, os.path.abspath(__file__), "--dryrun-rank"]
    want_k3 = {"train": k3_launches_a_step("default", 3)[1],
               "train-2d": k3_launches_a_step("default", 3)[1],
               "banded": 2 * k3_launches_a_step("default", 2)[1]}
    launches = {"k1": 0, "k2": 0, 1: 0, **{v: 0 for v in K3_COUNTED}}
    for n, share in ((1, False), (DRYRUN_RANKS, True)):
        begin = time.perf_counter()
        ranks = graft_entry.dryrun_multichip(n, share_cards=share, rank_argv=argv,
                                             timeout=DRYRUN_TIMEOUT)
        wall = time.perf_counter() - begin
        failures, lines = [], []
        for name in graft_entry.legs(n):
            counts = [r["legs"][name]["launches"] for r in ranks]
            for rank, c in enumerate(counts):
                # "k3" counts every K3 launch, "k3_<variant>" those of its
                # float32 kernels and "k3_split" their weights' splits
                other = {k: v for k, v in c.items()
                         if v and k not in ("k1", "k2", "k3_p1", "k3", "k3_split",
                                            *(f"k3_{v}" for v in K3_COUNTED))}
                if name in want_k3:
                    ok = (c["k3_p1"] == c["k3"] == want_k3[name]
                          and not c["k1"] and not c["k2"])
                elif name == "tile-sharded":
                    ok = c["k1"] > 0 and not c["k2"] and not c["k3"]
                else:   # a rank with a band launches K2
                    bands = ranks[0]["legs"][name]["bands"]
                    ok = (c["k2"] > 0) == (rank < bands) and not c["k1"] and not c["k3"]
                if not ok or other:
                    failures.append(f"{name} rank {rank}: launches {c}")
            launches["k1"] += sum(c["k1"] for c in counts)
            launches["k2"] += sum(c["k2"] for c in counts)
            launches[1] += sum(c["k3_p1"] for c in counts)
            for variant in K3_COUNTED:
                launches[variant] += sum(c[f"k3_{variant}"] for c in counts)
            lines.append(f"{name} {max(r['legs'][name]['seconds'] for r in ranks):.2f} s, "
                         "launches a rank " + ", ".join(
                             "/".join(str(c[k]) for c in counts) + f" {k}"
                             for k in ("k3_p1", "k1", "k2") if any(c[k] for c in counts)))
        held = {}
        for key in ("k3", "k1", "k2"):
            worst = max((r["held"][key] for r in ranks),
                        key=lambda h: h["worst"] / h["bar"] if h["bar"] else h["worst"])
            largest = max((r["held"][key] for r in ranks), key=lambda h: h["largest"])
            held[key] = (sum(r["held"][key]["calls"] for r in ranks), worst["worst"],
                         worst["bar"], largest["largest"], largest["largest_bar"])
        if any(held[key][0] == 0 for key in held):
            failures.append(f"held calls {held}: a kernel was never held")
        log("dryrun", f"dryrun_multichip({n}"
            + (", share_cards=True" if share else "") + f"): {wall:.1f} s with the ranks' "
            f"start, {ranks[0]['backend']}; " + "; ".join(lines) + "; held: " + ", ".join(
                f"{k.upper()} {c} calls, farthest into its bar |diff| {w:.3g} (bar "
                f"{b:.3g}), largest |diff| {g:.3g} (bar {gb:.3g})"
                for k, (c, w, b, g, gb) in held.items()))
        if failures:
            raise AssertionError("dryrun: " + "; ".join(failures))
    log("dryrun", f"done in {time.perf_counter() - start:.1f} s")
    return {"launches": launches, "forward_ms": ms}


def main(argv: list | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--stitch-scene", action="store_true",
                        help="only build the stitch kernels and time them over "
                             "the 4096x4096 scene's batches (phase stitch-scene), "
                             "to compare two checkouts on one card; prints no "
                             "result line")
    parser.add_argument("--phase", action="append",
                        choices=("conv", "epilogue", "upconv", "studies", "config-smoke",
                                 "dryrun", "crop"),
                        help="run phases 1-2 and only this phase (repeatable), to "
                             "iterate on it; prints no result line")
    parser.add_argument("--dp-rank", metavar="PLAN",
                        help="run one rank of phase dp-2-on-1 from its plan (the "
                             "phase starts the ranks itself); prints no result line")
    parser.add_argument("--dryrun-rank", metavar="PLAN",
                        help="run one rank of phase dryrun from its plan (the "
                             "phase starts the ranks itself); prints no result line")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs one GPU",
              file=sys.stderr)
        return 1
    import resdepth_tpu_torch  # noqa: F401  (fails outside a checkout)
    if args.dp_rank:
        return dp_rank(args.dp_rank)
    if args.dryrun_rank:
        return dryrun_rank(args.dryrun_rank)
    from resdepth_tpu_torch.models.unet import flagship_config
    from resdepth_tpu_torch.ops import stitch

    device = phase_device()
    if args.stitch_scene:
        stitch._library()
        phase_stitch_scene(grid_batches())
        return 0
    phase_build()
    if args.phase:
        for name in args.phase:
            if name in ("conv", "dryrun"):
                {"conv": phase_conv, "dryrun": phase_dryrun}[name]()
                continue
            if name in ("epilogue", "upconv"):
                {"epilogue": phase_epilogue, "upconv": phase_upconv}[name](WORK_DIR)
                continue
            if name == "crop":
                scene = write_scene(os.path.join(WORK_DIR, "scene"), SCENE_SIZE,
                                    SCENE_SIZE)
                model = write_model_artifacts(
                    os.path.join(WORK_DIR, "model"), flagship_config("geom-stereo"),
                    "geom-stereo", scene["image_mean"], scene["image_std"])
                phase_crop(WORK_DIR, scene, model["weights"])
                continue
            {"studies": phase_studies, "config-smoke": phase_config_smoke}[name](
                os.path.join(WORK_DIR, name))
        shutil.rmtree(WORK_DIR, ignore_errors=True)
        return 0
    kernels, stitch_scene = phase_kernels()
    phase_stitch_scene(stitch_scene)
    del stitch_scene

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    start = time.perf_counter()
    scene = write_scene(os.path.join(WORK_DIR, "scene"), SCENE_SIZE, SCENE_SIZE)
    model = write_model_artifacts(os.path.join(WORK_DIR, "model"),
                                  flagship_config("geom-stereo"), "geom-stereo",
                                  scene["image_mean"], scene["image_std"])
    log("setup", f"seeded {SCENE_SIZE}^2 geom-stereo scene and flagship "
        f"artifacts written in {time.perf_counter() - start:.1f} s")
    flagship = phase_flagship(WORK_DIR, scene, model)
    phase_steady(scene, model["weights"])
    modes = phase_modes(scene, model["weights"])
    streaming = phase_streaming(scene, model["weights"])
    phase_crop(WORK_DIR, scene, model["weights"])
    phase_modes_cli(WORK_DIR, scene, model)

    convs = phase_conv()
    trunk_epilogue = phase_epilogue(WORK_DIR)
    upconvs = phase_upconv(WORK_DIR)
    channel_modes = phase_channel_modes(WORK_DIR)
    studies = phase_studies(os.path.join(WORK_DIR, "studies"))
    smoke = phase_config_smoke(WORK_DIR)
    start = time.perf_counter()
    train_scene = write_scene(os.path.join(WORK_DIR, "train_scene"), TRAIN_SCENE,
                              TRAIN_SCENE)
    log("setup", f"seeded {TRAIN_SCENE}^2 training scene written in "
        f"{time.perf_counter() - start:.1f} s")
    phase_train(WORK_DIR, train_scene)
    train_precisions = phase_train_precisions(train_scene)
    phase_train_balanced16_cli(WORK_DIR, train_scene)
    profile = phase_profile(WORK_DIR, train_scene)
    streaming_cli = phase_streaming_cli(WORK_DIR, train_scene)
    banded = phase_train_banded(WORK_DIR, train_scene, train_precisions["policies"])
    phase_train_vs_cpu(train_scene)
    dp_nccl = phase_dp_nccl_1(WORK_DIR, train_scene)
    dp_ranks = phase_dp_2_on_1(WORK_DIR, scene, model, train_scene)
    dryrun = phase_dryrun()
    shutil.rmtree(WORK_DIR, ignore_errors=True)

    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # K1 and K2 with their launches on the CLI runs (phase 4), the
    # streamed scenes (phases streaming and streaming-cli), the channel
    # modes' scenes (phase channel-modes), the ranks' scenes (phases
    # dp-nccl-1, dp-2-on-1 and dryrun), the studies and the config smoke.
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": replaces,
         "launches": (flagship["launches"][key] + streaming["launches"][key]
                      + streaming_cli["launches"][key]
                      + channel_modes["launches"].get(key, 0)
                      + dp_nccl["launches"].get(key, 0) + dp_ranks["launches"][key]
                      + dryrun["launches"][key]
                      + studies["launches"][key] + smoke["launches"][key]),
         **{f: kernels[key][f] for f in fields}}
        for key, (name, replaces) in KERNELS.items()]}
    # K3 once per float32 pass count, with its launches on the mode paths
    # (phases modes, streaming and channel-modes), the train steps (phases
    # train-precisions, profile and train-banded), the ranks' training
    # and serving (phases dp-nccl-1, dp-2-on-1 and dryrun), the studies and the
    # config smoke (phases studies and config-smoke), and its times and bound over one
    # forward of each mode at that pass count (phase 6); bfloat16 K3 is on
    # no path (the bf16 trunks run cuDNN): its launches are phase 6's, its
    # times each shape's once.
    # Then K3's float32 kernels alone (wide_f32: the trunk; narrow: Cout <=
    # 8; narrow_k: Cin <= 4 and 8 < Cout <= 64), each with its launches on
    # those paths and its share of those times and bounds; and narrow_bf16
    # (the composed top on the bf16 trunk) with its launches on those paths
    # and its times and bound at the top's convs, by their launches a
    # forward of each mode (``phase_conv_narrow_bf16``).
    name, source, replaces = K3
    k3_phases = (modes, train_precisions, streaming, banded, channel_modes, profile,
                 dp_nccl, dp_ranks, dryrun, studies, smoke)
    record["kernels"] += [
        {"name": (f"{name} (float32, {r['passes']} pass{'es' if r['passes'] > 1 else ''})"
                  if r["passes"] else f"{name} ({key})"),
         "route": "cuda", "source": source, "replaces": replaces,
         "launches": (sum(phase["launches"].get(r["passes"], 0) for phase in k3_phases)
                      if r["passes"] else r["launches"]),
         **{f: r[f] for f in fields}}
        for key, r in convs.items() if key not in K3_COUNTED]
    record["kernels"] += [
        {"name": label, "route": "cuda", "source": source, "replaces": replaces,
         "launches": sum(phase["launches"].get(variant, 0) for phase in k3_phases),
         **{f: convs[variant][f] for f in fields}}
        for variant, label in (
            ("wide_f32", f"{name}_wide_f32 (float32, Cout > 8 outside narrow_k's range)"),
            ("narrow", f"{name}_narrow (float32, Cout <= 8)"),
            ("narrow_k", "conv3x3_bias_act_narrow_k (float32, Cin <= 4, 8 < Cout <= 64)"),
            ("narrow_bf16", f"{name}_narrow_bf16 (bfloat16 x with passes, Cout <= 8)"))]
    # the trunk epilogue: its launches on the mode paths (phase modes), its
    # times over one balanced16 forward's 14 calls (its plain version is the
    # ATen ops)
    record["kernels"].append(
        {"name": "trunk_epilogue_kernel", "route": "cuda",
         "source": "resdepth_tpu_torch/csrc/epilogue.cu",
         "replaces": "none (XLA fuses these elementwise ops on the TPU)",
         "launches": modes["launches"]["epilogue"], "max_abs_err": 0.0,
         "ms": trunk_epilogue["ms"], "plain_ms": trunk_epilogue["plain_ms"],
         "bound_ms": trunk_epilogue["bound_ms"], "bound_by": "bytes",
         "library_ms": trunk_epilogue["plain_ms"]})
    # the upconv: its launches in phase upconv's scenes and forwards, its
    # times over the four decoder levels at 1 pass (balanced); the library's
    # is cuDNN's IEEE float32 transposed conv with the skip add
    record["kernels"].append(
        {"name": "transposed2x2_skip_kernel", "route": "cuda",
         "source": "resdepth_tpu_torch/csrc/upconv.cu",
         "replaces": "none (XLA runs the upconv on the TPU)",
         "launches": upconvs["launches"],
         "max_abs_err": max(r["rel_err_p1"] for r in upconvs["rows"]),
         "ms": upconvs["p1"]["ms"], "plain_ms": upconvs["p1"]["plain_ms"],
         "bound_ms": upconvs["bound_ms"], "bound_by": "bytes",
         "library_ms": upconvs["p1"]["library_ms"]})
    print(json.dumps(record))
    print(device["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": device["kind"],
                                             "count": device["count"]}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
