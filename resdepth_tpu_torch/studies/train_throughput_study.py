"""Train-step throughput matrix: precision mode x remat x batch (the port's
copy of ``scripts/train_throughput_study.py``).

    python -m resdepth_tpu_torch.studies.train_throughput_study
        [--device cuda] [--modes high,default,balanced,balanced16,bf16]
        [--batches 3,20,32] [--remat off|on|both] [-K 8] [--windows 3]
        [--tile 256] [--depth 5] [--start-kernel 64]

The geom-stereo step (``train/step.py::make_train_step``, Adam lr 2e-4
with weight decay 1e-5, augmentation on) on synthetic 512x512 rasters made
from a numpy seed, as the JAX study makes them. The modes are the train
CLI's, mapped through ``select_train_precision``: ``high`` (IEEE float32,
TF32 off), ``default`` (one bf16 pass a conv), ``balanced``,
``balanced16`` (the serving modes of those names) and ``bf16``
(``tpu.compute_dtype: bfloat16``); on the card K3 runs the forward and dx
of every float32 conv with a pass count. ``--remat`` recomputes each conv
block in the backward pass (``tpu.remat``).

A window is ``-K`` steps between CUDA events on the card (host clock on
the CPU, with the batch's last metric fetched); the best of ``--windows``
windows after one untimed window gives samples/s and ms a step. The JAX
study's ``steps_per_call`` fuses K steps into one program and reports the
first call's compile time; the port runs K eager steps (``steps_per_call``
is a no-op on one GPU) and compiles no program, so there is no compile
column: the untimed first window's host seconds are reported as such.

On the CPU: ``--device cpu --modes default --batches 2 -K 1 --windows 1
--tile 32 --depth 2 --start-kernel 4``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

RASTER = 512
MODES = {"high": ("high", "float32"), "default": ("default", "float32"),
         "balanced": ("balanced", "float32"), "balanced16": ("balanced16", "float32"),
         "bf16": (None, "bfloat16")}


def build_step(config, tile: int, mode: str, remat: bool, device):
    """``(state, step, rasters)`` of the study's train step at ``mode``."""
    from resdepth_tpu_torch.data.pipeline import BatchSpec, DeviceRasters
    from resdepth_tpu_torch.models.unet import init_unet
    from resdepth_tpu_torch.train.step import (init_train_state, make_train_step,
                                               select_train_precision)

    rng = np.random.default_rng(0)
    gt = rng.normal(400.0, 5.0, (RASTER, RASTER)).astype(np.float32)
    dsm = gt + rng.normal(0, 1, (RASTER, RASTER)).astype(np.float32)
    orthos = rng.normal(120, 25, (3, RASTER, RASTER)).astype(np.float32)
    rasters = DeviceRasters(dsm_input=torch.from_numpy(dsm).to(device),
                            dsm_target=torch.from_numpy(gt).to(device),
                            orthos=torch.from_numpy(orthos).to(device),
                            pairs=torch.tensor([[0, 1], [0, 2]], dtype=torch.int64,
                                               device=device),
                            nodata=-9999.0)
    spec = BatchSpec(input_channels="geom-stereo", tile_size=tile, dsm_std=5.0,
                     augment=True)
    train_precision, compute_dtype = MODES[mode]
    policy, dtype = select_train_precision(train_precision, compute_dtype, device)
    model = init_unet(config, torch.Generator().manual_seed(0), device)
    state = init_train_state(model, "Adam", 2e-4, 1e-5)
    step = make_train_step(spec, remat=remat, compute_dtype=dtype, **policy)
    return state, step, rasters


def measure(config, tile: int, mode: str, batch: int, remat: bool, k: int,
            windows: int, device) -> dict:
    """Samples/s and ms a step of the best of ``windows`` windows of ``k``
    steps, after one untimed window."""
    from resdepth_tpu_torch.data.pipeline import GeneratorDraws

    state, step, rasters = build_step(config, tile, mode, remat, device)
    rng = np.random.default_rng(0)
    draws = GeneratorDraws(torch.Generator(device=device).manual_seed(0))
    bounds = np.zeros((batch, 4), np.int32)
    weights = np.ones(batch, np.float32)

    def window() -> float:
        pos = np.stack([rng.integers(0, RASTER - tile, (k, batch)),
                        rng.integers(0, RASTER - tile, (k, batch))], -1).astype(np.int32)
        pidx = rng.integers(0, 2, (k, batch)).astype(np.int32)
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        for i in range(k):
            metric = step(state, rasters, pos[i], pidx[i], bounds, weights, draws)
        if device.type == "cuda":
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            seconds = time.perf_counter() - t0
        last = float(metric)
        if not np.isfinite(last):
            raise RuntimeError(f"non-finite train metric: {last}")
        return seconds

    t0 = time.perf_counter()
    window()
    first_s = time.perf_counter() - t0
    best = min(window() for _ in range(windows))
    return {"mode": mode, "batch": batch, "remat": remat,
            "samples_per_sec": k * batch / best, "step_ms": 1000 * best / k,
            "first_window_host_s": first_s,
            "clock": "cuda events" if device.type == "cuda" else "host"}


def main(argv=None) -> list:
    from resdepth_tpu_torch import predict
    from resdepth_tpu_torch.studies.precision_study import device_name, study_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--modes", default="high",
                    help="comma list: high,default,balanced,balanced16,bf16")
    ap.add_argument("--batches", default="20", help="comma list of batch sizes")
    ap.add_argument("--remat", choices=["off", "on", "both"], default="off")
    ap.add_argument("-K", type=int, default=8, help="steps a timed window")
    ap.add_argument("--windows", type=int, default=3, help="timed windows")
    ap.add_argument("--tile", type=int, default=256)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--start-kernel", type=int, default=64)
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    unknown = [m for m in modes if m not in MODES]
    if unknown:
        ap.error(f"unknown --modes {unknown}; valid: {list(MODES)}")
    device = predict.resolve_device(args.device)
    config = study_config(args.depth, args.start_kernel)
    batches = [int(b) for b in args.batches.split(",")]
    remats = {"off": [False], "on": [True], "both": [False, True]}[args.remat]
    name = device_name(device)

    results = []
    for mode in modes:
        for batch in batches:
            for remat in remats:
                r = measure(config, args.tile, mode, batch, remat, args.K, args.windows,
                            device)
                results.append(r)
                print(f"[{mode} B={batch} remat={'on' if remat else 'off'}] "
                      f"{r['samples_per_sec']:.1f} samples/s ({r['step_ms']:.2f} "
                      f"ms/step, {r['clock']}; first window {r['first_window_host_s']:.1f} "
                      "s on the host, no compile step)", flush=True)

    print(f"\n{name}; {args.K} steps a window, best of {args.windows}")
    print("| mode | batch | remat | samples/s | ms/step |")
    print("|---|---|---|---|---|")
    for r in results:
        print(f"| {r['mode']} | {r['batch']} | {'on' if r['remat'] else 'off'} | "
              f"{r['samples_per_sec']:.1f} | {r['step_ms']:.2f} |")
    return results


if __name__ == "__main__":
    main()
