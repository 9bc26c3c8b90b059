"""Tile-stride study: scene refinement time against accuracy per stride
(the port's copy of ``scripts/stride_study.py``).

    python -m resdepth_tpu_torch.studies.stride_study --state-cache S.npz
        [--device cuda] [--rows 2048] [--cols 2048] [--scene-seed 3]
        [--mode balanced16] [--strides 128 160 192 224 256] [--stitch k2|k1]
        [--tile 256] [--depth 5] [--start-kernel 64] [--json OUT.json]

The reference evaluates at stride tile/2 (overlapping tiles, about 4x the
model's work a scene pixel); the inference CLI's ``general.tile_stride``
takes any stride in [tile/2, tile]. The state cache is the trained
geom-stereo model that ``studies/precision_study.py --state-cache`` writes
(or the JAX study's, at its 'default' training precision) for the same
scene seed; a cache of another seed is refused. For each stride the
study refines a seeded synthetic city (``utils/synth.py``) with
``infer/tiled.py::predict_linear_blend`` at ``--mode`` (a compute dtype or
serving mode; the folded model is built once), stitched by K2 (or K1 with
``--stitch k1``) on the card, and reports the refined MAE against the
ground truth, the mean |deviation| from the smallest stride's scene, and
the scene's time with rasters resident: device seconds from CUDA events
around a synchronised run on the card (best of 3 after a warm-up), host
seconds on the CPU; and one end-to-end run (upload, compute, fetch) on the
host clock, which must give the same scene.

On the CPU, from the smoke model's cache of ``precision_study``'s
docstring: ``--device cpu --tile 32 --depth 2 --start-kernel 4 --rows 128
--cols 128``.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch


def default_strides(tile: int) -> list:
    """tile/2 to tile in steps of tile/8 (128-256 for 256-px tiles)."""
    return [tile // 2 + k * tile // 8 for k in range(5)]


def test_dataset(city: dict, tile: int, stride: int | None = None):
    """The 'test' TileDataset of a ``precision_study.make_city`` city at
    ``stride`` (default tile/2)."""
    from resdepth_tpu_torch.data.dataset import TileDataset

    return TileDataset(city["entry"], "geom-stereo", tile, "test", stride=stride,
                       seed=0, **city["norm"])


def load_served(path: str, scene_seed: int, config, device, compute_dtype):
    """The state cache's model, folded for serving at ``compute_dtype`` on
    ``device`` once (``serving_model``); exits when the cache was trained on
    another scene seed, as the JAX study does."""
    from resdepth_tpu_torch.infer.tiled import serving_model
    from resdepth_tpu_torch.studies.precision_study import load_state_cache

    model, meta = load_state_cache(path, config, device)
    cached_seed = (meta.get("study_key") or {}).get("scene_seed")
    if cached_seed is not None and cached_seed != scene_seed:
        sys.exit(f"ERROR: --state-cache was trained on scene seed {cached_seed}, "
                 f"not --scene-seed {scene_seed}.")
    print(f"[weights] {path} (trained: {meta.get('study_key')})", flush=True)
    return serving_model(model, device, compute_dtype)


def scene_seconds(run, device, repeats: int = 3):
    """``(output of the last run, best seconds of ``repeats`` runs)`` after
    one warm-up run: CUDA events around each run on the card (the run
    synchronised at its end), the host clock on the CPU."""
    out = run()
    times = []
    for _ in range(repeats):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            start = time.perf_counter()
            out = run()
            times.append(time.perf_counter() - start)
    return out, min(times)


def time_key(device) -> str:
    """The result key of a scene's seconds: ``device_s`` from CUDA events
    on the card, ``host_s`` on the CPU."""
    return "device_s" if device.type == "cuda" else "host_s"


def add_common_arguments(ap: argparse.ArgumentParser, rows: int = 2048) -> None:
    """The arguments the flagship-cache serving studies share."""
    ap.add_argument("--state-cache", required=True,
                    help="trained checkpoint from studies/precision_study.py")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rows", type=int, default=rows)
    ap.add_argument("--cols", type=int, default=rows)
    ap.add_argument("--scene-seed", type=int, default=3)
    ap.add_argument("--mode", default="balanced16",
                    help="serving compute_dtype of the timed runs")
    ap.add_argument("--stitch", choices=("k2", "k1"), default="k2",
                    help="the stitch kernel on the card (K2: general.use_pallas "
                         "'fused'; K1: true)")
    ap.add_argument("--tile", type=int, default=256)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--start-kernel", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--json", default=None, help="also write the results as JSON")


def setup(args):
    """``(device, compute dtype, use_pallas, served model)`` of the parsed
    common arguments."""
    from resdepth_tpu_torch import predict
    from resdepth_tpu_torch.studies.precision_study import study_config

    device = predict.resolve_device(args.device)
    dtype = predict.select_compute_dtype(args.mode, device)
    served = load_served(args.state_cache, args.scene_seed,
                         study_config(args.depth, args.start_kernel), device, dtype)
    return device, dtype, ("fused" if args.stitch == "k2" else True), served


def main(argv=None) -> dict:
    from resdepth_tpu_torch.data.pipeline import device_put_dataset
    from resdepth_tpu_torch.infer.tiled import predict_linear_blend
    from resdepth_tpu_torch.studies.precision_study import device_name, make_city

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_common_arguments(ap)
    ap.add_argument("--strides", type=int, nargs="+", default=None,
                    help="default: tile/2 to tile in steps of tile/8")
    args = ap.parse_args(argv)
    strides = args.strides or default_strides(args.tile)
    device, dtype, use_pallas, served = setup(args)
    clock = time_key(device)

    results = {}
    with tempfile.TemporaryDirectory(prefix="stride_study_") as work:
        city = make_city(work, args.rows, args.cols, args.scene_seed)
        for stride in strides:
            ds = test_dataset(city, args.tile, stride)
            rasters = device_put_dataset(ds, device)

            def run():
                return predict_linear_blend(served, ds, device=device,
                                            batch_size=args.batch_size,
                                            compute_dtype=dtype, rasters=rasters,
                                            use_pallas=use_pallas, fold_bn=False,
                                            as_numpy=False)

            pred, seconds = scene_seconds(run, device)
            pred = pred.cpu().numpy()
            start = time.perf_counter()
            e2e = predict_linear_blend(served, ds, device=device,
                                       batch_size=args.batch_size, compute_dtype=dtype,
                                       use_pallas=use_pallas, fold_bn=False)
            e2e_s = time.perf_counter() - start
            np.testing.assert_allclose(e2e, pred, atol=1e-5)
            results[stride] = (pred, seconds, len(ds), e2e_s)
            print(f"[stride {stride:3d}] {len(ds):4d} tiles, {clock} {seconds:8.4f} "
                  f"s/scene, e2e {e2e_s:6.2f} s (host)", flush=True)
            del rasters

    gt, base_stride = city["gt"], min(strides)
    base = results[base_stride][0]
    valid = gt != -9999.0
    mae_in = float(np.abs(city["dsm_in"] - gt)[valid].mean())
    base_t = results[base_stride][1]
    base_mae = float(np.abs(base - gt)[valid].mean())
    cells = []
    print(f"\nscene {args.rows}x{args.cols}, mode {args.mode}, {device_name(device)}; "
          f"input MAE {mae_in:.3f} m")
    print(f"{'stride':>6s} {'tiles':>6s} {clock:>9s} {'speedup':>8s} {'e2e s':>7s} "
          f"{'MAE(m)':>8s} {'dMAE(cm)':>9s} {'dev-vs-' + str(base_stride):>12s}")
    for stride in strides:
        pred, t, n, e2e_s = results[stride]
        mae = float(np.abs(pred - gt)[valid].mean())
        dev = float(np.abs(pred - base)[valid].mean()) * 100
        cells.append({"stride": stride, "tiles": n, clock: t, "e2e_host_s": e2e_s,
                      "mae_m": mae, "dev_vs_base_cm": dev})
        print(f"{stride:6d} {n:6d} {t:9.4f} {base_t / t:7.2f}x {e2e_s:7.2f} "
              f"{mae:8.4f} {(mae - base_mae) * 100:+9.3f} {dev:9.3f}cm")
    out = {"device": device_name(device), "mode": args.mode, "stitch": args.stitch,
           "rows": args.rows, "cols": args.cols, "input_mae": mae_in, "cells": cells}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
