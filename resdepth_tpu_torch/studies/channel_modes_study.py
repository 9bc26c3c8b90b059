"""Input-channel-mode study: serving tiles/s and the ``balanced16``
deviation of each channel mode (the port's copy of
``scripts/channel_modes_study.py``).

    python -m resdepth_tpu_torch.studies.channel_modes_study [--device cuda]
        [--steps 400] [--scene-seed 3]
        [--modes geom,geom-mono,stereo,geom-stereo,geom-multiview]
        [--state-cache-dir DIR] [--json OUT.json] [--smoke-model] [--tile T]
        [--bench-batch B] [--iters N] [--rows R] [--cols C] [--dev-rows D]
        [--train-batch B]

The channel modes give the flagship's first conv 1 (``geom``), 2
(``geom-mono``, ``stereo``), 3 (``geom-stereo``, the control) or 4
(``geom-multiview`` 3-view) input channels. For each mode:

  1. train the flagship UNet for ``--steps`` steps at batch 20 on a
     synthetic city with the mode's channel stack (three hillshade views,
     ``MODE_PAIRS``), with ``make_train_step`` at the 'default' policy (one
     bf16 pass a conv, the JAX study's ``Precision.DEFAULT``; on the card K3
     runs the forward and dx of each 3x3 conv). The JAX study fuses 8 steps
     into one call (``steps_per_call`` 8); the port runs one step a call over
     the same draws of positions and pairs, which changes no result;
  2. time serving of the folded flagship at float32 and ``balanced16``:
     tiles/s at ``--bench-batch`` tiles (the best of 3 runs of ``--iters``
     forwards between CUDA events), and the rate of
     operations (``analytic_flops``) as a share of the card's bf16 peak
     (``PEAK_BF16``);
  3. refine a second city (``--dev-rows`` square, one image pair of the
     mode's arity, ``DEV_PAIRS``) at float32, ``balanced16`` and bfloat16
     with K2 (``use_pallas="fused"``), and report the mean |deviation| of
     ``balanced16`` and bfloat16 from float32 in cm, and the input and
     float32 refined MAE against the ground truth.

``stereo`` takes no DSM channel, so its model has no outer skip (the train
config's validator requires that; the JAX study kept it). With
``--state-cache-dir`` each mode's trained weights are read from, or written
to, ``<dir>/<mode>.npz`` in the JAX checkpoint layout with the JAX study's
``study_key`` metadata, so a cache either study wrote loads in the other.
The results (the JAX study's keys, unrounded, and the device's name) are
printed and, with ``--json``, written.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

# Published dense bf16 tensor rate of one H100 SXM at 700 W (NVIDIA's data
# sheet), the yardstick of the utilisation printed beside tiles/s.
PEAK_BF16 = 989e12

# Per-mode image wiring (3 hillshade views from azimuths 315/135/45): mono
# single-image "pairs", stereo modes 2-image pairs, multiview 3-view one
# 3-image tuple (the reference's arity rules).
MODE_PAIRS = {
    "geom": None,
    "geom-mono": [(0,), (1,)],
    "stereo": [(0, 1), (1, 2)],
    "geom-stereo": [(0, 1), (1, 2)],
    "geom-multiview": [(0, 1, 2)],
}
DEV_PAIRS = {  # deviation scene: one pair of the mode's arity
    "geom": None,
    "geom-mono": [(0,)],
    "stereo": [(0, 1)],
    "geom-stereo": [(0, 1)],
    "geom-multiview": [(0, 1, 2)],
}
STEPS_A_DRAW = 8     # positions are drawn 8 steps at a time, as the JAX study's calls


def mode_config(mode: str, smoke: bool = False):
    """The flagship's config for a channel mode (no outer skip for
    ``stereo``); ``smoke``: depth 2, start 4, cap 8, for CPU runs."""
    from resdepth_tpu_torch.models.unet import flagship_config

    config = flagship_config(mode)
    if mode == "stereo":
        config = dataclasses.replace(config, outer_skip=False)
    if smoke:
        config = dataclasses.replace(config, depth=2, start_kernel=4, max_filter_depth=8)
    return config


def make_scene(work: str, rows: int, cols: int, dev_rows: int, scene_seed: int) -> dict:
    """The training city (``rows`` x ``cols``) and the deviation city
    (``dev_rows`` square, seed ``scene_seed + 7``), each with three
    hillshade views, as GeoTIFFs in ``work``; the sigma and view
    normalisation from the training city."""
    from resdepth_tpu_torch.geo import tiff
    from resdepth_tpu_torch.geo.allocation import entire_area_defn
    from resdepth_tpu_torch.utils.synth import hillshade, synth_city

    os.makedirs(work, exist_ok=True)
    azimuths = (315.0, 135.0, 45.0)
    gt, dsm_in, *_ = synth_city(rows, cols, seed=scene_seed)
    views = np.stack([hillshade(gt, az) for az in azimuths], -1)
    geotransform = (1000.0, 0.25, 0.0, 2000.0, 0.0, -0.25)

    def write(name, data):
        path = os.path.join(work, name)
        tiff.write(path, data, geotransform=geotransform, nodata=-9999.0)
        return path

    d_gt, d_in, *_ = synth_city(dev_rows, dev_rows, seed=scene_seed + 7)
    d_views = np.stack([hillshade(d_gt, az) for az in azimuths], -1)
    p_in = write("dsm.tif", dsm_in)
    scene = {
        "rows": rows, "cols": cols,
        "p_in": p_in, "p_gt": write("gt.tif", gt),
        "view_paths": [write(f"ortho_{j}.tif", views[..., j]) for j in range(3)],
        "area": entire_area_defn(p_in),
        "sigma": float(np.std(dsm_in - dsm_in.mean())),
        "view_mean": float(views.mean()), "view_std": float(views.std()),
        "dev_in": write("dev_dsm.tif", d_in),
        "dev_paths": [write(f"dev_ortho_{j}.tif", d_views[..., j]) for j in range(3)],
        "dev_gt": d_gt, "dev_in_arr": d_in,
    }
    scene["dev_area"] = entire_area_defn(scene["dev_in"])
    return scene


def dev_dataset(mode: str, scene: dict, tile: int, area_defn: dict | None = None):
    """The deviation city's 'test' TileDataset for ``mode``, over
    ``area_defn`` (default: the whole city)."""
    from resdepth_tpu_torch.data.dataset import TileDataset

    entry = {"name": f"dev_{mode}", "raster_in": scene["dev_in"],
             "area_defn": area_defn or scene["dev_area"]}
    if DEV_PAIRS[mode] is not None:
        entry.update(image_list=scene["dev_paths"], image_pairs=DEV_PAIRS[mode])
    return TileDataset(entry, mode, tile, "test", dsm_std=scene["sigma"],
                       ortho_mean=scene["view_mean"], ortho_std=scene["view_std"], seed=0)


def _train(mode, config, scene, device, args, cache_key):
    """The mode's trained model: from the cache, or ``args.steps`` steps at
    the 'default' policy (written to the cache when one is set)."""
    from resdepth_tpu_torch.data.dataset import TileDataset
    from resdepth_tpu_torch.data.pipeline import (GeneratorDraws, batch_spec_for,
                                                  device_put_dataset)
    from resdepth_tpu_torch.models.unet import init_unet
    from resdepth_tpu_torch.studies.precision_study import (load_state_cache,
                                                            save_state_cache)
    from resdepth_tpu_torch.train import checkpoint as ckpt_io
    from resdepth_tpu_torch.train.step import (init_train_state, make_train_step,
                                               select_train_precision)

    cache = (os.path.join(args.state_cache_dir, f"{mode}.npz")
             if args.state_cache_dir else None)
    if cache and os.path.exists(cache):
        # Provenance first: a cache of other settings gets this message, not
        # a shape error.
        meta = ckpt_io.load_meta(cache)
        if meta.get("study_key") != cache_key:
            sys.exit(f"ERROR: cache {cache} trained with {meta.get('study_key')}, "
                     f"not {cache_key}.")
        print(f"[{mode}/train] loaded cached state: {cache}", flush=True)
        return load_state_cache(cache, config, device)[0]

    model = init_unet(config, torch.Generator().manual_seed(0), device)

    rows, cols, tile = scene["rows"], scene["cols"], args.tile
    dataset = {"name": mode, "raster_in": scene["p_in"], "raster_gt": scene["p_gt"],
               "area_defn": scene["area"], "n_samples": 4000}
    if MODE_PAIRS[mode] is not None:
        dataset.update(image_list=scene["view_paths"], image_pairs=MODE_PAIRS[mode])
    train_ds = TileDataset(dataset, mode, tile, "train", dsm_std=scene["sigma"],
                           ortho_mean=scene["view_mean"], ortho_std=scene["view_std"],
                           use_all_stereo_pairs=True, augment=True, seed=0)
    policy, _ = select_train_precision("default", "float32", device)
    state = init_train_state(model, "Adam", 2e-4, 1e-5)
    step = make_train_step(batch_spec_for(train_ds), **policy)
    rasters = device_put_dataset(train_ds, device, include_target=True)
    draws = GeneratorDraws(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(args.scene_seed + 1)
    n_pairs = len(MODE_PAIRS[mode] or [()])
    k, b = STEPS_A_DRAW, args.train_batch
    n_draws = max(1, args.steps // k)
    print(f"[{mode}/train] flagship: {n_draws * k} steps, batch {b}", flush=True)
    start = time.perf_counter()
    maes = []
    for _ in range(n_draws):
        pos = np.stack([rng.integers(0, rows - tile, (k, b)),
                        rng.integers(0, cols - tile, (k, b))], -1).astype(np.int32)
        pidx = rng.integers(0, n_pairs, (k, b)).astype(np.int32)
        for i in range(k):
            maes.append(step(state, rasters, pos[i], pidx[i], np.zeros((b, 4), np.int32),
                             np.ones(b, np.float32), draws))
    print(f"[{mode}/train] MAE {float(maes[0]):.3f} -> {float(maes[-1]):.3f} m "
          f"({time.perf_counter() - start:.0f}s)", flush=True)
    model.eval()
    if cache:
        save_state_cache(cache, model, cache_key)
    return model


def run_mode(mode: str, args, scene: dict, results: dict, device) -> None:
    from resdepth_tpu_torch.infer.tiled import predict_linear_blend, serving_model
    from resdepth_tpu_torch.models.unet import analytic_flops
    from resdepth_tpu_torch.predict import select_compute_dtype
    from resdepth_tpu_torch.studies.precision_study import tiles_per_s

    config = mode_config(mode, args.smoke_model)
    cache_key = {"scene_seed": args.scene_seed, "steps": args.steps,
                 "rows": scene["rows"], "cols": scene["cols"], "batch": args.train_batch,
                 "tile": args.tile, "mode": mode, "smoke": args.smoke_model}
    model = _train(mode, config, scene, device, args, cache_key)

    gflops = analytic_flops(config, args.tile, composed_top=True) / 1e9
    for prec in ("float32", "balanced16"):
        tag = "f32" if prec == "float32" else prec
        dtype = select_compute_dtype(prec, device)
        tps = tiles_per_s(serving_model(model, device, dtype), prec, device,
                          args.bench_batch, args.tile, config.n_input_channels,
                          iters=args.iters)
        results[f"{mode}_{tag}_tiles_s"] = tps
        tflops = tps * gflops / 1e3
        rate = (f" ({tflops:.1f} TFLOP/s = {100 * tflops * 1e12 / PEAK_BF16:.1f}% of the "
                "H100's bf16 peak)" if device.type == "cuda" else " on the CPU")
        print(f"[{mode}/serve/{tag}] {tps:7.1f} tiles/s{rate}", flush=True)

    ds = dev_dataset(mode, scene, args.tile)
    preds = {}
    for prec in ("float32", "balanced16", "bfloat16"):
        dtype = select_compute_dtype(prec, device)
        preds[prec] = predict_linear_blend(serving_model(model, device, dtype), ds,
                                           device=device, batch_size=128,
                                           compute_dtype=dtype, use_pallas="fused",
                                           fold_bn=False)
    valid = scene["dev_gt"] != -9999.0
    for prec in ("balanced16", "bfloat16"):
        dev_cm = float(np.abs(preds[prec] - preds["float32"])[valid].mean()) * 100
        results[f"{mode}_{prec}_dev_cm"] = dev_cm
        print(f"[{mode}/deviation/{prec}] mean |delta| vs exact f32: {dev_cm:.3f} cm",
              flush=True)
    mae_in = float(np.abs(scene["dev_in_arr"] - scene["dev_gt"])[valid].mean())
    mae_ref = float(np.abs(preds["float32"] - scene["dev_gt"])[valid].mean())
    results[f"{mode}_dev_scene_mae"] = {"input": mae_in, "refined_f32": mae_ref}
    print(f"[{mode}/deviation scene] input MAE {mae_in:.3f} m -> refined "
          f"{mae_ref:.3f} m (f32)", flush=True)


def main(argv=None) -> dict:
    from resdepth_tpu_torch.predict import resolve_device
    from resdepth_tpu_torch.studies.precision_study import device_name

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--cols", type=int, default=768)
    ap.add_argument("--scene-seed", type=int, default=3)
    ap.add_argument("--dev-rows", type=int, default=1024)
    ap.add_argument("--modes", default="geom,geom-mono,stereo,geom-stereo,geom-multiview")
    ap.add_argument("--state-cache-dir", default=None,
                    help="read or write each mode's trained weights here")
    ap.add_argument("--json", default=None)
    ap.add_argument("--tile", type=int, default=256)
    ap.add_argument("--bench-batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--train-batch", type=int, default=20)
    ap.add_argument("--smoke-model", action="store_true",
                    help="depth-2/start-4 model: CPU wiring smoke only")
    args = ap.parse_args(argv)
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    unknown = [m for m in modes if m not in MODE_PAIRS]
    if unknown:
        sys.exit(f"ERROR: unknown --modes {unknown}; valid: {sorted(MODE_PAIRS)}")
    device = resolve_device(args.device)
    if args.state_cache_dir:
        os.makedirs(args.state_cache_dir, exist_ok=True)
    results = {"steps": args.steps, "scene_seed": args.scene_seed,
               "device": device_name(device)}
    with tempfile.TemporaryDirectory(prefix="chmodes_study_") as work:
        scene = make_scene(work, args.rows, args.cols, args.dev_rows, args.scene_seed)
        for mode in modes:
            run_mode(mode, args, scene, results, device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"results -> {args.json}")
    return results


if __name__ == "__main__":
    main()
