"""Bilinear up-mode serving: tiles/s and the trained weights' deviation
(the port's copy of ``scripts/bilinear_study.py``).

    python -m resdepth_tpu_torch.studies.bilinear_study [--device cuda]
        [--steps 400] [--rows 512] [--cols 768] [--scene-seed 3] [--batch 20]
        [--state-cache PATH.npz] [--dev-rows 1024] [--json OUT.json]
        [--tile 256] [--depth 5] [--start-kernel 64] [--bench-batch 128]
        [--iters 16]

``up_mode='bilinear'`` (the reference's Upsample + 1x1 conv) serves the
unfolded graph: ``fold_top_decoder`` is a no-op for it, as in the JAX
package, so its last conv stays one 3x3 conv to one channel (on K3 at 3
passes in ``balanced16``, beside ``encoder0``). The study

  1. trains a bilinear geom-stereo model with the precision study's
     protocol (``studies/precision_study.py``: ``--steps`` Adam steps at
     batch ``--batch`` on a seeded 512x768 city, the 'default' training
     precision the JAX study trains at), or reads it from ``--state-cache``
     (the JAX layout, ``study_key`` with ``up_mode: bilinear``; a cache of
     another key is refused);
  2. times the folded serving forward of the bilinear model and of a
     seeded transpose model at float32 and ``balanced16``: tiles/s at
     ``--bench-batch`` tiles, ``--iters`` forwards between CUDA events on
     the card (host clock on the CPU), best of 3 windows after a warm-up
     (``precision_study.tiles_per_s``);
  3. refines a second city (``--dev-rows`` square, scene seed + 7, two
     views) with the bilinear weights at float32, ``balanced16`` and
     bfloat16 (K2 on the card), and reports the mean |deviation| from
     float32 in cm and the input and refined MAE.

The results carry the JAX study's keys, unrounded, and the device's name.
On the CPU: ``--device cpu --steps 2 --batch 2 --rows 64 --cols 96
--dev-rows 64 --tile 32 --depth 2 --start-kernel 4 --bench-batch 2
--iters 1``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    from resdepth_tpu_torch import predict
    from resdepth_tpu_torch.data.dataset import TileDataset
    from resdepth_tpu_torch.geo import tiff
    from resdepth_tpu_torch.geo.allocation import entire_area_defn
    from resdepth_tpu_torch.infer.tiled import predict_linear_blend, serving_model
    from resdepth_tpu_torch.models.unet import init_unet
    from resdepth_tpu_torch.studies import precision_study as ps
    from resdepth_tpu_torch.utils.synth import hillshade, synth_city

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--cols", type=int, default=768)
    ap.add_argument("--scene-seed", type=int, default=3)
    ap.add_argument("--batch", type=int, default=20)
    ap.add_argument("--state-cache", default=None,
                    help="read the trained bilinear weights here, or write them")
    ap.add_argument("--dev-rows", type=int, default=1024,
                    help="deviation-scene size (refined f32 vs balanced16)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--tile", type=int, default=256)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--start-kernel", type=int, default=64)
    ap.add_argument("--bench-batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=16)
    args = ap.parse_args(argv)
    device = predict.resolve_device(args.device)
    train_precision = "default"
    transpose = ps.study_config(args.depth, args.start_kernel)
    config = dataclasses.replace(transpose, up_mode="bilinear")
    key = {**ps.study_key(args.scene_seed, args.steps, args.rows, args.cols, args.batch,
                          train_precision), "up_mode": "bilinear"}
    results = {"device": ps.device_name(device)}

    with tempfile.TemporaryDirectory(prefix="bilinear_study_") as work:
        _, train_ds, _ = ps._scene(work, args.rows, args.cols, args.scene_seed, args.tile)
        if args.state_cache and os.path.exists(args.state_cache):
            model, _ = ps.load_state_cache(args.state_cache, config, device, key)
            print(f"[train] loaded cached bilinear state: {args.state_cache}", flush=True)
        else:
            print(f"[train] bilinear model: {args.steps} steps, batch {args.batch}",
                  flush=True)
            start = time.perf_counter()
            model, first, last = ps._train(config, train_ds, device, args.steps,
                                           args.batch, args.scene_seed, train_precision)
            print(f"[train] MAE {first:.3f} -> {last:.3f} m "
                  f"({time.perf_counter() - start:.0f}s)", flush=True)
            if args.state_cache:
                ps.save_state_cache(args.state_cache, model, key)

        # ------------------------ serving throughput --------------------- #
        other = init_unet(transpose, torch.Generator().manual_seed(0), device).eval()
        for mode in ("float32", "balanced16"):
            tag = "f32" if mode == "float32" else mode
            dtype = predict.select_compute_dtype(mode, device)
            rates = {name: ps.tiles_per_s(serving_model(m, device, dtype), mode,
                                          device, args.bench_batch, args.tile,
                                          config.n_input_channels, args.iters)
                     for name, m in (("bilinear", model), ("transpose", other))}
            results[f"bilinear_{tag}_tiles_s"] = rates["bilinear"]
            results[f"transpose_{tag}_tiles_s"] = rates["transpose"]
            print(f"[serve/{tag}] bilinear {rates['bilinear']:7.1f} tiles/s | "
                  f"transpose {rates['transpose']:7.1f} tiles/s (same process) | "
                  f"ratio {rates['bilinear'] / rates['transpose']:.2f}x", flush=True)

        # --------------------- trained-weights deviation ------------------ #
        d_gt, d_in, *_ = synth_city(args.dev_rows, args.dev_rows, seed=args.scene_seed + 7)
        d_views = np.stack([hillshade(d_gt, az) for az in (315.0, 135.0)], -1)

        def write(name, data):
            path = os.path.join(work, name)
            tiff.write(path, data, geotransform=(1000.0, 0.25, 0.0, 2000.0, 0.0, -0.25),
                       nodata=-9999.0)
            return path

        p_in = write("dev_dsm.tif", d_in)
        entry = {"name": "dev", "raster_in": p_in,
                 "image_list": [write(f"dev_ortho_{j}.tif", d_views[..., j])
                                for j in range(2)],
                 "image_pairs": [(0, 1)], "area_defn": entire_area_defn(p_in)}
        ds = TileDataset(entry, "geom-stereo", args.tile, "test",
                         dsm_std=train_ds.dsm_std, ortho_mean=train_ds.ortho_mean,
                         ortho_std=train_ds.ortho_std, seed=0)
        preds = {}
        for mode in ("float32", "balanced16", "bfloat16"):
            dtype = predict.select_compute_dtype(mode, device)
            preds[mode] = predict_linear_blend(serving_model(model, device, dtype), ds,
                                               device=device, batch_size=128,
                                               compute_dtype=dtype, use_pallas="fused",
                                               fold_bn=False)
    valid = d_gt != -9999.0
    for mode in ("balanced16", "bfloat16"):
        dev_cm = float(np.abs(preds[mode] - preds["float32"])[valid].mean()) * 100
        results[f"bilinear_{mode}_dev_cm"] = dev_cm
        print(f"[deviation/{mode}] mean |delta| vs exact f32: {dev_cm:.3f} cm", flush=True)
    results["dev_scene_input_mae"] = float(np.abs(d_in - d_gt)[valid].mean())
    results["dev_scene_refined_mae_f32"] = float(np.abs(preds["float32"] - d_gt)[valid].mean())
    print(f"[deviation scene] input MAE {results['dev_scene_input_mae']:.3f} m -> refined "
          f"{results['dev_scene_refined_mae_f32']:.3f} m (bilinear f32)", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"results -> {args.json}")
    return results


if __name__ == "__main__":
    main()
