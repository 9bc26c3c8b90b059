"""Serving-precision deviation study on trained weights (the port's copy of
``scripts/precision_study.py``).

    python -m resdepth_tpu_torch.studies.precision_study [--device cuda]
        [--steps 400] [--batch 20] [--rows 512] [--cols 768] [--seeds 3 4 5]
        [--train-precision high] [--out study.json]

For each scene seed: train the flagship geom-stereo UNet from a seeded
initialisation on a synthetic city (``utils/synth.py``) with the port's
trainer step at ``--train-precision`` (``tpu.train_precision``: 'high',
the default, is IEEE f32 with TF32 off; the JAX study trains at 'default',
one bf16 pass), then refine the scene with ``predict_linear_blend`` at
float32, bfloat16 and each string serving mode, and report each mode's
deviation from the float32 scene over the valid pixels: mean, p99 and max
in cm. On a CUDA device each mode's UNet outputs on the scene's tiles are
also computed on the CPU: the mean |card - CPU| as a share of the mode's
own mean deviation from float32 on the card (``card_vs_cpu_share``, the
measure of ``chip_smoke.py``'s crop), and beside it the same share with
K3's plain version (cuDNN) in its place on the card, against the CPU and
against K3. Each mode's UNet forward at
``--bench-batch`` tiles is timed once (first seed), as tiles/s on the
device the study runs on, beside the device's name. The table is printed
and, with ``--out``, written as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

MODES = ("float32", "bfloat16", "mixed", "fast32", "act2pass", "balanced",
         "balanced16")


def device_name(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
        return smi.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def _scene(work: str, rows: int, cols: int, seed: int, tile: int):
    """The seeded city as GeoTIFFs; its 'train' and 'test' TileDatasets."""
    from resdepth_tpu_torch.data.dataset import TileDataset
    from resdepth_tpu_torch.geo import tiff
    from resdepth_tpu_torch.geo.allocation import entire_area_defn
    from resdepth_tpu_torch.utils.synth import hillshade, synth_city

    gt, dsm_in, _, _ = synth_city(rows, cols, seed=seed)
    views = np.stack([hillshade(gt, az) for az in (315.0, 135.0, 45.0)], -1)
    geotransform = (1000.0, 0.25, 0.0, 2000.0, 0.0, -0.25)

    def write(name, data):
        path = os.path.join(work, name)
        tiff.write(path, data, geotransform=geotransform, nodata=-9999.0)
        return path

    p_in = write("dsm.tif", dsm_in)
    dataset = {"name": "study", "raster_in": p_in, "raster_gt": write("gt.tif", gt),
               "image_list": [write(f"ortho_{j}.tif", views[..., j]) for j in range(3)],
               "image_pairs": [(0, 1), (1, 2)], "area_defn": entire_area_defn(p_in),
               "n_samples": 1}   # the study draws its own training positions
    sigma = float(np.std(dsm_in - dsm_in.mean()))
    common = dict(dsm_std=sigma, ortho_mean=float(views.mean()),
                  ortho_std=float(views.std()), seed=0)
    train_ds = TileDataset(dataset, "geom-stereo", tile, "train",
                           use_all_stereo_pairs=True, augment=True, **common)
    test_ds = TileDataset(dict(dataset, image_pairs=[(0, 1)]), "geom-stereo", tile,
                          "test", **common)
    return gt, train_ds, test_ds


def _train(config, train_ds, device, steps: int, batch: int, seed: int,
           train_precision: str = "high"):
    """``steps`` Adam steps (lr 2e-4, weight decay 1e-5) at
    ``train_precision`` (float32 compute) on random tiles; returns the model
    and the first and last batch MAE (m)."""
    from resdepth_tpu_torch.data.pipeline import batch_spec_for, device_put_dataset
    from resdepth_tpu_torch.models.unet import init_unet
    from resdepth_tpu_torch.train.step import (init_train_state, make_train_step,
                                               select_train_precision)

    policy, _ = select_train_precision(train_precision, "float32", device)
    model = init_unet(config, torch.Generator().manual_seed(0), device)
    state = init_train_state(model, "Adam", 2e-4, 1e-5)
    spec = batch_spec_for(train_ds, transform_dsm=True, transform_orthos=True,
                          augment=True)
    step = make_train_step(spec, **policy)
    rasters = device_put_dataset(train_ds, device, include_target=True)
    generator = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    rows, cols = train_ds.dsm_input.shape
    tile = train_ds.tile_size
    maes = []
    for _ in range(steps):
        pos = np.stack([rng.integers(0, rows - tile, batch),
                        rng.integers(0, cols - tile, batch)], -1).astype(np.int32)
        pair = rng.integers(0, 2, batch).astype(np.int32)
        maes.append(step(state, rasters, pos, pair, np.zeros((batch, 4), np.int32),
                         np.ones(batch, np.float32), generator))
    model.eval()
    return model, float(maes[0]), float(maes[-1])


def tiles_per_s(served, mode, device, batch: int, tile: int, n_in: int,
                 iters: int = 3) -> float:
    """Forward throughput of the served model at ``batch`` tiles: the best
    of 3 timings of ``iters`` forwards each, after a warm-up, on the host
    clock around synchronised runs."""
    from resdepth_tpu_torch.infer.tiled import _storage
    from resdepth_tpu_torch.models.unet import apply_unet

    dtype, kwargs = _storage({"float32": torch.float32,
                              "bfloat16": torch.bfloat16}.get(mode, mode))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(batch, tile, tile, n_in)).astype(np.float32)).to(device, dtype)

    def run():
        with torch.inference_mode():
            for _ in range(iters):
                apply_unet(served, x, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run()
    best = float("inf")
    for _ in range(3):
        start = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - start)
    return iters * batch / best


def _card_vs_cpu_shares(model, test_ds, device) -> dict:
    """Each mode's UNet outputs on the test tiles, on ``device`` and on the
    CPU, as shares of the mode's own mean |deviation| from float32 on the
    card, by mode (bfloat16 included): ``card_vs_cpu`` the mean |card -
    CPU|; ``plain_vs_cpu`` with K3's plain version (cuDNN over the split
    operands) in its place on the card; ``k3_vs_plain`` K3 against that on
    the card. The last two tell K3's sums from another device's."""
    from unittest import mock

    from resdepth_tpu_torch import predict
    from resdepth_tpu_torch.data.pipeline import build_batch, device_put_dataset
    from resdepth_tpu_torch.infer.tiled import _inference_spec, _storage, serving_model
    from resdepth_tpu_torch.models import unet
    from resdepth_tpu_torch.ops import conv

    x = build_batch(device_put_dataset(test_ds, device),
                    torch.from_numpy(test_ds.positions.astype(np.int32)).to(device),
                    torch.from_numpy(test_ds.pair_indices.astype(np.int64)).to(device),
                    _inference_spec(test_ds))["input"].cpu()

    def forward(mode, on, k3=conv.conv3x3_bias_act):
        dtype = predict.select_compute_dtype(mode, on)
        storage, kwargs = _storage(dtype)
        served = serving_model(model, on, dtype)
        with torch.inference_mode(), mock.patch.object(unet, "conv3x3_bias_act", k3):
            return unet.apply_unet(served, x.to(on, storage), **kwargs).float().cpu().numpy()

    def share(a, b, mode):
        return float(np.abs(a - b).mean() / np.abs(card[mode] - card["float32"]).mean())

    card = {mode: forward(mode, device) for mode in MODES}
    shares = {}
    for mode in MODES[1:]:
        cpu = forward(mode, torch.device("cpu"))
        plain = forward(mode, device, conv.conv3x3_bias_act_plain)
        shares[mode] = {"card_vs_cpu": share(card[mode], cpu, mode),
                        "plain_vs_cpu": share(plain, cpu, mode),
                        "k3_vs_plain": share(card[mode], plain, mode)}
    return shares


def main(argv=None) -> list:
    from resdepth_tpu_torch import predict
    from resdepth_tpu_torch.infer.tiled import predict_linear_blend, serving_model
    from resdepth_tpu_torch.models.unet import UNetConfig, flagship_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=20)
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--cols", type=int, default=768)
    ap.add_argument("--seeds", type=int, nargs="+", default=[3, 4, 5])
    ap.add_argument("--tile", type=int, default=256)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--start-kernel", type=int, default=64)
    ap.add_argument("--bench-batch", type=int, default=128)
    ap.add_argument("--train-precision", default="high",
                    choices=("high", "default", "highest", "balanced", "balanced16"),
                    help="tpu.train_precision of the training steps")
    ap.add_argument("--out", default=None, help="write the table as JSON here")
    args = ap.parse_args(argv)
    if args.rows <= args.tile or args.cols <= args.tile:
        ap.error("--rows and --cols must exceed the tile size")
    device = predict.resolve_device(args.device)
    config = flagship_config("geom-stereo")
    if (args.depth, args.start_kernel) != (config.depth, config.start_kernel):
        config = UNetConfig(n_input_channels=config.n_input_channels,
                            depth=args.depth, start_kernel=args.start_kernel,
                            max_filter_depth=max(args.start_kernel, 8 * args.start_kernel))
    name = device_name(device)
    print(f"[study] device {name}; {args.steps} training steps at train_precision "
          f"{args.train_precision}, batch {args.batch}, {args.rows}x{args.cols} "
          f"scenes, seeds {args.seeds}", flush=True)

    dev = {mode: {"mean_cm": [], "p99_cm": [], "max_cm": [], "card_vs_cpu_share": [],
                  "card_plain_vs_cpu_share": [], "k3_vs_card_plain_share": []}
           for mode in MODES[1:]}
    rates, seeds = {}, []
    for seed in args.seeds:
        with tempfile.TemporaryDirectory(prefix="precision_study_") as work:
            gt, train_ds, test_ds = _scene(work, args.rows, args.cols, seed, args.tile)
            start = time.perf_counter()
            model, first, last = _train(config, train_ds, device, args.steps,
                                        args.batch, seed, args.train_precision)
            train_s = time.perf_counter() - start
            outputs = {}
            for mode in MODES:
                dtype = predict.select_compute_dtype(mode, device)
                served = serving_model(model, device, dtype)
                outputs[mode] = predict_linear_blend(served, test_ds, device=device,
                                                     batch_size=128, compute_dtype=dtype,
                                                     fold_bn=False)
                if not rates.get(mode):
                    rates[mode] = tiles_per_s(served, mode, device, args.bench_batch,
                                              args.tile, config.n_input_channels)
            shares = (_card_vs_cpu_shares(model, test_ds, device)
                      if device.type == "cuda" else {})
        valid = gt != -9999.0
        for mode in MODES[1:]:
            d = np.abs(outputs[mode] - outputs["float32"])[valid] * 100.0
            dev[mode]["mean_cm"].append(float(d.mean()))
            dev[mode]["p99_cm"].append(float(np.percentile(d, 99)))
            dev[mode]["max_cm"].append(float(d.max()))
            mode_shares = shares.get(mode, {})
            for key, pair in (("card_vs_cpu_share", "card_vs_cpu"),
                              ("card_plain_vs_cpu_share", "plain_vs_cpu"),
                              ("k3_vs_card_plain_share", "k3_vs_plain")):
                dev[mode][key].append(mode_shares.get(pair))
        seeds.append({"seed": seed, "train_mae_first_m": first, "train_mae_last_m": last,
                      "train_s": train_s,
                      "input_mae_m": float(np.abs(test_ds.dsm_input - gt)[valid].mean()),
                      "refined_mae_f32_m": float(np.abs(outputs["float32"] - gt)[valid].mean())})
        print(f"[study] seed {seed}: train MAE {first:.3f} -> {last:.3f} m in "
              f"{train_s:.0f} s; refined f32 MAE {seeds[-1]['refined_mae_f32_m']:.4f} m "
              f"(input {seeds[-1]['input_mae_m']:.4f} m)", flush=True)

    rows = [{"mode": mode, **dev[mode], "tiles_per_s": rates[mode]} for mode in MODES[1:]]
    print(f"\n{'mode':11s} {'mean dev cm (per seed)':>32s} {'p99 cm':>24s} "
          f"{'tiles/s':>9s}  {'card vs CPU share':>24s}  {'K3 vs plain on the card':>24s}"
          f"  ({name}, batch {args.bench_batch})")
    for r in rows:
        shares = "  ".join(" ".join("-" if v is None else f"{v:.4f}" for v in r[key])
                           for key in ("card_vs_cpu_share", "k3_vs_card_plain_share"))
        print(f"{r['mode']:11s} {' '.join(f'{v:10.4f}' for v in r['mean_cm']):>32s} "
              f"{' '.join(f'{v:7.3f}' for v in r['p99_cm']):>24s} {r['tiles_per_s']:9.1f}"
              f"  {shares}")
    print(f"{'float32':11s} {'(reference)':>32s} {'':>24s} {rates['float32']:9.1f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": name, "args": vars(args), "seeds": seeds, "rows": rows,
                       "float32_tiles_per_s": rates["float32"]}, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
