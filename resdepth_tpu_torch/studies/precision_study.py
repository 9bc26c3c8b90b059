"""Serving-precision deviation study on trained weights (the port's copy of
``scripts/precision_study.py``).

    python -m resdepth_tpu_torch.studies.precision_study [--device cuda]
        [--steps 400] [--batch 20] [--rows 512] [--cols 768] [--seeds 3 4 5]
        [--train-precision high] [--out study.json]
        [--state-cache PATH.npz] [--attrib]

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

``--state-cache PATH`` (one seed) reads the trained weights from PATH, or
trains and writes them there: a ``.npz`` in the JAX checkpoint layout whose
metadata holds the ``study_key`` (the JAX study's scene seed, steps, rows,
cols and batch, and ``train_precision``). A cache of another key is
refused; one the JAX study wrote has no ``train_precision`` and loads at
``--train-precision default``, the precision it trains at. The stride, TTA
and TTA x stride studies serve this file.

``--attrib`` prints the per-layer attribution in place of the mode table
(``run_attribution``): every test tile of the scene through the folded
model with each conv at ``Precision.HIGH`` (K3 at 3 passes on the card),
then with one layer at a time demoted to ``DEFAULT`` (one pass), and each
layer's mean |deviation| in cm, ranked. On the CPU, from the smoke model's
cache:

    python -m resdepth_tpu_torch.studies.precision_study --device cpu
        --steps 2 --batch 2 --rows 64 --cols 96 --tile 32 --depth 2
        --start-kernel 4 --seeds 3 --state-cache s3.npz --attrib
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
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


def make_city(work: str, rows: int, cols: int, scene_seed: int) -> dict:
    """The seeded city (``utils/synth.py``) and its three hillshade views as
    GeoTIFFs in ``work``: the ground truth and input DSM arrays, a dataset
    entry over the whole scene with the pair (0, 1), and the normalisation
    the JAX studies take from it (sigma of the input, the views' mean and
    std)."""
    from resdepth_tpu_torch.geo import tiff
    from resdepth_tpu_torch.geo.allocation import entire_area_defn
    from resdepth_tpu_torch.utils.synth import hillshade, synth_city

    gt, dsm_in, _, _ = synth_city(rows, cols, seed=scene_seed)
    views = np.stack([hillshade(gt, az) for az in (315.0, 135.0, 45.0)], -1)
    geotransform = (1000.0, 0.25, 0.0, 2000.0, 0.0, -0.25)

    def write(name, data):
        path = os.path.join(work, name)
        tiff.write(path, data, geotransform=geotransform, nodata=-9999.0)
        return path

    p_in = write("dsm.tif", dsm_in)
    entry = {"name": "study", "raster_in": p_in, "raster_gt": write("gt.tif", gt),
             "image_list": [write(f"ortho_{j}.tif", views[..., j]) for j in range(3)],
             "image_pairs": [(0, 1)], "area_defn": entire_area_defn(p_in)}
    return {"gt": gt, "dsm_in": dsm_in, "entry": entry,
            "norm": dict(dsm_std=float(np.std(dsm_in - dsm_in.mean())),
                         ortho_mean=float(views.mean()), ortho_std=float(views.std()))}


def _scene(work: str, rows: int, cols: int, seed: int, tile: int):
    """The seeded city (``make_city``); its 'train' TileDataset over the
    pairs (0, 1) and (1, 2) and its 'test' one over (0, 1)."""
    from resdepth_tpu_torch.data.dataset import TileDataset

    city = make_city(work, rows, cols, seed)
    # the study draws its own training positions: one sample suffices
    train = dict(city["entry"], image_pairs=[(0, 1), (1, 2)], n_samples=1)
    train_ds = TileDataset(train, "geom-stereo", tile, "train", use_all_stereo_pairs=True,
                           augment=True, seed=0, **city["norm"])
    test_ds = TileDataset(city["entry"], "geom-stereo", tile, "test", seed=0,
                          **city["norm"])
    return city["gt"], train_ds, test_ds


def _train(config, train_ds, device, steps: int, batch: int, seed: int,
           train_precision: str = "high"):
    """``steps`` Adam steps (lr 2e-4, weight decay 1e-5) at
    ``train_precision`` (float32 compute) on random tiles; returns the model
    and the first and last batch MAE (m)."""
    from resdepth_tpu_torch.data.pipeline import (GeneratorDraws, batch_spec_for,
                                                  device_put_dataset)
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
    draws = GeneratorDraws(torch.Generator(device=device).manual_seed(seed))
    rng = np.random.default_rng(seed)
    rows, cols = train_ds.dsm_input.shape
    tile = train_ds.tile_size
    maes = []
    for _ in range(steps):
        pos = np.stack([rng.integers(0, rows - tile, batch),
                        rng.integers(0, cols - tile, batch)], -1).astype(np.int32)
        pair = rng.integers(0, 2, batch).astype(np.int32)
        maes.append(step(state, rasters, pos, pair, np.zeros((batch, 4), np.int32),
                         np.ones(batch, np.float32), draws))
    model.eval()
    return model, float(maes[0]), float(maes[-1])


def study_config(depth: int = 5, start_kernel: int = 64):
    """The flagship geom-stereo config, or a narrower one of ``depth`` and
    ``start_kernel`` (cap 8x the start) for small runs."""
    from resdepth_tpu_torch.models.unet import UNetConfig, flagship_config

    config = flagship_config("geom-stereo")
    if (depth, start_kernel) == (config.depth, config.start_kernel):
        return config
    return UNetConfig(n_input_channels=config.n_input_channels, depth=depth,
                      start_kernel=start_kernel,
                      max_filter_depth=max(start_kernel, 8 * start_kernel))


def study_key(scene_seed: int, steps: int, rows: int, cols: int, batch: int,
              train_precision: str) -> dict:
    """The cache's ``study_key``: the JAX study's five fields and the
    port's ``train_precision``."""
    return {"scene_seed": scene_seed, "steps": steps, "rows": rows, "cols": cols,
            "batch": batch, "train_precision": train_precision}


def key_matches(cached, key: dict) -> bool:
    """Whether a cache's ``study_key`` is ``key``. The JAX study's key has
    no ``train_precision``; it trains at 'default', so it matches there."""
    if cached == key:
        return True
    return (isinstance(cached, dict) and "train_precision" not in cached
            and key["train_precision"] == "default"
            and cached == {k: v for k, v in key.items() if k != "train_precision"})


def load_state_cache(path: str, config, device, key: dict | None = None):
    """``(model, meta)`` from a state cache in the JAX checkpoint layout,
    in eval mode on ``device``. With ``key`` a cache of another
    ``study_key`` exits with the JAX study's message."""
    from resdepth_tpu_torch.models.unet import init_unet
    from resdepth_tpu_torch.models.weights import state_dict_from_jax_params
    from resdepth_tpu_torch.train import checkpoint as ckpt_io

    meta = ckpt_io.load_meta(path)
    cached = meta.get("study_key")
    if key is not None and not key_matches(cached, key):
        sys.exit(f"ERROR: --state-cache {path} was trained with {cached}, not {key} "
                 "— refusing to mix scenes/protocols; delete the file or use "
                 "another path.")
    loaded = ckpt_io.load_checkpoint(path)
    model = init_unet(config, torch.Generator().manual_seed(0), device)
    model.load_state_dict(state_dict_from_jax_params(loaded["params"],
                                                     loaded["bn_state"], config))
    return model.eval(), meta


def save_state_cache(path: str, model, key: dict) -> None:
    """``model``'s weights as a state cache with ``key`` as its ``study_key``."""
    from resdepth_tpu_torch.models.weights import jax_params_from_state_dict
    from resdepth_tpu_torch.train import checkpoint as ckpt_io

    params, bn_state = jax_params_from_state_dict(model.state_dict(), model.config)
    ckpt_io.save_checkpoint(path, epoch=0, params=params, bn_state=bn_state,
                            extra={"study_key": key})


def attribution_layers(depth: int) -> list:
    """The JAX names of the served model's conv layers, in the order the
    JAX attribution reports them."""
    return ([f"encoder{i}" for i in range(depth)] + ["bottleneck"]
            + [f"up{i}" for i in range(depth - 1)]
            + [f"decoder{i}" for i in range(depth - 1)] + ["last"])


def run_attribution(model, test_ds, sigma: float, device, batch: int = 128) -> dict:
    """Per-layer solo demotion over every test tile of the scene (the JAX
    study's ``_run_attribution``): the folded model with every conv at
    ``Precision.HIGH`` (3 bf16 passes: K3 on the card) is the reference;
    then all at ``DEFAULT`` (1 pass), then each layer alone at ``DEFAULT``.
    Returns and prints the mean |deviation| from the reference in cm
    (denormalised by ``sigma``), by layer and ranked, and the reference
    output (``y_ref``, normalised)."""
    from resdepth_tpu_torch.data.pipeline import build_batch, device_put_dataset
    from resdepth_tpu_torch.infer.tiled import _inference_spec, serving_model
    from resdepth_tpu_torch.models.unet import Precision, apply_unet

    served = serving_model(model, device, torch.float32)
    x = build_batch(device_put_dataset(test_ds, device),
                    torch.from_numpy(test_ds.positions.astype(np.int32)).to(device),
                    torch.from_numpy(test_ds.pair_indices.astype(np.int64)).to(device),
                    _inference_spec(test_ds))["input"]
    n = x.shape[0]
    H, D = Precision.HIGH, Precision.DEFAULT

    def run(base, overrides):
        with torch.inference_mode():
            return torch.cat([apply_unet(served, x[i:i + batch], precision=base,
                                         layer_precisions=dict(overrides))
                              for i in range(0, n, batch)]).cpu().numpy()

    y_ref = run(H, {})

    def dev_cm(y) -> float:
        return float(np.abs(y - y_ref).mean() * sigma * 100)

    print(f"\n[attrib] {n} tiles, sigma={sigma:.2f} m; reference = all-HIGH")
    all_default = dev_cm(run(D, {}))
    print(f"all-DEFAULT          : {all_default:.3f} cm")
    solo = {}
    for name in attribution_layers(served.config.depth):
        solo[name] = dev_cm(run(H, {name: D}))
        print(f"solo-DEFAULT {name:10s}: {solo[name]:.3f} cm", flush=True)
    ranked = sorted(solo.items(), key=lambda kv: -kv[1])
    print("\nranked contributions (cm):")
    for name, d in ranked:
        print(f"  {name:10s} {d:.3f}")
    return {"tiles": n, "sigma": sigma, "all_default_cm": all_default,
            "solo_cm": solo, "ranked": [name for name, _ in ranked], "y_ref": y_ref}


def tiles_per_s(served, mode, device, batch: int, tile: int, n_in: int,
                iters: int = 3) -> float:
    """Forward throughput of the served model at ``batch`` random tiles
    (numpy seed 0): the best of 3 windows of ``iters`` forwards each, after
    a warm-up window, each between CUDA events on the card (on the host
    clock on the CPU); a non-finite output raises."""
    from resdepth_tpu_torch.infer.tiled import _storage
    from resdepth_tpu_torch.models.unet import apply_unet

    dtype, kwargs = _storage({"float32": torch.float32,
                              "bfloat16": torch.bfloat16}.get(mode, mode))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(batch, tile, tile, n_in)).astype(np.float32)).to(device, dtype)

    def window() -> float:
        with torch.inference_mode():
            if device.type != "cuda":
                start = time.perf_counter()
                for _ in range(iters):
                    y = apply_unet(served, x, **kwargs)
                seconds = time.perf_counter() - start
            else:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    y = apply_unet(served, x, **kwargs)
                end.record()
                end.synchronize()
                seconds = start.elapsed_time(end) / 1e3
        if not torch.isfinite(y).all():
            raise RuntimeError(f"non-finite forward output at {mode}")
        return seconds

    window()
    return iters * batch / min(window() for _ in range(3))


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


def main(argv=None):
    from resdepth_tpu_torch import predict
    from resdepth_tpu_torch.infer.tiled import predict_linear_blend, serving_model

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
    ap.add_argument("--state-cache", default=None,
                    help="checkpoint path: reuse trained weights if present, else "
                         "train and save (one seed)")
    ap.add_argument("--attrib", action="store_true",
                    help="per-layer precision attribution instead of the mode table")
    args = ap.parse_args(argv)
    if args.rows <= args.tile or args.cols <= args.tile:
        ap.error("--rows and --cols must exceed the tile size")
    if args.state_cache and len(args.seeds) != 1:
        ap.error("--state-cache holds one scene seed's weights: pass one --seeds")
    device = predict.resolve_device(args.device)
    config = study_config(args.depth, args.start_kernel)
    name = device_name(device)
    print(f"[study] device {name}; {args.steps} training steps at train_precision "
          f"{args.train_precision}, batch {args.batch}, {args.rows}x{args.cols} "
          f"scenes, seeds {args.seeds}", flush=True)

    dev = {mode: {"mean_cm": [], "p99_cm": [], "max_cm": [], "card_vs_cpu_share": [],
                  "card_plain_vs_cpu_share": [], "k3_vs_card_plain_share": []}
           for mode in MODES[1:]}
    rates, seeds, attributions = {}, [], {}
    for seed in args.seeds:
        with tempfile.TemporaryDirectory(prefix="precision_study_") as work:
            gt, train_ds, test_ds = _scene(work, args.rows, args.cols, seed, args.tile)
            key = study_key(seed, args.steps, args.rows, args.cols, args.batch,
                            args.train_precision)
            start = time.perf_counter()
            if args.state_cache and os.path.exists(args.state_cache):
                model, _ = load_state_cache(args.state_cache, config, device, key)
                first = last = None
                print(f"[train] loaded cached trained state: {args.state_cache}",
                      flush=True)
            else:
                model, first, last = _train(config, train_ds, device, args.steps,
                                            args.batch, seed, args.train_precision)
                if args.state_cache:
                    save_state_cache(args.state_cache, model, key)
                    print(f"[train] cached trained state: {args.state_cache}",
                          flush=True)
            train_s = time.perf_counter() - start
            if args.attrib:
                attributions[seed] = run_attribution(model, test_ds, train_ds.dsm_std,
                                                     device)
                continue
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
        trained = ("loaded from the cache" if first is None
                   else f"train MAE {first:.3f} -> {last:.3f} m")
        print(f"[study] seed {seed}: {trained} in "
              f"{train_s:.0f} s; refined f32 MAE {seeds[-1]['refined_mae_f32_m']:.4f} m "
              f"(input {seeds[-1]['input_mae_m']:.4f} m)", flush=True)

    if args.attrib:
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"device": name, "args": vars(args),
                           "attribution": {str(seed): {k: v for k, v in a.items()
                                                       if k != "y_ref"}
                                           for seed, a in attributions.items()}},
                          f, indent=2)
        return attributions
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
