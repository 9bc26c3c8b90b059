"""Resident serving: whole scenes refined back to back, one caller, a
closed loop, through the port's ``infer/tiled.py::predict_linear_blend``
with the rasters and the served model on the card from set-up (as the
CLI keeps them across image pairs) and each scene's refined DSM fetched
into host memory, as the CLI fetches it.

Traffic keys: ``scene`` (pixels a side), ``batch``, ``mode`` (a serving
mode or ``float32``/``bfloat16``), ``use_pallas`` (the stitch: null K1,
"fused" K2), ``tta``, ``warmup_scenes``, ``profile_scenes`` (the traced
part of a ``--trace 1`` window) and ``control`` (the mode of the control
path, ``readings.py`` only). Tile and stride are the configuration's.

After the window, one scene drawn from the seed among those it finished
and the last one are compared with the plain reference
(``reference/scene.py``), run once on the same inputs and weights."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness
from benchmark.drivers._shared import k3_entry, memory_dataset, n_input_channels
from benchmark.inputs import city, weights
from benchmark.reference.scene import refine_scene


def _stitch_entry(scene, tiles, positions, *args, **kwargs):
    return (tiles.shape[0], tiles.shape[1], positions, tuple(scene.shape))


def covered_pixels(positions: np.ndarray, tile: int, shape) -> int:
    covered = np.zeros(shape, bool)
    for y, x in positions:
        covered[y:y + tile, x:x + tile] = True
    return int(covered.sum())


def run(ctx: harness.Context) -> dict:
    from resdepth_tpu_torch.data.pipeline import DeviceRasters
    from resdepth_tpu_torch.infer import tiled
    from resdepth_tpu_torch.infer.tiled import predict_linear_blend, serving_model
    from resdepth_tpu_torch.models import unet
    from resdepth_tpu_torch.ops import blend, conv, stitch
    from resdepth_tpu_torch.predict import select_compute_dtype

    phases = harness.Phases(ctx.started)
    phases.mark("imports")
    traffic, model = ctx.traffic, ctx.config["model"]
    assumed, general = ctx.config["assumed"], ctx.config["general"]
    device, size = ctx.device, traffic["scene"]
    tile, stride = general["tile_size"], general["tile_stride"]
    stereo = n_input_channels(model) == 3

    scene = city.synth_city(size, size, ctx.seed, device)
    dsm, orthos = scene["dsm"], scene["orthos"] if stereo else None
    del scene
    phases.mark("city")
    ortho_mean = float(orthos.mean()) if stereo else 0.0
    ortho_std = float(orthos.std()) if stereo else 1.0
    ds = memory_dataset(dsm.cpu().numpy(), None,
                        orthos.permute(1, 2, 0).cpu().numpy() if stereo else None,
                        tile_size=tile, sampling_strategy="test", stride=stride,
                        dsm_std=assumed["dsm_std"], ortho_mean=ortho_mean,
                        ortho_std=ortho_std)
    rasters = DeviceRasters(dsm_input=dsm, dsm_target=None, orthos=orthos,
                            pairs=torch.as_tensor(ds.pairs_array, dtype=torch.int64,
                                                  device=device),
                            nodata=float(city.NODATA))
    phases.mark("dataset")
    state = weights.make_state(model, n_input_channels(model), ctx.seed, device,
                               assumed["weight_gain"])
    base = unet.UNet(unet.unet_config_from_settings(
        {**model, "n_input_channels": n_input_channels(model)}), device)
    base.load_state_dict(state)
    mode = traffic["control"] if ctx.control else traffic["mode"]
    dtype = select_compute_dtype(mode, device)
    served = serving_model(base, device, dtype)
    del base
    phases.mark("model")

    def scene_run() -> np.ndarray:
        return predict_linear_blend(served, ds, device=device, batch_size=traffic["batch"],
                                    compute_dtype=dtype, rasters=rasters,
                                    use_pallas=traffic["use_pallas"], fold_bn=False,
                                    tta=traffic["tta"])

    for _ in range(traffic["warmup_scenes"]):
        scene_run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    phases.mark("warm_up")
    record = {"setup_s": time.perf_counter() - ctx.started, "setup_phases": phases.seconds,
              "scene_tiles": len(ds.positions), "tile": tile,
              "input_channels": n_input_channels(model), "model": model}

    # Reservoir sampling keeps one finished scene drawn uniformly from the
    # seed, whatever their count; the last is kept too.
    rng = np.random.default_rng(ctx.seed)
    kept, last, scenes = None, None, 0

    def finish(out):
        nonlocal kept, last, scenes
        scenes += 1
        if rng.integers(scenes) == 0:
            kept = out
        last = out

    start = time.perf_counter()
    if ctx.trace:
        targets = [(conv, "conv3x3_bias_act"), (unet, "conv3x3_bias_act")]
        profile = harness.Profile(device)
        spans = [(tiled, "_predict_tiles"), (blend, "weight_table"), (tiled, "build_batch"),
                 (tiled, "apply_unet")]
        with harness.recording(targets, k3_entry) as k3_calls, \
                harness.recording([(stitch, "stitch_tiles")], _stitch_entry) as stitches, \
                harness.annotated(spans):
            profile.start()
            for _ in range(traffic["profile_scenes"]):
                finish(scene_run())
            profile.stop()
    unprofiled_start, unprofiled_from = time.perf_counter(), scenes
    while time.perf_counter() - start < ctx.seconds or scenes == unprofiled_from:
        finish(scene_run())
    end = time.perf_counter()
    record.update(scenes=scenes, window_wall_s=end - start,
                  unprofiled_scenes=scenes - unprofiled_from,
                  unprofiled_wall_s=end - unprofiled_start,
                  memory_peak_bytes=(torch.cuda.max_memory_allocated(device)
                                     if device.type == "cuda" else 0))
    if ctx.trace:
        record.update(trace=profile.summary(), k3_calls=k3_calls,
                      stitch_calls=[(n, t, covered_pixels(p.cpu().numpy(), t, shape))
                                    for n, t, p, shape in stitches])

    del served, rasters
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reference = refine_scene(state, model["depth"], dsm, orthos, tile=tile, stride=stride,
                             dsm_std=assumed["dsm_std"], ortho_mean=ortho_mean,
                             ortho_std=ortho_std, nodata=city.NODATA).cpu().numpy()
    numbers = {}
    for out in (kept, last):
        gap = np.abs(out.astype(np.float64) - reference)
        for name, value in (("mean_dev_m", float(gap.mean())),
                            ("max_dev_m", float(gap.max()))):
            numbers[name] = max(numbers.get(name, 0.0), value)
        if not np.isfinite(out).all():     # a JSON number all the same
            numbers["mean_dev_m"] = numbers["max_dev_m"] = 1e30
    record["checks"] = harness.compare(numbers, ctx.limits)
    record["attempted"] = scenes
    record["failed"] = 0
    return record
