"""The predict CLI on whole scenes, one after another:
``resdepth_tpu_torch.predict.main([config, "--device", "cuda"])`` in this
process, as a user runs ``python -m resdepth_tpu_torch.predict``. Each
scene reads its GeoTIFFs, loads the model, refines the scene on the card,
runs ``evaluate_performance`` against the ground truth and the building
and water masks, and writes the refined DSM and the residuals.

Traffic keys: ``scene`` (pixels a side), ``general`` (the inference
config's ``general`` section; no ``compute_dtype`` is float32, the CLI's
default), ``warmup_scenes`` and ``profile_scenes`` (the traced part of a
``--trace 1`` window, from its first scene). The configuration gives the
model; the scene's rasters and the model's artifacts are written under
``TMPDIR`` in set-up.

The scene that runs when the window ends completes and counts. After the
window, one scene drawn from the seed among those it finished and the
last one are judged against the plain reference on the arrays the
benchmark made: their refined-DSM and residual GeoTIFFs, read back here,
against ``reference/scene.py``, and the statistics that
``evaluate_performance`` reported, as the statistics file prints them and
as they were handed to its report, against ``reference/statistics.py``.
The control (``readings.py --control``) puts the reference at TF32 in the
CLI's place."""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.drivers._shared import n_input_channels
from benchmark.inputs import city, geotiff, weights
from benchmark.reference import statistics as ref_stats
from benchmark.reference.scene import refine_scene

GEOTRANSFORM = (465000.0, city.GSD, 0.0, 5247000.0, 0.0, -city.GSD)
REPORT = "initial_DSM_prediction_statistics.txt"


def write_inputs(work: str, scene: dict, model: dict, state: dict, dsm_std: float,
                 ortho_mean: float, ortho_std: float, general: dict) -> str:
    """The scene's GeoTIFFs, the model's artifacts (a reference-layout
    ``.pth``, ``model_config.json``, the normalisation pickles) and the
    inference config under ``work``; returns the config's path."""
    def tif(name, array, nodata):
        path = os.path.join(work, name)
        geotiff.write(path, array, GEOTRANSFORM, nodata)
        return path

    dataset = {"name": "city", "allocation_strategy": "entire",
               "raster_gt": tif("ground_truth_DSM.tif", scene["gt"], city.NODATA),
               "raster_in": tif("initial_DSM.tif", scene["dsm"], city.NODATA),
               "mask_building": tif("mask_building.tif", scene["building"], 255),
               "mask_water": tif("mask_water.tif", scene["water"], 255)}
    stereo = scene.get("orthos") is not None
    if stereo:
        images = [tif(f"ortho_{i}.tif", o, city.NODATA) for i, o in enumerate(scene["orthos"])]
        dataset["path_image_list"] = os.path.join(work, "imagelist.txt")
        with open(dataset["path_image_list"], "w") as f:
            f.write("\n".join(images) + "\n")
        dataset["path_pairlist"] = os.path.join(work, "pairlist.txt")
        with open(dataset["path_pairlist"], "w") as f:
            f.write("ortho_0, ortho_1\n")
    artifacts = {"weights": os.path.join(work, "Model_best.pth"),
                 "architecture": os.path.join(work, "model_config.json"),
                 "normalization_geom": os.path.join(work, "DSM_normalization_parameters.p")}
    torch.save({"epoch": 0, "model_state_dict": {k: v.cpu() for k, v in state.items()}},
               artifacts["weights"])
    settings = {k: v for k, v in model.items() if k != "input_channels"}
    settings["n_input_channels"] = n_input_channels(model)
    with open(artifacts["architecture"], "w") as f:
        json.dump({"name": "ResDepth", "input_channels": model["input_channels"],
                   "settings": settings}, f)
    with open(artifacts["normalization_geom"], "wb") as f:
        pickle.dump({"mean": None, "std": dsm_std}, f)
    if stereo:
        artifacts["normalization_image"] = os.path.join(work, "Image_normalization_parameters.p")
        with open(artifacts["normalization_image"], "wb") as f:
            pickle.dump({"mean": ortho_mean, "std": ortho_std}, f)
    config = os.path.join(work, "config.json")
    with open(config, "w") as f:
        json.dump({"datasets": [dataset], "model": artifacts, "general": general,
                   "output": {"directory": os.path.join(work, "out")}}, f, indent=2)
    return config


def outputs(work: str, stereo: bool) -> str:
    return os.path.join(work, "out", "city", "Stereopair_0_1" if stereo else "")


def reported(stats, *args, **kwargs) -> dict:
    """The statistics handed to the report, at full precision."""
    return {name: float(stats[name]) for name in ref_stats.STATISTICS}


def run(ctx: harness.Context) -> dict:
    from resdepth_tpu_torch import predict
    from resdepth_tpu_torch.evaluation import performance
    from resdepth_tpu_torch.geo import raster as raster_mod

    phases = harness.Phases(ctx.started)
    phases.mark("imports")
    traffic, model, assumed = ctx.traffic, ctx.config["model"], ctx.config["assumed"]
    device, size = ctx.device, traffic["scene"]
    general = ctx.config["general"]
    stereo = n_input_channels(model) == 3

    scene = city.synth_city(size, size, ctx.seed, device)
    orthos = scene["orthos"] if stereo else None
    ortho_mean = float(orthos.mean()) if stereo else 0.0
    ortho_std = float(orthos.std()) if stereo else 1.0
    host = {"gt": scene["gt"].cpu().numpy(), "dsm": scene["dsm"].cpu().numpy(),
            "building": scene["building"].cpu().numpy().astype(np.uint8),
            "water": scene["water"].cpu().numpy().astype(np.uint8),
            "orthos": orthos.cpu().numpy() if stereo else None}
    state = weights.make_state(model, n_input_channels(model), ctx.seed, device,
                               assumed["weight_gain"])
    phases.mark("city")
    work = tempfile.mkdtemp(prefix="benchmark_cli_")
    config = write_inputs(work, host, model, state, assumed["dsm_std"], ortho_mean,
                          ortho_std, {**traffic["general"], "tile_size": general["tile_size"],
                                      "tile_stride": general["tile_stride"]})
    phases.mark("files")
    produced = outputs(work, stereo)
    argv = [config, "--device", "cuda" if device.type == "cuda" else "cpu"]

    def cli_scene():
        predict.main(argv)

    record = {"cli": True}
    scenes, seconds, judged_stats = 0, {}, {}
    if not ctx.control:
        for _ in range(traffic["warmup_scenes"]):
            cli_scene()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        phases.mark("warm_up")
        record.update(setup_s=time.perf_counter() - ctx.started, setup_phases=phases.seconds)

        # One scene drawn from the seed (reservoir sampling) keeps its
        # outputs, moved aside; the last scene's stay where the CLI wrote
        # them, unless it is the one drawn.
        rng = np.random.default_rng(ctx.seed)
        kept = os.path.join(work, "kept")
        start = time.perf_counter()
        if ctx.trace:
            profile = harness.Profile(device)
            spans = [(raster_mod, "open_raster"), (raster_mod, "write_raster"),
                     (predict, "TileDataset"), (predict, "predict_linear_blend"),
                     (predict, "evaluate_performance")]
            with harness.annotated(spans):
                profile.start()
                for _ in range(traffic["profile_scenes"]):
                    cli_scene()
                    scenes += 1
                profile.stop()
        profiled = scenes
        targets = [(predict, "evaluate_performance"), (raster_mod, "write_raster")]
        report = [(performance, "print_statistics")]
        with harness.host_timed(targets, seconds), \
                harness.recording(report, reported) as stats:
            while time.perf_counter() - start < ctx.seconds or scenes == profiled:
                # The CLI appends to a statistics file that is there: each
                # scene's report starts a file of its own.
                with contextlib.suppress(FileNotFoundError):
                    os.remove(os.path.join(produced, REPORT))
                first = len(stats)
                cli_scene()
                scenes += 1
                judged_stats[produced] = stats[first:]
                if rng.integers(scenes - profiled) == 0:
                    shutil.rmtree(kept, ignore_errors=True)
                    os.replace(produced, kept)
                    judged_stats[kept] = judged_stats.pop(produced)
        end = time.perf_counter()
        record.update(scenes=scenes, window_wall_s=end - start,
                      timed_scenes=scenes - profiled, host_seconds=seconds,
                      memory_peak_bytes=(torch.cuda.max_memory_allocated(device)
                                         if device.type == "cuda" else 0))
        if ctx.trace:
            record["trace"] = profile.summary()

    kwargs = dict(tile=general["tile_size"], stride=general["tile_stride"],
                  dsm_std=assumed["dsm_std"], ortho_mean=ortho_mean, ortho_std=ortho_std,
                  nodata=city.NODATA)
    reference = refine_scene(state, model["depth"], scene["dsm"], orthos,
                             **kwargs).cpu().numpy()
    classes = ref_stats.class_masks(host["building"], host["water"], 255)
    want = {"before": ref_stats.statistics(host["dsm"], host["gt"], city.NODATA, classes),
            "after": ref_stats.statistics(reference, host["gt"], city.NODATA, classes)}
    if ctx.control:
        control = refine_scene(state, model["depth"], scene["dsm"], orthos, tf32=True,
                               **kwargs).cpu().numpy()
        by_control = {"before": want["before"],
                      "after": ref_stats.statistics(control, host["gt"], city.NODATA,
                                                    classes)}
        report = [(c, p, by_control[p][c]) for c in ref_stats.CLASSES for p in by_control]
        judged = [(control, control.astype(np.float64) - host["gt"],
                   ref_stats.widest_gap(report, want, [v for _, _, v in report]))]
    else:
        judged = [(geotiff.read(os.path.join(d, "initial_DSM_prediction.tif")),
                   geotiff.read(os.path.join(d, "initial_DSM_residuals.tif")),
                   ref_stats.widest_gap(ref_stats.read_report(os.path.join(d, REPORT)),
                                        want, judged_stats[d]))
                  for d in (kept, produced) if os.path.isdir(d)]
    shutil.rmtree(work, ignore_errors=True)
    residual = reference.astype(np.float64) - host["gt"]
    numbers = {}
    for prediction, residuals, stats_gap in judged:
        gap = np.abs(prediction.astype(np.float64) - reference)
        res_gap = np.abs(residuals.astype(np.float64) - residual)
        for key, value in (("mean_dev_m", gap.mean()), ("max_dev_m", gap.max()),
                           ("residual_max_dev_m", res_gap.max()),
                           ("stats_max_dev_m", stats_gap)):
            value = float(value) if np.isfinite(value) else 1e30
            numbers[key] = max(numbers.get(key, 0.0), value)
    record.update(checks=harness.compare(numbers, ctx.limits), attempted=scenes, failed=0)
    return record
