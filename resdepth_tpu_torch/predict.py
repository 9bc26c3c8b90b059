"""Refine full DSM scenes and evaluate them: the port of ``test.py``.

    python -m resdepth_tpu_torch.predict config.json [--device {cuda,cpu}]

Reads the same inference JSON config as ``test.py`` (validated by
``config/validate_infer.py``, the port's copy of the JAX validator) and
writes the same artifacts: per dataset and image pair the refined-DSM and
residual GeoTIFFs and a statistics report, plus statistics pooled over the
pairs. Weights come from a reference ``.pth`` file or a JAX ``.npz``
checkpoint.

The scene runs on ``--device`` (default ``cuda``, which raises when CUDA
is absent; there is no silent move to the CPU) at
``general.compute_dtype``: ``float32``, ``bfloat16`` or a string serving
mode (``mixed``, ``fast32``, ``act2pass``, ``balanced``, ``balanced16``;
``models.unet.serving_precision``). A scene whose rasters (the DSM and the
ortho views) exceed ``MAX_DEVICE_PIXELS`` streams through full-width row
bands, one band window on the device at a time
(``infer.tiled.predict_linear_blend_streaming``).

Several GPUs run one process each over ``torch.distributed``
(``parallel/``): a plain launch with ``general.data_parallel`` (the
default) on a machine with N > 1 visible GPUs starts N processes;
``RESDEPTH_DIST_*`` or ``torchrun`` with ``RESDEPTH_DISTRIBUTED=1`` launch
them from outside. With ``general.data_parallel`` each rank refines its
share of every batch of tiles and the canvases are summed
(``predict_linear_blend(group=...)``); an over-budget scene gives each rank
whole row bands in turn (``predict_linear_blend_scene_sharded``). Only rank
0 writes the log, evaluates and writes rasters.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from resdepth_tpu_torch import orchestration
from resdepth_tpu_torch.config import io as cfg_io
from resdepth_tpu_torch.config import validate_infer
from resdepth_tpu_torch.data import control_files
from resdepth_tpu_torch.data.dataset import TileDataset
from resdepth_tpu_torch.data.pipeline import device_put_dataset
from resdepth_tpu_torch.evaluation import (CLASS_TITLES, evaluate_performance,
                                           get_statistics, print_statistics)
from resdepth_tpu_torch.geo import raster as raster_mod
from resdepth_tpu_torch.infer.tiled import (predict_linear_blend,
                                            predict_linear_blend_scene_sharded,
                                            predict_linear_blend_streaming,
                                            serving_model)
from resdepth_tpu_torch.models import weights
from resdepth_tpu_torch.models.unet import (SERVING_PRECISION_MODES, UNet,
                                            unet_config_from_settings)
from resdepth_tpu_torch.parallel import bootstrap, mesh
from resdepth_tpu_torch.utils import fs
from resdepth_tpu_torch.utils.logging import (add_console_logger, add_file_logger,
                                              setup_logger)

RESIDUAL_THRESHOLD = None

# Scenes whose rasters exceed this many device pixels (DSM + ortho views)
# stream through row bands whose windows fit it, as in test.py.
MAX_DEVICE_PIXELS = 1 << 30  # 4 GiB of f32

parser = ArgumentParser(description="ResDepth on PyTorch: refine full DSM scenes "
                                    "with a trained model and evaluate against "
                                    "ground truth.")
parser.add_argument("config_file", type=str, help="JSON configuration file")
parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device that runs the scene (default: cuda)")

# Report loggers are process-cached by name; a fresh name per report keeps
# repeated runs in one process from writing into an earlier run's files.
_report_ids = itertools.count()


def select_compute_dtype(name: str | None,
                         device: torch.device) -> torch.dtype | str:
    """``general.compute_dtype`` as ``predict_linear_blend`` takes it: a
    torch dtype, or the name of a string serving mode.

    ``float32`` (the default) is IEEE f32 end to end: on CUDA it turns
    TF32 off for cuDNN convs and matmuls, which PyTorch otherwise allows
    for convs and which keeps only a 10-bit mantissa. The serving modes
    turn it off too: their exact-f32 convs (the bias map) are IEEE."""
    if name == "bfloat16":
        return torch.bfloat16
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return name if name in SERVING_PRECISION_MODES else torch.float32


def resolve_device(name: str) -> torch.device:
    """``--device`` as a torch device: on CUDA this process's card (its
    rank's, bound by ``parallel.bootstrap``)."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available "
                           "(pass --device cpu to run on the CPU)")
    return torch.device("cuda", torch.cuda.current_device())


def _to_numpy(prediction) -> np.ndarray:
    if isinstance(prediction, torch.Tensor):
        return prediction.cpu().numpy()
    return prediction


def _close_file_handlers(logger: logging.Logger) -> None:
    for handler in list(logger.handlers):
        if isinstance(handler, logging.FileHandler):
            logger.removeHandler(handler)
            handler.close()


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    cfg_file = args.config_file

    title = "Running ResDepth (PyTorch): Prediction"
    print("\n{}\n{}\n".format(title, "=" * len(title)))

    # The process group forms before the first CUDA access. Every rank runs
    # the inference loops (the all-reduces need all of them); only the chief
    # logs to file, evaluates and writes.
    bootstrap.maybe_initialize_distributed(device=args.device)
    chief = bootstrap.is_chief()
    if not fs.file_exists(cfg_file):
        print(f"ERROR: Cannot find the configuration file: {cfg_file}")
        sys.exit(1)

    logger = setup_logger("root_logger", level=logging.INFO if chief else logging.WARNING,
                          log_to_console=True, log_file=None)
    print(f"Validate the configuration file:\t{cfg_file}\n\n")
    eval_cfg = validate_infer.validate_and_update_cfg_file(cfg_file, logger)
    if eval_cfg.status is False:
        sys.exit(1)
    cfg = eval_cfg.cfg
    n_gpus = bootstrap.plain_launch_size(args.device,
                                         cfg.general.get("data_parallel", True))
    if n_gpus > 1:
        logger.info(f"{n_gpus} GPUs: one inference process each")
        bootstrap.launch_per_gpu("resdepth_tpu_torch.predict", argv, n_gpus)
        return
    cfg_orig = cfg_io.read_json(cfg_file)
    if chief:
        add_file_logger(logger, log_file=os.path.join(cfg.output.directory, "run.log"))
    try:
        _run(cfg, cfg_orig, args, logger, chief)
    finally:
        _close_file_handlers(logger)


def _run(cfg, cfg_orig, args, logger, chief: bool = True) -> None:
    device = resolve_device(args.device)
    compute_dtype = select_compute_dtype(cfg.general.get("compute_dtype"), device)
    logger.info(f"Device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})"
                   if device.type == "cuda" else "")
                + (f", serving mode {compute_dtype!r}"
                   if isinstance(compute_dtype, str)
                   else f", compute dtype {compute_dtype}"))

    # ----------------------- data allocation & inputs ---------------------- #
    logger.info("Perform data allocation...")
    orchestration.allocate_area(cfg)

    logger.info("\nData initialization\n-------------------\n")
    if cfg.model.input_channels != "geom":
        logger.info("Read image pairs...\n")
        if orchestration.read_image_pairs(cfg, logger) is False:
            sys.exit(1)

    logger.info("Read normalization parameters...")
    params_dsm = control_files.read_normalization_params_from_file(
        cfg.model.normalization_geom)
    if cfg.model.input_channels != "geom":
        params_images = control_files.read_normalization_params_from_file(
            cfg.model.normalization_image)
    else:
        params_images = {"mean": None, "std": 1.0}

    cfg_data = orchestration.prepare_dataset_configuration(cfg, "test")

    # ------------------------------- model --------------------------------- #
    logger.info("\n\nDefine model\n------------\n")
    model_config = unet_config_from_settings(cfg.model.settings)
    logger.info(f"Load model weights: {cfg.model.weights}")
    model = UNet(model_config)
    model.load_state_dict(weights.load_state_dict(cfg.model.weights, model_config))
    # The exact serving rewrites once, reused for every pair.
    model = serving_model(model, device, compute_dtype)

    batch_size = cfg.general.get("batch_size", 128)
    # None -> TileDataset's 'test' default, tile_size/2 (reference parity).
    tile_stride = cfg.general.get("tile_stride")
    use_pallas = cfg.general.get("use_pallas")
    tta = int(cfg.general.get("tta", 1))
    tta_merge = cfg.general.get("tta_merge", "mean")
    # Serving presets (test.py): 'accuracy' = stride 3*tile/4 + TTA-4 mean,
    # 'throughput' = stride 3*tile/4, tta off; explicit tile_stride/tta keys
    # override preset members; 'parity' (default) changes nothing.
    preset = cfg.general.get("serving_preset", "parity")
    if preset in ("accuracy", "throughput"):
        if tile_stride is None:
            tile_stride = (cfg.general.tile_size * 3) // 4
        if preset == "accuracy" and "tta" not in cfg.general:
            tta = 4
        logger.info(f"serving_preset {preset!r}: tile_stride={tile_stride}, "
                    f"tta={tta}, tta_merge={tta_merge}")

    # Tile batches shard over every process of the run; each rank stitches
    # its share and one all-reduce sums the canvases (infer/tiled.py). A
    # group of one process runs the same collectives, as copies.
    world = mesh.device_count()
    group = None
    if cfg.general.get("data_parallel", True):
        group = mesh.data_mesh()
    if group is not None:
        logger.info(f"Inference mesh: {{'{mesh.DATA_AXIS}': {world}}}")

    # ------------------------------ inference ------------------------------ #
    logger.info("\n\nInference\n---------\n")

    for index, dataset in enumerate(cfg_data):
        orchestration.print_dataset_name_to_console(dataset, index, logger)

        area_suffix = f"_{cfg.datasets[index].area_type}_area" \
            if "area_type" in cfg.datasets[index] else ""
        name = dataset.get("name") or f"dataset_{index}"
        output_parent = os.path.join(cfg.output.directory, name)
        if chief:
            fs.make_dir(output_parent)
            cfg_io.write_json(cfg_orig, os.path.join(output_parent, "config.json.orig"))
            cfg_io.write_json(cfg, os.path.join(output_parent, "config.json"))

        image_pairs = dataset.get("image_pairs") or [None]
        basename = fs.filename_wo_ext(dataset.raster_in)
        raster_in = raster_mod.open_raster(dataset.raster_in)

        residual_pool: dict[str, list] = {}
        device_rasters = None  # scene rasters upload once, reused per pair

        # 1-deep pipeline over image pairs: each pair's batches are queued
        # on the device (as_numpy=False), and the PREVIOUS pair's fetch and
        # host-side evaluation/export run while they compute.
        _SENTINEL = object()
        pending = None

        for image_pair in list(image_pairs) + [_SENTINEL]:
            job = None
            if image_pair is not _SENTINEL:
                if image_pair is not None:
                    kind = {1: "Image", 2: "Stereopair"}.get(len(image_pair),
                                                             "Imagepair")
                    folder = "_".join([kind] + [str(i) for i in image_pair])
                    output_directory = os.path.join(output_parent, folder)
                    if chief:
                        fs.make_dir(output_directory)
                    logger.info(f"\nInference using image pair: {tuple(image_pair)}")
                    for image_index in image_pair:
                        logger.info(f"Image {image_index}:\t"
                                    f"{fs.filename(dataset.image_list[image_index])}")
                    ds_entry = dict(dataset)
                    ds_entry["image_pairs"] = [tuple(image_pair)]
                else:
                    logger.info("Inference without image guidance.\n")
                    output_directory = output_parent
                    ds_entry = dict(dataset)

                tile_ds = TileDataset(
                    ds_entry, input_channels=cfg.model.input_channels,
                    tile_size=cfg.general.tile_size, sampling_strategy="test",
                    stride=tile_stride,
                    dsm_mean=None, dsm_std=params_dsm["std"],
                    ortho_mean=params_images["mean"],
                    ortho_std=params_images["std"])

                logger.info("Predict...")
                n_views = 0 if tile_ds.orthos is None else tile_ds.orthos.shape[2]
                scene_pixels = tile_ds.dsm_input.size * (1 + n_views)
                if scene_pixels > MAX_DEVICE_PIXELS:
                    # The resident rasters are never made for this scene:
                    # they would undo the bound.
                    sharded = group is not None and world > 1
                    logger.info(
                        f"Scene of {scene_pixels / 2**20:.0f} Mpx exceeds device "
                        "budget; " + (f"sharding row bands over {world} processes."
                                      if sharded else "streaming row bands."))
                    kwargs = dict(device=device, max_device_pixels=MAX_DEVICE_PIXELS,
                                  batch_size=batch_size, compute_dtype=compute_dtype,
                                  use_pallas=use_pallas, fold_bn=False, tta=tta,
                                  tta_merge=tta_merge, group=group)
                    if sharded:
                        # Whole bands a rank, all ranks at once; the chief
                        # adds them into the scene (the others get None).
                        prediction = predict_linear_blend_scene_sharded(
                            model, tile_ds, **kwargs)
                    else:
                        prediction = predict_linear_blend_streaming(
                            model, tile_ds, **kwargs)
                else:
                    if device_rasters is None:
                        device_rasters = device_put_dataset(tile_ds, device)
                    pair_rasters = dataclasses.replace(
                        device_rasters,
                        pairs=torch.as_tensor(tile_ds.pairs_array,
                                              dtype=torch.int64, device=device))
                    # Pipelining keeps the PREVIOUS pair's canvas on the
                    # device while THIS pair's accumulates: budget two
                    # canvases.
                    overlap = (scene_pixels + 2 * tile_ds.dsm_input.size
                               <= MAX_DEVICE_PIXELS)
                    prediction = predict_linear_blend(
                        model, tile_ds, device=device, batch_size=batch_size,
                        compute_dtype=compute_dtype, rasters=pair_rasters,
                        use_pallas=use_pallas, fold_bn=False,
                        as_numpy=not overlap, tta=tta, tta_merge=tta_merge,
                        group=group)
                pair_tag = (f" ({folder})" if image_pair is not None else "")
                job = (prediction, tile_ds, output_directory, pair_tag)

            if pending is None:
                pending = job
                continue
            prediction, tile_ds, output_directory, pair_tag = pending
            prediction = _to_numpy(prediction)  # fetch; overlaps job's compute
            pending = job
            if not chief:
                # The others fetch (pacing the pair pipeline as the chief
                # does) but never evaluate or write.
                continue

            area_defn = dataset.area_defn
            if dataset.get("raster_gt"):
                logger.info(f"Evaluate{pair_tag}...")
                stats_file = os.path.join(
                    output_directory,
                    f"{basename}_prediction{area_suffix}_statistics.txt")
                logger_stats = setup_logger(f"stats_logger_torch{next(_report_ids)}",
                                            level=logging.INFO,
                                            log_to_console=False,
                                            log_file=stats_file)
                logger_stats.info(f"Model name:\t{cfg.model.name}")
                logger_stats.info(f"Model weights:\t{cfg.model.weights}\n\n\n")
                add_console_logger(logger_stats)

                residuals = evaluate_performance(
                    prediction, raster_in, dataset.raster_gt, logger,
                    area_defn, dataset.mask_ground_truth, dataset.mask_building,
                    dataset.mask_water, dataset.mask_forest, logger_stats,
                    RESIDUAL_THRESHOLD)
                _close_file_handlers(logger_stats)

                logger.info(f"\n\nSave prediction{pair_tag}...")
                num_regions = len(area_defn["x_extent"])
                for i, (x_ext, y_ext) in enumerate(zip(area_defn["x_extent"],
                                                       area_defn["y_extent"])):
                    region_tag = f"_{i}" if num_regions > 1 else ""
                    file_prediction = os.path.join(
                        output_directory,
                        f"{basename}_prediction{area_suffix}{region_tag}.tif")
                    file_residuals = os.path.join(
                        output_directory,
                        f"{basename}_residuals{area_suffix}{region_tag}.tif")

                    pred_i = prediction[y_ext[0]:y_ext[1] + 1, x_ext[0]:x_ext[1] + 1]
                    res_i = residuals.all[y_ext[0]:y_ext[1] + 1,
                                          x_ext[0]:x_ext[1] + 1]

                    for key in residuals:
                        residual_pool.setdefault(key, []).append(
                            residuals[key][y_ext[0]:y_ext[1] + 1,
                                           x_ext[0]:x_ext[1] + 1].compressed())

                    logger.info(f"Write file: {file_prediction}")
                    raster_mod.write_raster(file_prediction, pred_i, like=raster_in,
                                            offset_x=x_ext[0], offset_y=y_ext[0],
                                            nodata=-9999, dtype=np.float32)
                    logger.info(f"Write file: {file_residuals}")
                    raster_mod.write_raster(file_residuals,
                                            res_i.filled(-9999), like=raster_in,
                                            offset_x=x_ext[0], offset_y=y_ext[0],
                                            nodata=-9999, dtype=np.float32)
                logger.info(f"Write file: {stats_file}\n\n")
            else:
                logger.info(f"\n\nSave prediction{pair_tag}...")
                num_regions = len(area_defn["x_extent"])
                for i, (x_ext, y_ext) in enumerate(zip(area_defn["x_extent"],
                                                       area_defn["y_extent"])):
                    region_tag = f"_{i}" if num_regions > 1 else ""
                    file_prediction = os.path.join(
                        output_directory,
                        f"{basename}_prediction{area_suffix}{region_tag}.tif")
                    pred_i = prediction[y_ext[0]:y_ext[1] + 1,
                                        x_ext[0]:x_ext[1] + 1].copy()
                    pred_i[pred_i == tile_ds.nodata] = -9999
                    logger.info(f"Write file: {file_prediction}\n\n")
                    raster_mod.write_raster(file_prediction, pred_i, like=raster_in,
                                            offset_x=x_ext[0], offset_y=y_ext[0],
                                            nodata=-9999, dtype=np.float32)

        # --------------------- aggregate over image pairs ------------------- #
        if chief and len(image_pairs) > 1 and dataset.get("raster_gt"):
            logger.info("\nCompute residual errors averaged over all predictions...")
            outfile = os.path.join(
                output_parent,
                f"{basename}_prediction{area_suffix}_performance_statistics_"
                f"mean_over_all_stereopairs.txt")
            logger_overall = setup_logger(f"stats_logger_torch{next(_report_ids)}",
                                          level=logging.INFO,
                                          log_to_console=False, log_file=outfile)
            logger_overall.info(f"Model name:\t{cfg.model.name}")
            logger_overall.info(f"Model weights:\t{cfg.model.weights}\n\n\n")
            add_console_logger(logger_overall)
            logger_overall.info("\nPerformance Evaluation: Statistics over all "
                                "predictions\n"
                                "-------------------------------------------------------\n")
            for key in CLASS_TITLES:
                if key not in residual_pool:
                    continue
                pooled = np.ma.masked_invalid(np.concatenate(residual_pool[key]))
                stats = get_statistics(pooled, RESIDUAL_THRESHOLD)
                header = f"STATISTICS, {CLASS_TITLES[key]}: REFINED DSM"
                logger_overall.info("\n{}\n{}\n".format(header, "-" * len(header)))
                print_statistics(stats, logger_overall)
            _close_file_handlers(logger_overall)

    logger.info("\nDone!")


if __name__ == "__main__":
    main()
