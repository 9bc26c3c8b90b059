"""Inference config validation.

Functional parity with the reference's lib/validate_cfg_inference.py:12-459.
Notable reference behaviours reproduced here:
  * the model architecture file (``model_config.json``, a train.py artifact)
    is merged INTO ``cfg.model`` (reference :59-60), so the inference config
    references training artifacts rather than restating the architecture;
  * datasets default to ``allocation_strategy='entire'`` when neither the
    dataset nor the general section names one (reference :241);
  * ``general.tile_size`` defaults to the training default and must satisfy
    the power-of-two >= 2^(depth+2) constraint (reference :393-403);
  * ``output.directory`` is mandatory and created eagerly (reference :430-459).

TPU extensions: model weights may be a reference ``.pth`` file or a native
checkpoint directory/file produced by this framework; normalization parameter
files may be the reference pickle (``.p``) or this framework's JSON.

The port's copy of ``resdepth_tpu/config/validate_infer.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

from __future__ import annotations

import copy
import os

from resdepth_tpu_torch.config import io, schema
from resdepth_tpu_torch.config.checks import (
    all_keys_known, in_enum, is_boolean, is_positive_integer, is_string, valid_tile_size,
)
from resdepth_tpu_torch.config.defaults import default_cfg
from resdepth_tpu_torch.utils import fs
from resdepth_tpu_torch.utils.attrdict import AttrDict
from resdepth_tpu_torch.utils.logging import setup_logger

_WEIGHT_EXTENSIONS = (".pth", ".npz", ".ckpt")
_NORM_EXTENSIONS = (".p", ".json")


def _check_artifact(model, key, extensions, logger) -> bool:
    if key not in model:
        logger.error(f"Missing argument '{key}' in 'model'.\n")
        return False
    if not is_string(model[key], key, logger):
        return False
    if fs.file_extension(model[key]) not in extensions:
        logger.error(f"Wrong argument '{key}': expected one of {list(extensions)} "
                     f"files, got {model[key]}.\n")
        return False
    if not fs.file_exists(model[key]):
        logger.error(f"Cannot find '{key}':\n{model[key]}\n")
        return False
    return True


def _valid_model_args(cfg, logger) -> bool:
    model = cfg.get("model", {})
    error = not all_keys_known(model, schema.MODEL_KEYS_eval, logger)

    if not _check_artifact(model, "weights", _WEIGHT_EXTENSIONS, logger):
        error = True
    input_channels = None
    if not _check_artifact(model, "architecture", (".json",), logger):
        error = True
    else:
        input_channels = io.read_json(model.architecture).get("input_channels")

    if input_channels is not None and input_channels != "stereo":
        if not _check_artifact(model, "normalization_geom", _NORM_EXTENSIONS, logger):
            error = True
    if input_channels is not None and input_channels != "geom":
        if not _check_artifact(model, "normalization_image", _NORM_EXTENSIONS, logger):
            error = True
    return not error


def _valid_dataset_args(cfg, input_config, logger) -> bool:
    datasets = cfg.get("datasets")
    if not isinstance(datasets, list) or len(datasets) == 0:
        logger.error("Invalid 'datasets' argument. Provide a non-empty list of dataset "
                     "dictionaries.\nMandatory keys: {}\nOptional keys: {}\n".format(
                         schema.DATASET_KEYS_MANDATORY_eval, schema.DATASET_KEYS_OPTIONAL_eval))
        return False

    errors = []
    for i, dataset in enumerate(datasets):
        error = not all_keys_known(
            dataset,
            schema.DATASET_KEYS_MANDATORY_eval + schema.DATASET_KEYS_OPTIONAL_eval,
            logger)

        if "raster_in" not in dataset:
            logger.error("Missing argument 'raster_in'.\n")
            error = True
        elif not is_string(dataset.raster_in, "raster_in", logger):
            error = True
        elif not fs.file_exists(dataset.raster_in):
            logger.error(f"Initial DSM raster does not exist:\n{dataset.raster_in}\n")
            error = True

        for key in ("raster_gt", "mask_ground_truth", "mask_building",
                    "mask_water", "mask_forest"):
            if key in dataset:
                if not is_string(dataset[key], key, logger):
                    error = True
                elif not fs.file_exists(dataset[key]):
                    logger.error(f"Raster '{key}' does not exist:\n{dataset[key]}\n")
                    error = True

        if input_config in ("geom-multiview", "geom-stereo", "geom-mono", "stereo"):
            for key in ("path_image_list", "path_pairlist"):
                if key not in dataset:
                    logger.error(f"Missing argument '{key}'.\n")
                    error = True
                elif not is_string(dataset[key], key, logger):
                    error = True
                elif fs.file_extension(dataset[key]) != ".txt":
                    logger.error(f"Wrong argument '{key}'. Specify a text file.\n")
                    error = True
                elif not fs.file_exists(dataset[key]):
                    logger.error(f"Cannot find:\n{dataset[key]}\n")
                    error = True
            # isinstance guard: a non-string value was already reported
            # above; os.path.isfile would raise on it (fuzz-found).
            if isinstance(dataset.get("path_image_list"), str) and \
                    fs.file_exists(dataset["path_image_list"]):
                from resdepth_tpu_torch.data import control_files
                for path in control_files.read_imagelist_from_file(dataset.path_image_list):
                    if not fs.file_exists(path):
                        logger.error(f"The following image does not exist:\t{path}\n")
                        error = True
        elif input_config == "geom" and (
                "path_image_list" in dataset or "path_pairlist" in dataset):
            logger.error("The specified model is trained without image guidance; "
                         "'path_image_list' and 'path_pairlist' are ignored.\n")

        # Allocation strategy: dataset key > general key > 'entire'
        # (reference default: lib/validate_cfg_inference.py:241).
        if "allocation_strategy" in dataset:
            if not in_enum(dataset.allocation_strategy, schema.ALLOCATION_STRATEGIES,
                           "allocation_strategy", logger):
                error = True
        elif "allocation_strategy" in cfg.get("general", {}):
            dataset.allocation_strategy = cfg.general.allocation_strategy
        else:
            dataset.allocation_strategy = "entire"

        if dataset.get("allocation_strategy") in ("5-crossval_vertical",
                                                  "5-crossval_horizontal"):
            if "test_stripe" not in dataset:
                logger.error("Missing argument 'test_stripe' (integer in [0,4]).\n")
                error = True
            elif not is_positive_integer(dataset.test_stripe, "test_stripe", logger,
                                         zero_allowed=True) or dataset.test_stripe > 4:
                logger.error("'test_stripe' must be an integer in the range [0,4].\n")
                error = True
            if "area_type" not in dataset:
                logger.error(f"Missing argument 'area_type'. "
                             f"Choose among {schema.DATASET_AREA_TYPES_eval}.\n")
                error = True
            elif not in_enum(dataset.area_type, schema.DATASET_AREA_TYPES_eval,
                             "area_type", logger):
                error = True
            if "crossval_training" in dataset and not is_boolean(
                    dataset.crossval_training, "crossval_training", logger):
                error = True

        if error:
            logger.info("\n")
        else:
            logger.info(f"Dataset {i}: settings check ok.\n")
        errors.append(error)

    return not any(errors)


def _valid_general_args(cfg, logger) -> bool:
    general = cfg.setdefault("general", AttrDict())
    defaults = default_cfg()
    error = not all_keys_known(general, schema.GENERAL_KEYS_eval +
                               ["allocation_strategy", "test_stripe"], logger)

    if "allocation_strategy" in general and not in_enum(
            general.allocation_strategy, schema.ALLOCATION_STRATEGIES,
            "allocation_strategy", logger):
        error = True

    tile_size_ok = True
    if "tile_size" in general:
        depth = cfg.get("model", {}).get("settings", {}).get("depth", defaults.model.depth)
        if not valid_tile_size(general.tile_size, "tile_size", depth + 2, logger):
            error = True
            tile_size_ok = False
    else:
        general.tile_size = defaults.training_settings.tile_size

    if "workers" in general:
        if not is_positive_integer(general.workers, "workers", logger, zero_allowed=True):
            error = True
    else:
        general.workers = os.cpu_count() or 1

    if "batch_size" in general and not is_positive_integer(general.batch_size,
                                                           "batch_size", logger):
        error = True
    if "compute_dtype" in general and not in_enum(general.compute_dtype,
                                                  schema.COMPUTE_DTYPES,
                                                  "compute_dtype", logger):
        error = True
    if "use_pallas" in general and general.use_pallas != "fused" and \
            not is_boolean(general.use_pallas, "use_pallas", logger):
        error = True
    if "tile_stride" in general:
        if not is_positive_integer(general.tile_stride, "tile_stride", logger):
            error = True
        elif not tile_size_ok:
            pass  # tile_size already reported; the range bounds are undefined
        elif not (general.tile_size // 2 <= general.tile_stride
                  <= general.tile_size):
            # Below tile/2 more than two tiles overlap per axis and the
            # linear blend is no longer a partition of unity (ops/blend.py).
            logger.error(f"Invalid argument 'tile_stride': "
                         f"{general.tile_stride} must lie in "
                         f"[tile_size/2, tile_size] = "
                         f"[{general.tile_size // 2}, "
                         f"{general.tile_size}].\n")
            error = True
        elif general.tile_stride != general.tile_size // 2:
            # Reference parity note, not an error: the reference always
            # evaluates at stride = tile/2 (lib/DsmOrthoDataset.py:99-100).
            logger.info(f"tile_stride {general.tile_stride} != tile_size/2 "
                        f"({general.tile_size // 2}): output departs from "
                        "reference-parity tiling (less/more seam overlap).\n")
    if "tta" in general:
        if not is_positive_integer(general.tta, "tta", logger):
            error = True
        elif general.tta not in (1, 2, 4, 8):
            # Supported counts are dihedral SUBGROUPS (infer/tiled.py:
            # TTA_SUBGROUPS) so the averaged predictor is exactly invariant
            # under the chosen symmetries.
            logger.error(f"Invalid argument 'tta': {general.tta} must be one "
                         f"of [1, 2, 4, 8] (dihedral subgroup sizes).\n")
            error = True
    if "tta_merge" in general and general.tta_merge not in ("mean", "median"):
        logger.error(f"Invalid argument 'tta_merge': {general.tta_merge} "
                     f"must be one of ['mean', 'median'].\n")
        error = True
    if "serving_preset" in general:
        if not in_enum(general.serving_preset, schema.SERVING_PRESETS,
                       "serving_preset", logger):
            error = True
        elif general.serving_preset in ("accuracy", "throughput"):
            # Measured modes (BASELINE.md round-4 TTA x stride grid):
            # accuracy = stride 3*tile/4 + tta 4 (full TTA-4 gain at 1.43x
            # parity wall); throughput = stride 3*tile/4, tta off (0.61x
            # wall at +0.08 cm). Explicit keys override preset members.
            members = (("tile_stride", "tta")
                       if general.serving_preset == "accuracy"
                       else ("tile_stride",))  # throughput sets stride only
            overridden = [k for k in members if k in general]
            if overridden:
                logger.info(f"serving_preset {general.serving_preset!r}: "
                            f"explicit {overridden} override the preset's "
                            f"members.\n")
    if "data_parallel" in general and not is_boolean(general.data_parallel,
                                                     "data_parallel", logger):
        error = True
    return not error


def _valid_output_args(cfg, logger) -> bool:
    output = cfg.get("output", {})
    error = not all_keys_known(output, schema.OUTPUT_KEYS_eval, logger)
    if "directory" not in output:
        logger.error("Missing argument 'directory' in 'output'.\n")
        error = True
    elif not is_string(output.directory, "directory", logger):
        error = True
    elif not output.directory.strip():
        logger.error("Invalid 'directory': empty path.\n")
        error = True
    else:
        try:
            fs.make_dir(output.directory)
        except OSError as exc:
            logger.error(f"Cannot create output directory "
                         f"{output.directory!r}: {exc}\n")
            error = True
    return not error


def validate_and_update_cfg_file(cfg_file, logger=None) -> AttrDict:
    """Validate + enrich an inference config.

    Returns ``AttrDict(status=bool, cfg=AttrDict)``; on success ``cfg.model``
    has been merged with the training-artifact ``model_config.json``.
    """
    if logger is None:
        logger = setup_logger("validate_cfg_file", log_to_console=True, log_file=None)

    if isinstance(cfg_file, dict):
        cfg = AttrDict(copy.deepcopy(dict(cfg_file)))
    else:
        cfg = io.read_json(cfg_file)
        if not cfg:
            return AttrDict(status=False, cfg={})

    if not all_keys_known(cfg, schema.PRIMARY_KEYS_eval, logger):
        return AttrDict(status=False, cfg={})
    missing = [k for k in schema.PRIMARY_KEYS_eval if k not in cfg]
    if missing:
        logger.error("The following keys are missing: {}.\n".format(
            ",".join(f"'{k}'" for k in missing)))
        return AttrDict(status=False, cfg={})

    from resdepth_tpu_torch.config.validate_train import _sections_well_typed
    if not _sections_well_typed(cfg, logger):
        return AttrDict(status=False, cfg={})

    if not _valid_model_args(cfg, logger):
        return AttrDict(status=False, cfg={})

    # Merge the training-artifact architecture into cfg.model
    # (reference: lib/validate_cfg_inference.py:59-60).
    cfg.model.update(io.read_json(cfg.model.architecture))

    if not _valid_dataset_args(cfg, cfg.model.input_channels, logger):
        return AttrDict(status=False, cfg={})
    if not _valid_general_args(cfg, logger):
        return AttrDict(status=False, cfg={})
    if not _valid_output_args(cfg, logger):
        return AttrDict(status=False, cfg={})

    return AttrDict(status=True, cfg=cfg)
