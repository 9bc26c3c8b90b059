"""Orchestration: config -> datasets, areas, pairlists, model, run artifacts.

The hub layer between the CLIs and the framework proper, mirroring the
responsibilities of the reference's lib/utils.py (create_output_directory
:23-44, allocate_area :81-108, prepare_dataset_configuration :444-526,
read_image_pairs :529-637, model-arg collection :732-779) without the
reference's import-cycle hub topology.

The port's copy of ``resdepth_tpu/orchestration.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

from __future__ import annotations

import os
from datetime import datetime

from resdepth_tpu_torch.config import schema
from resdepth_tpu_torch.config.defaults import default_cfg
from resdepth_tpu_torch.data import control_files
from resdepth_tpu_torch.geo import allocation
from resdepth_tpu_torch.geo.allocation import entire_area_defn
from resdepth_tpu_torch.utils import fs
from resdepth_tpu_torch.utils.attrdict import AttrDict
from resdepth_tpu_torch.utils.logging import setup_logger


# ------------------------------ run artifacts ----------------------------- #

def create_output_folder_name(suffix: str | None = None) -> str:
    now = datetime.now().strftime("%Y-%m-%d_%H-%M")
    return f"{now}_{suffix}" if suffix else now


def create_output_directory(cfg) -> str | None:
    """Create the timestamped run directory (reference: lib/utils.py:23-44)."""
    output = cfg.get("output", {})
    if not isinstance(output.get("output_directory"), str):
        return None
    suffix = output.get("suffix")
    if not isinstance(suffix, str):
        suffix = default_cfg().output.suffix
    directory = os.path.join(output["output_directory"],
                             create_output_folder_name(suffix))
    fs.make_dir(directory)
    return directory


def print_dataset_name_to_console(dataset, index, logger=None):
    name = f"Dataset {index}: {dataset['name']}" if "name" in dataset \
        else f"Dataset {index}:"
    line = "{}\n{}\n".format(name, "~" * len(name))
    if logger:
        logger.info(line)
    else:
        print(line)


# ------------------------------ area allocation --------------------------- #

def allocate_area(cfg) -> None:
    """Resolve each dataset's geographic splits in place.

    'entire' -> the full raster as ``area_defn``; otherwise the 5-stripe
    split with per-phase definitions (``area_defn_train`` / ``area_defn_val``
    for training phases, ``area_defn`` for the test stripe) — parity with
    lib/utils.py:81-108.
    """
    for dataset in cfg.datasets:
        if dataset.get("allocation_strategy") == "entire":
            dataset.area_defn = AttrDict(entire_area_defn(dataset.raster_in))
            continue
        train_area, val_area, test_area = allocation.allocate_data(
            dataset.raster_in, dataset.allocation_strategy,
            test_stripe=dataset.test_stripe,
            crossval_training=dataset.get("crossval_training", False))
        area_type = dataset.get("area_type", "")
        if "train" in area_type:
            dataset.area_defn_train = AttrDict(train_area)
        if "val" in area_type:
            dataset.area_defn_val = AttrDict(val_area)
        if "test" in area_type:
            if not test_area:
                # allocate_data returns test={} for cross-validation runs
                # (the chosen stripe is the VAL area); fail here with the
                # cause instead of a downstream KeyError on 'x_extent'.
                raise ValueError(
                    f"Dataset {dataset.get('name', dataset.raster_in)!r}: "
                    "area_type 'test' with crossval_training=true allocates "
                    "no test stripe (cross-validation uses the chosen stripe "
                    "for validation). Use area_type 'val' or disable "
                    "crossval_training.")
            dataset.area_defn = AttrDict(test_area)


# --------------------------- dataset configuration ------------------------- #

def prepare_dataset_configuration(cfg, phase: str):
    """Extract per-phase dataset definitions (parity: lib/utils.py:444-526)."""
    assert phase in ("train", "val", "test")
    image_guided = cfg.model.input_channels != "geom"
    cfg_list = []

    if phase == "test":
        keys = ["name", "raster_gt", "raster_in", "mask_ground_truth",
                "mask_building", "mask_water", "mask_forest", "area_defn"]
        if image_guided:
            keys += ["image_list", "image_pairs"]
        for dataset in cfg.datasets:
            entry = AttrDict()
            for key in keys:
                if key in dataset:
                    entry[key] = dataset[key]
            for key in ("mask_ground_truth", "mask_building", "mask_water",
                        "mask_forest"):
                entry.setdefault(key, None)
            # Inference over training/validation stripes uses their areas.
            if "area_defn_train" in dataset:
                entry.area_defn = dataset["area_defn_train"]
            if "area_defn_val" in dataset:
                entry.area_defn = dataset["area_defn_val"]
            cfg_list.append(entry)
        return cfg_list

    keys = ["name", "raster_gt", "raster_in"]
    if image_guided:
        keys.append("image_list")
    for dataset in cfg.datasets:
        if phase not in dataset.get("area_type", ""):
            continue
        entry = AttrDict()
        for key in keys:
            if key in dataset:
                entry[key] = dataset[key]
        if phase == "train":
            if image_guided:
                entry.image_pairs = dataset.image_pairs_train
            entry.area_defn = dataset.area_defn_train
            entry.n_samples = dataset.n_training_samples
        else:
            if image_guided:
                entry.image_pairs = dataset.image_pairs_val
            entry.area_defn = dataset.area_defn_val
        cfg_list.append(entry)
    return cfg_list


# ------------------------------- image pairs ------------------------------ #

def _pairs_valid(input_channels, pairlist_path, image_pairs, multiview_config,
                 logger) -> bool:
    """Arity checks per channel mode (parity: lib/utils.py:782-826)."""
    if input_channels == "geom-multiview":
        n_views = schema.n_views(multiview_config)
        if n_views != len(image_pairs[0]):
            logger.error(f"'geom-multiview' with '{multiview_config}' needs image "
                         f"pairs of {n_views} images, got {len(image_pairs[0])} "
                         f"in {pairlist_path}.\n")
            return False
    elif "stereo" in input_channels:
        if len(image_pairs[0]) != 2:
            logger.error(f"'{input_channels}' needs image pairs of 2 images "
                         f"in {pairlist_path}.\n")
            return False
    elif input_channels == "geom-mono":
        if len(image_pairs) != 1 or len(image_pairs[0]) != 1:
            logger.error(f"'geom-mono' needs a single image in {pairlist_path}.\n")
            return False
    return True


def read_image_pairs(cfg, logger=None) -> bool:
    """Read/validate the image-pair lists for every dataset (in place).

    Training pairlists populate ``image_pairs_train`` / ``image_pairs_val``;
    inference pairlists populate ``image_pairs`` (parity:
    lib/utils.py:529-637). Returns False on any error.
    """
    if logger is None:
        logger = setup_logger("read_image_pairs", log_to_console=True, log_file=None)
    if cfg.model.input_channels == "geom":
        return True

    roles = (("path_pairlist_training", "image_pairs_train", "training"),
             ("path_pairlist_validation", "image_pairs_val", "validation"),
             ("path_pairlist", "image_pairs", "inference"))

    for i, dataset in enumerate(cfg.datasets):
        print_dataset_name_to_console(dataset, i, logger)
        for path_key, out_key, label in roles:
            if path_key not in dataset:
                continue
            image_list, pairs = control_files.read_pairlist_from_file(
                dataset.path_image_list, dataset[path_key], logger)
            if pairs is None:
                return False
            dataset.image_list = image_list
            dataset[out_key] = pairs

            if cfg.model.input_channels == "geom-multiview":
                if path_key == "path_pairlist":
                    n_views = cfg.model.settings.n_input_channels - 1
                    multiview_config = f"{n_views}-view"
                else:
                    multiview_config = cfg.multiview.config
            else:
                multiview_config = None
            if not _pairs_valid(cfg.model.input_channels, dataset[path_key],
                                pairs, multiview_config, logger):
                return False

            names = [", ".join(fs.filename(image_list[i]) for i in pair)
                     for pair in pairs]
            logger.info(f"Selected the following image pair(s) for {label}:")
            for line in names:
                logger.info(line)
            logger.info("\n")
    return True


# ------------------------------ model factory ------------------------------ #

def collect_model_args(cfg) -> AttrDict:
    """Model architecture artifact (model_config.json payload).

    Parity with lib/utils.py:732-779 — the artifact carries everything needed
    to rebuild the network at inference time.
    """
    settings = AttrDict(
        n_input_channels=schema.count_input_channels(
            cfg.model.input_channels, cfg.get("multiview", {}).get("config", "3-view")),
        start_kernel=cfg.model.start_kernel,
        depth=cfg.model.depth,
        act_fn_encoder=cfg.model.act_fn_encoder,
        act_fn_decoder=cfg.model.act_fn_decoder,
        act_fn_bottleneck=cfg.model.act_fn_bottleneck,
        up_mode=cfg.model.up_mode,
        do_BN=cfg.model.do_BN,
        outer_skip=cfg.model.outer_skip,
        outer_skip_BN=cfg.model.outer_skip_BN,
        bias_conv_layer=cfg.model.bias_conv_layer,
        max_filter_depth=cfg.model.get("max_filter_depth", 512),
    )
    return AttrDict(name=cfg.model.name,
                    input_channels=cfg.model.input_channels,
                    settings=settings)
