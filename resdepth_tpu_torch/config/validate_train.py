"""Training config validation.

Functional parity with the reference's lib/validate_cfg_training.py:11-877 —
the same front-line defense the reference relies on in lieu of a test suite:
reject unknown keys, missing mandatory keys, invalid enum values, bad types,
and non-existent input files before any compute starts. Also implements
``augment_dataset_args`` (reference :114-156), which pushes global settings
down into each dataset entry.

The port's copy of ``resdepth_tpu/config/validate_train.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

from __future__ import annotations

import copy

from resdepth_tpu_torch.config import io, schema
from resdepth_tpu_torch.config.checks import (
    all_keys_known, in_enum, is_boolean, is_positive_integer,
    is_positive_number, is_string, valid_tile_size,
)
from resdepth_tpu_torch.config.defaults import default_cfg
from resdepth_tpu_torch.utils import fs
from resdepth_tpu_torch.utils.attrdict import AttrDict
from resdepth_tpu_torch.utils.logging import setup_logger


def _image_guided(cfg_user) -> bool:
    return _input_channels(cfg_user) != "geom"


def _check_txt_file(value, key, logger) -> bool:
    if not is_string(value, key, logger):
        return False
    if fs.file_extension(value) != ".txt":
        (logger.error if logger else print)(
            f"Wrong argument '{key}'. Specify a text file.\n")
        return False
    if not fs.file_exists(value):
        (logger.error if logger else print)(f"Cannot find the file:\n{value}\n")
        return False
    return True


def _valid_dataset_args(cfg_user, logger) -> bool:
    datasets = cfg_user.get("datasets")
    if not isinstance(datasets, list) or len(datasets) == 0:
        logger.error("Invalid 'datasets' argument. Provide a non-empty list of dataset "
                     "dictionaries.\nMandatory keys: {}\nOptional keys: {}\n".format(
                         schema.DATASET_KEYS_MANDATORY_train, schema.DATASET_KEYS_OPTIONAL))
        return False

    image_guided = _image_guided(cfg_user)
    errors = []
    n_crossval = 0

    for i, dataset in enumerate(datasets):
        error = False
        error |= not all_keys_known(
            dataset, schema.DATASET_KEYS_MANDATORY_train + schema.DATASET_KEYS_OPTIONAL, logger)

        for key in ("raster_in", "raster_gt"):
            if key not in dataset:
                logger.error(f"Missing argument '{key}' in dataset {i}.\n")
                error = True
            elif not is_string(dataset[key], key, logger):
                error = True
            elif not fs.file_exists(dataset[key]):
                logger.error(f"Raster does not exist:\n{dataset[key]}\n")
                error = True

        if "area_type" not in dataset:
            logger.error(f"Missing argument 'area_type' in dataset {i}. "
                         f"Choose among {schema.DATASET_AREA_TYPES}.\n")
            error = True
        elif not in_enum(dataset.area_type, schema.DATASET_AREA_TYPES, "area_type", logger):
            error = True

        if image_guided:
            if "path_image_list" not in dataset:
                logger.error("Missing argument 'path_image_list'. Specify a text file that "
                             "lists the ortho-rectified image paths.\n")
                error = True
            elif not _check_txt_file(dataset.path_image_list, "path_image_list", logger):
                error = True
            else:
                from resdepth_tpu_torch.data import control_files
                for path in control_files.read_imagelist_from_file(dataset.path_image_list):
                    if not fs.file_exists(path):
                        logger.error(f"The following image does not exist:\t{path}\n")
                        error = True

            area_type = str(dataset.get("area_type", ""))
            needs_training_pairs = "train" in area_type
            needs_val_pairs = "val" in area_type
            if needs_training_pairs:
                if "path_pairlist_training" not in dataset:
                    logger.error("Missing argument 'path_pairlist_training'.\n")
                    error = True
                elif not _check_txt_file(dataset.path_pairlist_training,
                                         "path_pairlist_training", logger):
                    error = True
            if needs_val_pairs:
                if "path_pairlist_validation" not in dataset:
                    logger.error("Missing argument 'path_pairlist_validation'.\n")
                    error = True
                elif not _check_txt_file(dataset.path_pairlist_validation,
                                         "path_pairlist_validation", logger):
                    error = True

        if "allocation_strategy" in dataset and not in_enum(
                dataset.allocation_strategy, schema.ALLOCATION_STRATEGIES,
                "allocation_strategy", logger):
            error = True

        if "test_stripe" in dataset:
            if not is_positive_integer(dataset.test_stripe, "test_stripe", logger,
                                       zero_allowed=True) or dataset.test_stripe > 4:
                logger.error("'test_stripe' must be an integer in the range [0,4].\n")
                error = True

        if "n_training_samples" in dataset and not is_positive_integer(
                dataset.n_training_samples, "n_training_samples", logger):
            error = True

        # 'entire' allocation dedicates the whole raster to one role, so a
        # combined 'train+val' area_type is contradictory
        # (lib/validate_cfg_training.py:361-368).
        allocation = dataset.get(
            "allocation_strategy",
            cfg_user.get("general", {}).get("allocation_strategy",
                                            default_cfg().general.allocation_strategy))
        if allocation == "entire" and "+" in str(dataset.get("area_type", "")):
            logger.error(f"'area_type' cannot be '{dataset.area_type}' with "
                         "'allocation_strategy': 'entire'. Choose 'train' or "
                         "'val', or a 5-crossval allocation.\n")
            error = True

        if "crossval_training" in dataset and not is_boolean(
                dataset.crossval_training, "crossval_training", logger):
            error = True
        elif dataset.get("crossval_training"):
            n_crossval += 1

        if error:
            logger.info("\n")
        else:
            logger.info(f"Dataset {i}: settings check ok.\n")
        errors.append(error)

    ok = not any(errors)

    # Every run needs at least one training and one validation area
    # (lib/validate_cfg_training.py:385-401).
    for role in ("train", "val"):
        if not any(role in str(d.get("area_type", "")) for d in datasets):
            logger.error(f"Specify at least one {role} dataset: no dataset's "
                         f"'area_type' covers '{role}'. Choose among "
                         f"{schema.DATASET_AREA_TYPES}.\n")
            ok = False

    # Cross-validation runs over exactly one dataset, split by a 5-crossval
    # allocation (lib/validate_cfg_training.py:403-417).
    if n_crossval > 1 or (n_crossval == 1 and len(datasets) > 1):
        logger.error("Specify one dataset only to perform cross-validation "
                     "(set 'area_type' to 'train+val' with a 5-crossval "
                     "'allocation_strategy').\n")
        ok = False
    if n_crossval == 1 and len(datasets) == 1 and \
            datasets[0].get("allocation_strategy") == "entire":
        logger.error("Invalid allocation strategy 'entire' for "
                     "cross-validation. Choose among "
                     "['5-crossval_vertical', '5-crossval_horizontal'].\n")
        ok = False

    return ok


def _valid_model_args(cfg_user, logger) -> bool:
    model = cfg_user.get("model", {})
    error = not all_keys_known(model, schema.MODEL_KEYS, logger)

    if "name" in model and not in_enum(model.name, schema.ARCHITECTURES, "name", logger):
        error = True
    if "input_channels" in model and not in_enum(
            model.input_channels, schema.INPUT_CHANNELS, "input_channels", logger):
        error = True
    for key in ("depth", "start_kernel", "max_filter_depth"):
        if key in model and not is_positive_integer(model[key], key, logger):
            error = True
    for key in ("act_fn_encoder", "act_fn_decoder", "act_fn_bottleneck"):
        if key in model and not in_enum(model[key], schema.ACTIVATION_FUNCTIONS, key, logger):
            error = True
    if "up_mode" in model and not in_enum(model.up_mode, schema.UPSAMPLING_MODES,
                                          "up_mode", logger):
        error = True
    for key in ("do_BN", "bias_conv_layer", "outer_skip", "outer_skip_BN"):
        if key in model and not is_boolean(model[key], key, logger):
            error = True
    if "pretrained_path" in model:
        if not is_string(model.pretrained_path, "pretrained_path", logger):
            error = True
        elif not fs.file_exists(model.pretrained_path):
            logger.error(f"Cannot find the pretrained model:\n{model.pretrained_path}\n")
            error = True
    # The long residual skip requires the initial DSM as channel 0
    # (reference check: lib/validate_cfg_training.py:504-515; note the
    # reference default outer_skip=True applies when the key is absent).
    if model.get("input_channels") == "stereo" and \
            model.get("outer_skip", default_cfg().model.outer_skip):
        logger.error("'outer_skip' requires the initial DSM as input channel 0; it cannot "
                     "be combined with the image-only 'stereo' configuration.\n")
        error = True
    return not error


def _input_channels(cfg_user) -> str:
    return cfg_user.get("model", {}).get("input_channels",
                                         default_cfg().model.input_channels)


def _valid_multiview_args(cfg_user, logger) -> bool:
    # The reference ignores (with a warning) the whole section unless the
    # input configuration is multi-view (lib/validate_cfg_training.py:551-562).
    if _input_channels(cfg_user) != "geom-multiview":
        logger.warning("'input_channels' is not 'geom-multiview'; the "
                       "'multiview' settings will be ignored.\n")
        return True
    mv = cfg_user.multiview
    error = not all_keys_known(mv, schema.MULTIVIEW_KEYS, logger)
    if "config" in mv and not in_enum(mv.config, schema.MULTIVIEW_CONFIG, "config", logger):
        error = True
    return not error


def _valid_stereo_args(cfg_user, logger) -> bool:
    # Ignored (with a warning) for single-image and DSM-only inputs
    # (lib/validate_cfg_training.py:593-608).
    if _input_channels(cfg_user) in ("geom", "geom-mono"):
        logger.warning("'input_channels' uses at most one image; the "
                       "'stereopair_settings' will be ignored.\n")
        return True
    stereo = cfg_user.stereopair_settings
    error = not all_keys_known(stereo, schema.STEREO_KEYS, logger)
    for key in schema.STEREO_KEYS:
        if key in stereo and not is_boolean(stereo[key], key, logger):
            error = True
    return not error


def _valid_training_args(cfg_user, logger) -> bool:
    training = cfg_user.get("training_settings", {})
    error = not all_keys_known(training, schema.TRAINING_KEYS, logger)

    if "tile_size" in training:
        depth = cfg_user.get("model", {}).get("depth", None)
        if not isinstance(depth, int) or isinstance(depth, bool) or depth < 1:
            # an invalid user depth is reported by the model-section check;
            # fall back to the default so the tile check stays well-defined
            depth = default_cfg().model.depth
        if not valid_tile_size(training.tile_size, "tile_size", depth + 2, logger):
            error = True
    for key in ("n_training_samples", "batch_size", "n_epochs"):
        if key in training and not is_positive_integer(training[key], key, logger):
            error = True
    if "augment" in training and not is_boolean(training.augment, "augment", logger):
        error = True
    if "loss" in training and not in_enum(training.loss, schema.LOSSES, "loss", logger):
        error = True
    if "ema_decay" in training:
        value = training.ema_decay
        # 0 disables; 1 would freeze the EMA at initialisation forever.
        if isinstance(value, bool) or not isinstance(value, (int, float)) \
                or not (0 <= value < 1):
            logger.error(f"Invalid argument 'ema_decay': {value!r} must be a "
                         "number in [0, 1) (0 disables the weight EMA).\n")
            error = True
    return not error


def _valid_optimizer_args(cfg_user, logger) -> bool:
    optimizer = cfg_user.get("optimizer", {})
    error = not all_keys_known(optimizer, schema.OPTIMIZER_KEYS, logger)
    if "optimizer" in cfg_user and "name" not in optimizer:
        # The reference demands an explicit optimizer name whenever the
        # section appears (lib/validate_cfg_training.py:696-698).
        logger.error("The optimizer is not specified. Choose among "
                     f"{schema.OPTIMIZERS} to specify 'name'.\n")
        error = True
    if "name" in optimizer and not in_enum(optimizer.name, schema.OPTIMIZERS, "name", logger):
        error = True
    if "learning_rate" in optimizer and not is_positive_number(
            optimizer.learning_rate, "learning_rate", logger):
        error = True
    if "weight_decay" in optimizer and not is_positive_number(
            optimizer.weight_decay, "weight_decay", logger, zero_allowed=True):
        error = True
    return not error


def _valid_scheduler_args(cfg_user, logger) -> bool:
    scheduler = cfg_user.get("scheduler", {})
    error = not all_keys_known(scheduler, schema.SCHEDULER_KEYS, logger)
    if "scheduler" in cfg_user:
        # The reference demands an explicit name and enabled flag whenever
        # the section appears (lib/validate_cfg_training.py:745-760); we
        # relax the name requirement for a disabled scheduler
        # ({"enabled": false} needs no name — pinned divergence,
        # docs/PARITY.md).
        if "name" not in scheduler and scheduler.get("enabled", True):
            logger.error("The learning rate scheduler is not specified. Choose "
                         f"among {schema.SCHEDULERS} to specify 'name'.\n")
            error = True
        if "enabled" not in scheduler:
            logger.error("Missing argument 'enabled'. Enable or disable the "
                         "learning rate scheduler.\n")
            error = True
    if "enabled" in scheduler and not is_boolean(scheduler.enabled, "enabled", logger):
        error = True
    if "name" in scheduler and not in_enum(scheduler.name, schema.SCHEDULERS, "name", logger):
        error = True
    if "settings" in scheduler and not isinstance(scheduler.settings, dict):
        logger.error("Invalid 'settings' in 'scheduler'. Specify a dictionary.\n")
        error = True
    return not error


def _valid_general_args(cfg_user, logger) -> bool:
    general = cfg_user.get("general", {})
    error = not all_keys_known(general, schema.GENERAL_KEYS, logger)
    if "allocation_strategy" in general and not in_enum(
            general.allocation_strategy, schema.ALLOCATION_STRATEGIES,
            "allocation_strategy", logger):
        error = True
    if "test_stripe" in general:
        if not is_positive_integer(general.test_stripe, "test_stripe", logger,
                                   zero_allowed=True) or general.test_stripe > 4:
            logger.error("'test_stripe' must be an integer in the range [0,4].\n")
            error = True
    if "workers" in general and not is_positive_integer(general.workers, "workers", logger,
                                                        zero_allowed=True):
        error = True
    if "random_seed" in general and general.random_seed is not None and \
            (type(general.random_seed) is not int or general.random_seed < 0):
        logger.error("Invalid 'random_seed'. Specify a non-negative integer "
                     "or null.\n")
        error = True
    for key in ("save_model_rate", "evaluate_rate"):
        if key in general and not is_positive_integer(general[key], key, logger):
            error = True
    if "auto_resume" in general and not is_boolean(general.auto_resume,
                                                   "auto_resume", logger):
        error = True
    return not error


def _valid_output_args(cfg_user, logger) -> bool:
    output = cfg_user.get("output", {})
    error = not all_keys_known(output, schema.OUTPUT_KEYS, logger)
    if "output_directory" not in output:
        logger.error("Missing argument 'output_directory' in 'output'.\n")
        error = True
    elif not is_string(output.output_directory, "output_directory", logger):
        error = True
    elif not output.output_directory.strip():
        # '' would silently resolve run dirs relative to the CWD (the
        # reference's check dies with a raw FileNotFoundError on it)
        logger.error("Invalid 'output_directory': empty path.\n")
        error = True
    for key in ("tboard_log_dir", "suffix"):
        if key in output and not is_string(output[key], key, logger):
            error = True
    if "plot_model_txt" in output and not is_boolean(output.plot_model_txt,
                                                     "plot_model_txt", logger):
        error = True
    return not error


def _valid_tpu_args(cfg_user, logger) -> bool:
    tpu = cfg_user.get("tpu", {})
    error = not all_keys_known(tpu, schema.TPU_KEYS, logger)
    if "compute_dtype" in tpu and not in_enum(tpu.compute_dtype, schema.COMPUTE_DTYPES,
                                              "compute_dtype", logger):
        error = True
    elif tpu.get("compute_dtype") not in (None, "float32", "bfloat16"):
        logger.error(f"'{tpu.compute_dtype}' is an inference serving mode "
                     "(eval config general.compute_dtype); for training "
                     "precision use tpu.train_precision.\n")
        error = True
    if "train_precision" in tpu and not in_enum(
            tpu.train_precision, schema.TRAIN_PRECISIONS, "train_precision",
            logger):
        error = True
    elif (tpu.get("train_precision") in ("balanced", "balanced16")
          and tpu.get("compute_dtype") == "bfloat16"):
        # The balanced modes' high-fidelity endpoints need the f32 batch
        # input; 'balanced16' already runs the trunk in bf16 activations.
        logger.error(f"tpu.train_precision '{tpu.train_precision}' requires "
                     "compute_dtype 'float32' (balanced16 IS the bf16-trunk "
                     "mode).\n")
        error = True
    for key in ("data_parallel", "use_pallas", "donate_state", "distributed",
                "remat"):
        if key in tpu and not is_boolean(tpu[key], key, logger):
            error = True
    if "steps_per_call" in tpu and not is_positive_integer(
            tpu.steps_per_call, "steps_per_call", logger):
        error = True
    if "dcn_slices" in tpu and not is_positive_integer(
            tpu.dcn_slices, "dcn_slices", logger):
        error = True
    if "max_device_pixels" in tpu and tpu.max_device_pixels != 0:
        if not is_positive_integer(tpu.max_device_pixels,
                                   "max_device_pixels", logger):
            error = True
        else:
            # Config-time feasibility floor: a band window must hold at
            # least one tile row-span of the two DSM planes (the per-region
            # check with the real raster width runs before training and
            # errors with the exact required budget — train.py).
            tile = cfg_user.get("training_settings", {}).get("tile_size", 256)
            if isinstance(tile, int) and tpu.max_device_pixels < 2 * tile * tile:
                logger.error(
                    f"'max_device_pixels' ({tpu.max_device_pixels}) is below "
                    f"a single {tile}-px tile window of the DSM input+target "
                    f"planes ({2 * tile * tile}); no band can fit. Raise it "
                    "or reduce training_settings.tile_size.\n")
                error = True
    for key in ("mesh_axis", "profile_dir"):
        if key in tpu and not is_string(tpu[key], key, logger):
            error = True
    return not error


_SECTION_CHECKS = [
    ("datasets", _valid_dataset_args, True),
    ("model", _valid_model_args, True),
    ("multiview", _valid_multiview_args, False),
    ("stereopair_settings", _valid_stereo_args, False),
    ("training_settings", _valid_training_args, True),
    ("optimizer", _valid_optimizer_args, True),
    ("scheduler", _valid_scheduler_args, True),
    ("general", _valid_general_args, True),
    ("output", _valid_output_args, True),
    ("tpu", _valid_tpu_args, False),
]


def _sections_well_typed(cfg_user, logger) -> bool:
    """Primary sections must be objects ('datasets' a list of objects): a
    scalar where a section is expected would otherwise surface as a raw
    AttributeError deep inside a section check (the reference crashes with a
    TypeError on the same inputs) instead of the clean ERROR-line contract
    the CLIs promise.

    Two parity carve-outs (differential-fuzz-found; the reference ACCEPTS
    these, so rejecting them would diverge on valid-to-the-reference input):
    a section the input mode ignores is never inspected by the reference
    (warn+ignore, lib/validate_cfg_training.py:551,593), so its type cannot
    fail there; and an EMPTY container passes the reference's key iteration
    vacuously (all_keys_known over nothing). Non-empty non-dict values for
    the inspected sections still fail cleanly here — the reference crashes
    on those, which the CLI contract forbids."""
    model = cfg_user.get("model", {})
    channels = (_input_channels(cfg_user) if isinstance(model, dict)
                else default_cfg().model.input_channels)
    mode_ignored = set()
    if channels != "geom-multiview":
        mode_ignored.add("multiview")
    if channels in ("geom", "geom-mono"):
        mode_ignored.add("stereopair_settings")

    ok = True
    for key, value in cfg_user.items():
        if key == "datasets":
            if not isinstance(value, list) or \
                    any(not isinstance(d, dict) for d in value):
                logger.error(f"Invalid section '{key}': expected a list of "
                             f"objects, got {value!r}.\n")
                ok = False
        elif not isinstance(value, dict):
            if key in mode_ignored:
                continue  # never inspected for this input mode (see above)
            if key in ("multiview", "stereopair_settings") and \
                    hasattr(value, "__len__") and len(value) == 0:
                continue  # vacuously valid under the reference's iteration
            logger.error(f"Invalid section '{key}': expected an object, "
                         f"got {value!r}.\n")
            ok = False
    return ok


def validate_cfg_file(cfg_file, logger=None) -> bool:
    """Validate a user training configuration. Returns True when clean."""
    if logger is None:
        logger = setup_logger("validate_cfg_file", log_to_console=True, log_file=None)

    if isinstance(cfg_file, dict):
        cfg_user = AttrDict(copy.deepcopy(dict(cfg_file)))
    else:
        cfg_user = io.read_json(cfg_file)

    if not all_keys_known(cfg_user, schema.PRIMARY_KEYS, logger):
        return False

    missing = [k for k in schema.PRIMARY_KEYS_MANDATORY if k not in cfg_user]
    if missing:
        logger.error("The following keys are missing: {}.\n".format(
            ",".join(f"'{k}'" for k in missing)))
        return False

    if not _sections_well_typed(cfg_user, logger):
        return False

    ok = True
    for section, check, always in _SECTION_CHECKS:
        if always or section in cfg_user:
            title = f"Verify '{section}' arguments"
            logger.info("{}\n{}\n".format(title, "-" * len(title)))
            if not check(cfg_user, logger):
                ok = False
    return ok


def augment_dataset_args(cfg_user) -> None:
    """Fill per-dataset optional keys from global/default settings (in-place).

    Reference behaviour (lib/validate_cfg_training.py:114-156): for each
    dataset, 'n_training_samples' comes from training_settings, and
    'allocation_strategy'/'test_stripe' from general — user values win over
    defaults. 'n_training_samples' is skipped for non-training datasets and
    'test_stripe' for 'entire' allocation.
    """
    defaults = default_cfg()
    settings = {}
    training = cfg_user.get("training_settings", {})
    general = cfg_user.get("general", {})
    settings["n_training_samples"] = training.get(
        "n_training_samples", defaults.training_settings.n_training_samples)
    settings["allocation_strategy"] = general.get(
        "allocation_strategy", defaults.general.allocation_strategy)
    settings["test_stripe"] = general.get("test_stripe", defaults.general.test_stripe)

    for dataset in cfg_user.datasets:
        for key, value in settings.items():
            if key == "n_training_samples" and "train" not in dataset.get("area_type", ""):
                continue
            if key == "test_stripe" and dataset.get("allocation_strategy") == "entire":
                continue
            if key not in dataset:
                dataset[key] = value
