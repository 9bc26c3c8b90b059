"""Config key registry and enumerations of valid values.

Functional parity with the reference's lib/arguments.py:1-59 — the allowed
keys per config section for training and inference, plus the enumerations of
valid architectures, optimizers, schedulers, losses, activations,
input-channel modes, and allocation strategies. The TPU build adds a few
framework-native knobs (precision, mesh, pallas) in their own sections.

The port's copy of ``resdepth_tpu/config/schema.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

# ------------------------------- Training ------------------------------- #

PRIMARY_KEYS = [
    "datasets", "model", "multiview", "stereopair_settings", "training_settings",
    "optimizer", "scheduler", "general", "output",
    # TPU-native extensions
    "tpu",
]

PRIMARY_KEYS_MANDATORY = ["datasets", "output"]

DATASET_KEYS_MANDATORY_train = ["raster_gt", "raster_in", "area_type"]
DATASET_KEYS_OPTIONAL = [
    "name", "path_image_list", "path_pairlist_training", "path_pairlist_validation",
    "n_training_samples", "allocation_strategy", "test_stripe", "crossval_training",
]

MODEL_KEYS = [
    "name", "input_channels", "depth", "start_kernel", "act_fn_encoder",
    "act_fn_decoder", "act_fn_bottleneck", "up_mode", "do_BN", "bias_conv_layer",
    "outer_skip", "outer_skip_BN", "pretrained_path",
    # TPU-native extension: configurable filter-width cap (fixed at 512 in the
    # reference, the reference's lib/UNet.py:152-155).
    "max_filter_depth",
]

MULTIVIEW_KEYS = ["config"]

STEREO_KEYS = ["use_all_stereo_pairs", "permute_images_within_pair"]

TRAINING_KEYS = ["n_training_samples", "tile_size", "augment", "loss", "batch_size", "n_epochs",
                 "ema_decay"]  # opt-in exponential moving average of the
                               # weights (0 = off): validation, checkpoints
                               # and serving use the EMA model; the raw
                               # optimizer iterate is kept for exact resume
                               # (train/step.py; measured gains in
                               # BASELINE.md). No reference analogue.

OPTIMIZER_KEYS = ["name", "learning_rate", "weight_decay"]

SCHEDULER_KEYS = ["enabled", "name", "settings"]

GENERAL_KEYS = [
    "allocation_strategy", "test_stripe", "workers", "random_seed",
    "save_model_rate", "evaluate_rate",
    # TPU-native extension: resume from the newest prior run automatically
    "auto_resume",
]

OUTPUT_KEYS = ["output_directory", "tboard_log_dir", "suffix", "plot_model_txt"]

TPU_KEYS = [
    "train_precision",      # MXU precision for training convs
    "compute_dtype",        # 'float32' | 'bfloat16' | 'mixed' | 'balanced' |
                            # 'balanced16' — model compute precision
                            # ('mixed': bf16 conv stack, f32 height path;
                            # 'balanced': f32 storage, 1-pass bf16 MXU trunk,
                            # 3-pass first+last convs; 'balanced16': the
                            # balanced recipe on a bf16 trunk — near-bf16
                            # speed, sub-0.5 cm deviation; serving modes are
                            # eval-only)
    "data_parallel",        # bool — shard batches over the device mesh
    "mesh_axis",            # name of the data-parallel mesh axis
    "dcn_slices",           # >1: outer DCN axis of a 2-D device mesh
    "distributed",          # bool — multi-host process bootstrap
                            # (jax.distributed cluster auto-detection)
    "use_pallas",           # bool — enable fused Pallas kernels where available
    "steps_per_call",       # optimizer steps per jitted dispatch (lax.scan)
    "remat",                # bool — jax.checkpoint the conv blocks in the
                            # train step (recompute instead of store block
                            # activations; gradient-identical)
    "profile_dir",          # jax.profiler trace output directory ('' = off)
    "donate_state",         # donate train-state buffers in the jitted step
    "max_device_pixels",    # per-device resident raster pixel budget:
                            # regions over it train via banded residency
                            # (data/banded.py; one band window in HBM at a
                            # time, rasters stay in host RAM). 0/absent =
                            # fully resident. Sizing: docs/SCALING.md.
]

# ------------------------------- Inference ------------------------------ #

PRIMARY_KEYS_eval = ["datasets", "model", "general", "output"]

DATASET_KEYS_MANDATORY_eval = ["raster_in"]
DATASET_KEYS_OPTIONAL_eval = [
    "name", "raster_gt", "path_image_list", "path_pairlist", "mask_ground_truth",
    "mask_building", "mask_water", "mask_forest", "allocation_strategy",
    "test_stripe", "area_type", "crossval_training",
]
MODEL_KEYS_eval = ["weights", "architecture", "normalization_geom", "normalization_image"]
GENERAL_KEYS_eval = ["tile_size", "workers", "batch_size", "compute_dtype",
                     "data_parallel",
                     "use_pallas",
                     "tile_stride",  # opt-in tile-grid stride (default
                                     # tile_size/2 — the reference's fixed
                                     # overlap, lib/DsmOrthoDataset.py:99-100;
                                     # larger strides trade seam blending for
                                     # up to ~4x less compute per scene)
                     "tta",          # opt-in dihedral test-time augmentation
                                     # count {1,2,4,8}: average predictions
                                     # over a spatial-symmetry subgroup at
                                     # tta x model compute (infer/tiled.py;
                                     # accuracy trade in BASELINE.md)
                     "tta_merge",    # how tta predictions merge per tile:
                                     # "mean" (default) | "median"
                     "serving_preset"]  # named knob bundle: "parity"
                                     # (default: reference tiling, tta off)
                                     # | "throughput" (stride 3*tile/4,
                                     # tta off: 0.61x parity wall time at
                                     # +0.08 cm — round-4 grid cell)
                                     # | "accuracy" (stride 3*tile/4 +
                                     # tta 4: full TTA-4 gain at 1.43x
                                     # parity wall time, BASELINE.md).
                                     # Explicit tile_stride/tta keys
                                     # override the preset's members.
OUTPUT_KEYS_eval = ["directory"]

# ------------------------------ Valid values ---------------------------- #

DATASET_AREA_TYPES = ["train", "val", "train+val"]
DATASET_AREA_TYPES_eval = ["train", "val", "test"]
INPUT_CHANNELS = ["geom-multiview", "geom-stereo", "geom-mono", "stereo", "geom"]
MULTIVIEW_CONFIG = ["3-view", "4-view", "5-view"]
OPTIMIZERS = ["Adam", "SGD"]
SCHEDULERS = ["ReduceLROnPlateau", "StepLR", "ExponentialLR"]
LOSSES = ["L1"]
ARCHITECTURES = ["UNet"]
ACTIVATION_FUNCTIONS = ["relu", "lrelu", "prelu"]
UPSAMPLING_MODES = ["transpose", "bilinear"]
ALLOCATION_STRATEGIES = ["5-crossval_vertical", "5-crossval_horizontal", "entire"]
COMPUTE_DTYPES = ["float32", "bfloat16", "mixed", "balanced", "balanced16"]
SERVING_PRESETS = ["parity", "throughput", "accuracy"]
TRAIN_PRECISIONS = ["high", "default", "highest", "balanced", "balanced16"]


def n_views(multiview_config: str) -> int:
    """'3-view' -> 3 (shared parser for the multiview config string)."""
    return int("".join(ch for ch in multiview_config if ch.isdigit()))


def count_input_channels(input_channels: str, multiview_config: str = "3-view") -> int:
    """Number of network input channels for a channel mode.

    Parity with the reference's lib/utils.py:758-779.
    """
    if input_channels == "geom":
        return 1
    if input_channels in ("stereo", "geom-mono"):
        return 2
    if input_channels == "geom-stereo":
        return 3
    if input_channels == "geom-multiview":
        return n_views(multiview_config) + 1
    raise ValueError(f"Unknown input channel configuration: {input_channels!r}")
