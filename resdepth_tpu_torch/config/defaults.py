"""Default configuration tree.

Mirrors the defaults of the reference's lib/config.py:7-152 section by
section, and adds a ``tpu`` section with framework-native defaults. The tree
is produced by a factory (not a module-level mutable global) so callers always
start from pristine defaults.

The port's copy of ``resdepth_tpu/config/defaults.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

from __future__ import annotations

from resdepth_tpu_torch.utils.attrdict import AttrDict


def default_cfg() -> AttrDict:
    cfg = AttrDict()

    # Model architecture (reference defaults: lib/config.py:11-54)
    cfg.model = AttrDict(
        name="UNet",
        input_channels="geom-stereo",
        depth=5,
        outer_skip=True,
        outer_skip_BN=False,
        start_kernel=64,
        act_fn_encoder="relu",
        act_fn_decoder="relu",
        act_fn_bottleneck="relu",
        up_mode="transpose",
        do_BN=True,
        bias_conv_layer=True,
        # Exposed in the TPU build; hard-coded to 512 in the reference
        # (lib/UNet.py:152-155, not listed in lib/arguments.py:14-16).
        max_filter_depth=512,
    )

    # Multi-view input configuration (lib/config.py:58)
    cfg.multiview = AttrDict(config="3-view")

    # Stereo-pair sample construction (lib/config.py:65-70)
    cfg.stereopair_settings = AttrDict(
        use_all_stereo_pairs=True,
        permute_images_within_pair=True,
    )

    # Training settings (lib/config.py:77-93)
    cfg.training_settings = AttrDict(
        n_training_samples=20000,
        tile_size=256,
        augment=True,
        batch_size=20,
        n_epochs=2000,
        loss="L1",
    )

    # Optimizer (lib/config.py:97-103)
    cfg.optimizer = AttrDict(
        name="Adam",
        learning_rate=2e-4,
        weight_decay=1e-5,
    )

    # LR scheduler (lib/config.py:107-114)
    cfg.scheduler = AttrDict(
        enabled=True,
        name="StepLR",
        settings=AttrDict(),
    )

    # General settings (lib/config.py:127-145)
    cfg.general = AttrDict(
        allocation_strategy="5-crossval_vertical",
        test_stripe=0,
        workers=4,  # vestigial: accepted for reference-config compatibility, unused (no host DataLoader worker pool exists)
        random_seed=0,
        save_model_rate=20,
        evaluate_rate=1,
    )

    # Output artifacts (lib/config.py:149-152)
    cfg.output = AttrDict(
        suffix="",
        plot_model_txt=False,
    )

    # TPU-native framework settings (no reference counterpart).
    cfg.tpu = AttrDict(
        compute_dtype="float32",
        train_precision="high",  # 'high' (f32 parity) | 'default' (bf16 MXU
                                 # passes, +65% measured: 463 vs 280
                                 # samples/sec) | 'highest' | 'balanced'
                                 # ('default' + 3-pass HIGH first/last convs,
                                 # 374 samples/sec) | 'balanced16' (bf16
                                 # activation trunk with full-fidelity
                                 # endpoints, 602 samples/sec = 2.05x 'high',
                                 # 86% of full-bf16 speed);
                                 # compute_dtype='bfloat16' additionally uses
                                 # bf16 activation storage: fastest training
                                 # (708 samples/sec, 2.5x 'high'), ~1%
                                 # refined-MAE cost at equal steps
                                 # (BASELINE.md round-2 re-study)

        data_parallel=True,
        mesh_axis="data",
        dcn_slices=1,  # >1: 2-D (dcn, ici) mesh — multi-slice data parallelism
        distributed=False,  # true: jax.distributed.initialize() via cluster
                            # auto-detection (multi-host launches); explicit
                            # RESDEPTH_DIST_* env vars work on any backend
                            # (parallel/bootstrap.py)
        use_pallas=True,
        steps_per_call=8,  # optimizer steps fused into one jitted dispatch
                           # (lax.scan). Semantically identical to 1
                           # (tested); amortizes dispatch latency (measured
                           # K-scan in BASELINE.md). Epoch tails shorter
                           # than K fall back to per-step dispatch.
        profile_dir="",
        donate_state=True,
        remat=False,  # jax.checkpoint the train-step conv blocks
                      # (gradient-identical recompute-vs-store trade;
                      # measured A/B in BASELINE.md round 3)
    )

    return cfg
