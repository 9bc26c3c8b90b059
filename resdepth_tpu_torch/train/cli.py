"""Train a residual DSM refinement UNet: the port of ``train.py``.

    python -m resdepth_tpu_torch.train config.json [--device {cuda,cpu}]

Reads the same JSON config as ``train.py`` (validated by
``config/validate_train.py``, the port's copy of the JAX validator) and
writes the same artifacts into a timestamped run directory: ``config.json`` and ``config.json.orig``,
``model_config.json``, ``DSM_normalization_parameters.p`` (and
``Image_normalization_parameters.p`` for image-guided modes), ``run.log``,
``training.log``, ``metrics.jsonl`` and ``checkpoints/{Model_best,
Model_after_{N}_epochs, Model_last}.npz`` in the JAX checkpoint layout, so
``test.py``, ``python -m resdepth_tpu_torch.predict`` and the JAX
``train.py`` (resume) all read them. Warm starts read reference ``.pth``
files (with their Adam moments) and ``.npz`` checkpoints of either package;
``general.auto_resume`` continues from the newest ``Model_last.npz`` or,
of a run that was stopped before it wrote one, ``Model_after_{N}_epochs.npz``.

Training runs on ``--device`` (default ``cuda``, which raises when CUDA is
absent). Data parallelism is one process per GPU over ``torch.distributed``
(``parallel/``): a plain launch with ``tpu.data_parallel`` (the default) on
a machine with N > 1 visible GPUs starts N processes; ``RESDEPTH_DIST_*``
(coordinator, world size, rank) or ``torchrun`` with ``tpu.distributed:
true`` or ``RESDEPTH_DISTRIBUTED=1`` launch them from outside. Each rank
trains its shard of every global batch, padded with zero-weight samples to
a multiple of the world size; ``tpu.dcn_slices`` must divide the world and
reduces over it flat. Only rank 0 writes the run directory.
``tpu.use_pallas`` and ``tpu.donate_state`` change nothing, and
``tpu.steps_per_call`` only groups the batch order as the JAX trainer does.
``tpu.train_precision`` and ``tpu.compute_dtype`` take every value
``train.py`` takes (``train.step.select_train_precision``); validation runs
the float32 policy at the compute dtype. A region whose rasters exceed
``tpu.max_device_pixels`` trains with banded residency (``data/banded.py``:
the rasters in host RAM, one window on the device at a time).
``tpu.profile_dir`` traces the first trained epoch with ``torch.profiler``
into that directory, one Chrome trace JSON file a process
(``utils/profiler.py``), as ``train.py`` traces it with ``jax.profiler``;
the trace holds the program's spans, one a step (``train#<step>``).
"""

from __future__ import annotations

import glob
import logging
import os
import shutil
import sys
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from resdepth_tpu_torch import orchestration
from resdepth_tpu_torch.config import io as cfg_io
from resdepth_tpu_torch.config import validate_train
from resdepth_tpu_torch.config.defaults import default_cfg
from resdepth_tpu_torch.data import banded, control_files, normalization
from resdepth_tpu_torch.data.dataset import TileDataset
from resdepth_tpu_torch.data.pipeline import (BatchIndexIterator, batch_spec_for,
                                              device_put_dataset)
from resdepth_tpu_torch.models import weights
from resdepth_tpu_torch.models.unet import init_unet, unet_config_from_settings
from resdepth_tpu_torch.parallel import bootstrap, mesh
from resdepth_tpu_torch.predict import resolve_device
from resdepth_tpu_torch.train import checkpoint as ckpt_io
from resdepth_tpu_torch.train.schedulers import build_scheduler
from resdepth_tpu_torch.train.step import (init_train_state, make_eval_step,
                                           make_train_step, select_train_precision)
from resdepth_tpu_torch.utils import fs
from resdepth_tpu_torch.utils.logging import setup_logger
from resdepth_tpu_torch.train.trainer import Trainer

FREQ_AVERAGE_TRAIN_LOSS = 20  # reference constant (lib/utils.py:406)

parser = ArgumentParser(description="ResDepth on PyTorch: train a residual DSM "
                                    "refinement UNet from a JSON configuration.")
parser.add_argument("config_file", type=str, help="JSON configuration file")
parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device that trains (default: cuda)")


def _build_datasets(cfg_data, cfg, strategy, dsm_std, images_mean, images_std,
                    seed, use_all_stereo_pairs, permute, augment):
    return [TileDataset(entry, input_channels=cfg.model.input_channels,
                        tile_size=cfg.training_settings.tile_size,
                        sampling_strategy=strategy, dsm_mean=None,
                        dsm_std=dsm_std, ortho_mean=images_mean,
                        ortho_std=images_std,
                        use_all_stereo_pairs=use_all_stereo_pairs,
                        permute_images_within_pair=permute, augment=augment,
                        seed=seed + i)
            for i, entry in enumerate(cfg_data)]


def _choose_mesh(batch_size: int, data_parallel: bool, dcn_slices: int = 1):
    """The data-parallel group over every process of the run and the
    emitted batch size: ``batch_size`` padded with zero-weight samples to a
    multiple of the world size, so every rank takes an equal shard and the
    trajectory is that of ``batch_size`` (``train.py::_choose_mesh``). One
    process: no group. ``tpu.data_parallel`` false under several processes
    raises (each would train alone)."""
    world = mesh.device_count()
    if not data_parallel and world > 1:
        raise ValueError(f"tpu.data_parallel is false in a run of {world} processes")
    emit_size = mesh.pad_to_multiple(batch_size, world)
    if dcn_slices > 1:
        return mesh.data_mesh_2d(dcn_slices, world), emit_size
    return mesh.data_mesh(world), emit_size


def _mesh_shape(group, dcn_slices: int = 1) -> dict:
    """The JAX mesh's shape for the log line: ``{'data': N}``, or
    ``{'dcn': S, 'data': N / S}``."""
    n = mesh.size(group)
    if dcn_slices > 1:
        return {mesh.DCN_AXIS: dcn_slices, mesh.DATA_AXIS: n // dcn_slices}
    return {mesh.DATA_AXIS: n}


def _warm_start_artifacts(pretrained_path, output_dir, checkpoint_dir,
                          tboard_log_dir):
    """Copy a prior run's artifacts into the new run directory
    (lib/utils.py:415-436, as ``train.py`` does)."""
    experiment_dir = Path(pretrained_path).parent.parent
    for prior_tboard in (experiment_dir / "logs" / experiment_dir.name,
                         experiment_dir.parent / "logs" / experiment_dir.name):
        if prior_tboard.is_dir():
            for tb_file in prior_tboard.glob("events.*"):
                shutil.copy(tb_file, Path(tboard_log_dir) / tb_file.name)
            break
    prior_log = experiment_dir / "training.log"
    if prior_log.exists():
        shutil.copy(prior_log, os.path.join(output_dir, "training.log"))
    for name in ("Model_best.npz", "Model_best.pth"):
        prior_best = Path(pretrained_path).parent / name
        if prior_best.exists():
            shutil.copy(prior_best, Path(checkpoint_dir) / name)
            break


def restore(state, path: str, config, optimizer_name: str, logger) -> dict:
    """Load a warm start into ``state`` (in place); returns its metadata.

    A ``.pth`` is a reference checkpoint: weights, and for Adam its moments.
    Anything else is an ``.npz`` checkpoint: weights, BatchNorm statistics,
    optimizer state and, under an EMA, the raw iterate, from which training
    continues (an enabled EMA restarts from the served weights)."""
    model = state.model
    if path.endswith(".pth"):
        logger.info(f"Importing reference checkpoint: {path}")
        sd, adam, meta = weights.read_reference_checkpoint(
            path, want_adam=optimizer_name == "Adam")
        model.load_state_dict(sd)
        if adam is not None:
            weights.adam_state_from_state_dicts(model, state.optimizer, *adam)
            logger.info("Restored Adam optimizer moments from the reference "
                        "checkpoint.")
    else:
        logger.info(f"Restoring checkpoint: {path}")
        loaded = ckpt_io.load_checkpoint(path)
        meta = loaded["meta"]
        served = weights.state_dict_from_jax_params(loaded["params"],
                                                    loaded["bn_state"], config)
        iterate = dict(served)
        if loaded["raw_params"] is not None:
            iterate.update(weights.state_dict_from_jax_params(
                loaded["raw_params"], None, config))
        model.load_state_dict(iterate)
        if state.ema_model is not None:
            state.ema_model.load_state_dict(served)
        if optimizer_name == "Adam" and loaded["adam"] is not None:
            weights.adam_moments_from_jax(model, state.optimizer, config,
                                          *loaded["adam"])
    if state.ema_model is not None and path.endswith(".pth"):
        state.ema_model.load_state_dict(model.state_dict())
    return meta


def _close_file_handlers(logger: logging.Logger) -> None:
    for handler in list(logger.handlers):
        if isinstance(handler, logging.FileHandler):
            logger.removeHandler(handler)
            handler.close()


def main(argv=None, *, draw_factory=None) -> Trainer | None:
    """Run the CLI; returns the finished Trainer (its ``val_history`` holds
    the val MAE of each validated epoch), or None where this process only
    started one process per GPU (``parallel.bootstrap.launch_per_gpu``).
    ``draw_factory``, for a caller in this process: the ``Trainer``'s
    source of augmentation and permutation draws (default: its seeded
    generators)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    cfg_file = args.config_file

    title = "Running ResDepth (PyTorch): Training"
    print("\n{}\n{}\n".format(title, "=" * len(title)))

    # The env-triggered process group forms before the first CUDA access.
    bootstrap.maybe_initialize_distributed(device=args.device)
    if not fs.file_exists(cfg_file):
        print(f"ERROR: Cannot find the configuration file: {cfg_file}")
        sys.exit(1)
    cfg_user = cfg_io.read_json(cfg_file)
    if not cfg_user:
        sys.exit(1)
    tpu = cfg_user.get("tpu") or {}
    bootstrap.maybe_initialize_distributed(tpu, device=args.device)
    n_gpus = bootstrap.plain_launch_size(args.device, tpu.get("data_parallel", True))
    if n_gpus > 1:
        print(f"{n_gpus} GPUs: one training process each")
        bootstrap.launch_per_gpu("resdepth_tpu_torch.train.cli", argv, n_gpus)
        return None

    # Only the chief makes the run directory; every rank learns its name.
    chief = bootstrap.is_chief()
    output_directory = bootstrap.broadcast_object(
        orchestration.create_output_directory(cfg_user) if chief else None)
    log_file = (os.path.join(output_directory, "run.log")
                if output_directory and chief else None)
    logger = setup_logger("root_logger", level=logging.INFO if chief else logging.WARNING,
                          log_to_console=True, log_file=log_file)
    try:
        return _train(args, cfg_file, cfg_user, output_directory, logger, draw_factory)
    finally:
        # Loggers are process-wide: a later run in this process must not
        # write into this run's files.
        for name in ("root_logger", "train_logger"):
            _close_file_handlers(logging.getLogger(name))


def _train(args, cfg_file, cfg_user, output_directory, logger,
           draw_factory=None) -> Trainer:
    logger.info(f"Validate the configuration file:\t{cfg_file}\n\n")
    if validate_train.validate_cfg_file(cfg_user, logger) is False:
        sys.exit(1)
    validate_train.augment_dataset_args(cfg_user)

    cfg = cfg_io.merge(default_cfg(), cfg_user)
    cfg_io.remove_obsolete_keys(cfg)
    cfg.output.output_directory = output_directory
    tboard_root = cfg.output.get("tboard_log_dir",
                                 os.path.join(output_directory, "logs"))
    cfg.output.tboard_log_dir = os.path.join(tboard_root,
                                             os.path.basename(output_directory))

    logger.info("\n\nSettings\n--------\n")
    cfg_io.print_json(cfg, logger=logger)

    seed = cfg.general.random_seed if cfg.general.random_seed is not None else 0
    np.random.seed(seed)

    chief = bootstrap.is_chief()
    device = resolve_device(args.device)
    train_precision = cfg.tpu.get("train_precision") or "high"
    policy, compute_dtype = select_train_precision(
        train_precision, cfg.tpu.get("compute_dtype"), device)
    logger.info(f"Device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})"
                   if device.type == "cuda" else "")
                + f", train_precision {train_precision}, compute_dtype "
                f"{str(compute_dtype).removeprefix('torch.')} (TF32 off)")

    # --------------------- data allocation & pair lists --------------------- #
    logger.info("\n\n\nData initialization\n-------------------\n")
    if cfg.model.input_channels != "geom":
        logger.info("Read image pairs...\n")
        if orchestration.read_image_pairs(cfg, logger) is False:
            sys.exit(1)
    logger.info("Perform data allocation...\n")
    orchestration.allocate_area(cfg)

    cfg_traindata = orchestration.prepare_dataset_configuration(cfg, "train")
    cfg_valdata = orchestration.prepare_dataset_configuration(cfg, "val")

    # --------------------------- normalization ---------------------------- #
    logger.info("\n\nData normalization\n-------------------\n")
    logger.info("Compute standard deviation over all centered DSM training patches...\n")
    # The sigma pass reads only the DSM band: geom-mode datasets, so the
    # ortho stacks are not decoded twice.
    norm_entries = [
        {k: entry[k] for k in ("name", "raster_gt", "raster_in", "area_defn",
                               "n_samples") if k in entry}
        for entry in cfg_traindata]
    norm_cfg = cfg.copy()
    norm_cfg.model.input_channels = "geom"
    norm_datasets = _build_datasets(norm_entries, norm_cfg, "train", 1.0, None,
                                    None, seed, False, False, False)
    all_stds = np.concatenate([
        normalization.patch_stds_from_positions(
            ds.dsm_input, ds.nodata, ds.positions, ds.tile_size)
        for ds in norm_datasets])
    dsm_std = normalization.robust_mean_std(all_stds)
    logger.info("Standard deviation:\t{:.3f} m\n".format(dsm_std))
    del norm_datasets

    if cfg.model.input_channels != "geom":
        logger.info("\nCompute satellite image normalization parameters...\n")
        images_mean, images_std = normalization.compute_satellite_image_normalization(
            cfg_traindata)
        logger.info("Mean:\t\t\t{:.3f}".format(images_mean))
        logger.info("Standard deviation:\t{:.3f}\n".format(images_std))
    else:
        images_mean, images_std = None, None

    # ------------------------------ datasets ------------------------------- #
    logger.info("\nInitialize data pipelines...\n")
    train_datasets = _build_datasets(
        cfg_traindata, cfg, "train", dsm_std, images_mean, images_std, seed,
        cfg.stereopair_settings.use_all_stereo_pairs,
        cfg.stereopair_settings.permute_images_within_pair,
        cfg.training_settings.augment)
    val_datasets = _build_datasets(
        cfg_valdata, cfg, "val", dsm_std, images_mean, images_std, seed,
        True, False, False)

    # ---------------------- device raster residency ------------------------ #
    # Regions over tpu.max_device_pixels train with banded residency: host-RAM
    # rasters, one window on the device at a time (docs/SCALING.md sizes the
    # budget).
    max_device_pixels = int(cfg.tpu.get("max_device_pixels", 0) or 0)
    resident_px = sum(banded.resident_pixels(ds)
                      for ds in train_datasets + val_datasets)
    logger.info(f"Device-resident raster estimate: {resident_px:,} px "
                f"({resident_px * 4 / 2**30:.2f} GiB f32)")
    if max_device_pixels:
        logger.info(f"tpu.max_device_pixels: {max_device_pixels:,} "
                    f"({max_device_pixels * 4 / 2**30:.2f} GiB f32): regions "
                    "over the budget use banded residency")
    elif device.type == "cuda":
        memory = torch.cuda.mem_get_info(device)[1]
        if resident_px * 4 > memory // 2:
            logger.warning(
                f"Resident rasters ({resident_px * 4 / 2**30:.2f} GiB) exceed "
                f"half of device memory ({memory / 2**30:.2f} GiB); set "
                "tpu.max_device_pixels to train with banded residency "
                "(docs/SCALING.md) if the run runs out of memory.")

    def over_budget(ds) -> bool:
        return bool(max_device_pixels) and banded.resident_pixels(ds) > max_device_pixels

    banded_train = any(map(over_budget, train_datasets))

    # ----------------------- run artifacts / control files ----------------- #
    # Only the chief writes (every rank computes the same values).
    logger.info("\nPrepare output folders and files\n--------------------------------\n")
    cfg.output.checkpoint_dir = os.path.join(output_directory, "checkpoints")
    if chief:
        fs.make_dir(cfg.output.checkpoint_dir)
        fs.make_dir(cfg.output.tboard_log_dir)
    logger.info(f"\nModel weights will be stored in:\n{cfg.output.checkpoint_dir}\n")

    cfg.output.dsm_normalization = os.path.join(
        output_directory, "DSM_normalization_parameters.p")
    if chief:
        control_files.write_normalization_params_to_file(
            cfg.output.dsm_normalization, None, dsm_std)
    logger.info(f"Writing DSM normalization parameters to file:\n"
                f"{cfg.output.dsm_normalization}\n")
    if cfg.model.input_channels != "geom":
        cfg.output.satellite_image_normalization = os.path.join(
            output_directory, "Image_normalization_parameters.p")
        if chief:
            control_files.write_normalization_params_to_file(
                cfg.output.satellite_image_normalization, images_mean, images_std)
        logger.info(f"Writing satellite image normalization parameters to file:\n"
                    f"{cfg.output.satellite_image_normalization}\n")

    if chief:
        cfg_io.write_json(cfg, os.path.join(output_directory, "config.json"))
        cfg_io.write_json(cfg_user, os.path.join(output_directory, "config.json.orig"))

    # -------------------------------- model -------------------------------- #
    logger.info("\nPrepare training\n----------------\n")
    args_model = orchestration.collect_model_args(cfg)
    if chief:
        cfg_io.write_json(args_model, os.path.join(output_directory, "model_config.json"))
    model_config = unet_config_from_settings(args_model.settings)
    model = init_unet(model_config, torch.Generator().manual_seed(seed), device)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"UNet parameters: {n_params:,}")
    if cfg.output.get("plot_model_txt") and chief:
        path = os.path.join(output_directory, "model_parameters.txt")
        with open(path, "w") as f:
            f.write(f"{model}\n\ntotal parameters: {n_params:,}\n\n"
                    f"UNetConfig: {model_config}\n")
        logger.info(f"Writing model architecture to file: {path}\n")

    scheduler = build_scheduler(cfg.scheduler, cfg.optimizer.learning_rate)
    ema_decay = float(cfg.training_settings.get("ema_decay", 0) or 0)
    if ema_decay:
        logger.info(f"Weight EMA enabled: decay {ema_decay}")
    state = init_train_state(model, cfg.optimizer.name, cfg.optimizer.learning_rate,
                             cfg.optimizer.weight_decay, ema=ema_decay > 0)

    # ------------------------------ warm start ----------------------------- #
    pretrained_path = cfg.model.get("pretrained_path")
    if not pretrained_path and cfg.general.get("auto_resume"):
        # A stopped run's newest epoch checkpoint is a resume point too; a
        # finished run's Model_last.npz is written after its last one.
        candidates = sorted(
            (path for name in ("Model_last.npz", "Model_after_*_epochs.npz")
             for path in glob.glob(os.path.join(cfg_user.output.output_directory,
                                                "*", "checkpoints", name))),
            key=lambda path: (os.path.getmtime(path), path.endswith("Model_last.npz")))
        if candidates:
            pretrained_path = candidates[-1]
            logger.info(f"auto_resume: continuing from {pretrained_path}")
    resume_meta = None
    if pretrained_path:
        resume_meta = restore(state, pretrained_path, model_config,
                              cfg.optimizer.name, logger)
        if chief:
            _warm_start_artifacts(pretrained_path, output_directory,
                                  cfg.output.checkpoint_dir, cfg.output.tboard_log_dir)

    # -------------------------------- steps -------------------------------- #
    batch_size = cfg.training_settings.batch_size
    group, emit_size = _choose_mesh(batch_size, cfg.tpu.data_parallel,
                                    cfg.tpu.get("dcn_slices", 1))
    logger.info(f"Data-parallel mesh: {_mesh_shape(group, cfg.tpu.get('dcn_slices', 1))}"
                + (f" (batch {batch_size} zero-weight-padded to {emit_size})"
                   if emit_size != batch_size else ""))
    # Sample weights enter the BatchNorm statistics only when a batch can
    # carry zero-weight padding (padding to the world size, a region whose
    # size the batch does not divide, or a band's tail); with full batches
    # the two are the same.
    weighted_bn = (emit_size != batch_size
                   or any(len(ds) % batch_size != 0 for ds in train_datasets)
                   or banded_train)
    steps_per_call = cfg.tpu.get("steps_per_call", 1)
    train_step = make_train_step(batch_spec_for(train_datasets[0]),
                                 weighted_bn=weighted_bn,
                                 remat=cfg.tpu.get("remat", False),
                                 ema_decay=ema_decay, compute_dtype=compute_dtype,
                                 group=group, **policy)
    # Validation runs the float32 policy at the compute dtype, whatever the
    # training precision, as train.py validates.
    eval_step = make_eval_step(batch_spec_for(val_datasets[0]), compute_dtype, group)

    def loaders(datasets, shuffle, seed_base, label):
        out = []
        for i, ds in enumerate(datasets):
            if over_budget(ds):
                try:
                    sub = banded.make_banded_loaders(
                        ds, batch_size, max_device_pixels=max_device_pixels,
                        seed=seed_base + i, device=device, shuffle=shuffle,
                        emit_size=emit_size)
                except ValueError as exc:
                    logger.error(f"{label} region {i}: {exc}\n")
                    sys.exit(1)
                logger.info(f"{label} region {i}: {banded.resident_pixels(ds):,} "
                            f"px > budget: banded residency, {len(sub)} bands")
                out.extend(sub)
            else:
                out.append((device_put_dataset(ds, device, include_target=True),
                            BatchIndexIterator(ds, batch_size, shuffle=shuffle,
                                               seed=seed_base + i,
                                               emit_size=emit_size)))
        return out

    hparams = {
        "batch_size": batch_size,
        "lr_initial": cfg.optimizer.learning_rate,
        "optimizer": cfg.optimizer.name,
        "scheduler": cfg.scheduler.name if cfg.scheduler.enabled else "None",
        "patience": cfg.scheduler.settings.get("patience", -1),
        "step_size": cfg.scheduler.settings.get("step_size", -1),
    }
    trainer = Trainer(
        state=state, train_step=train_step, eval_step=eval_step,
        steps_per_call=steps_per_call,
        train_loaders=loaders(train_datasets, True, seed + 1000, "train"),
        val_loaders=loaders(val_datasets, False, 0, "val"),
        scheduler=scheduler, n_epochs=cfg.training_settings.n_epochs,
        evaluate_rate=cfg.general.evaluate_rate,
        save_model_rate=cfg.general.save_model_rate,
        freq_average_train_loss=FREQ_AVERAGE_TRAIN_LOSS,
        checkpoint_dir=cfg.output.checkpoint_dir,
        log_file=os.path.join(output_directory, "training.log"),
        tboard_log_dir=cfg.output.tboard_log_dir,
        metrics_jsonl=os.path.join(output_directory, "metrics.jsonl"),
        hparams=hparams, rng_seed=seed,
        # Each band's batches together: one window upload a band an epoch.
        group_chunks_by_loader=banded_train,
        profile_dir=cfg.tpu.get("profile_dir") or None, draw_factory=draw_factory)

    if resume_meta is not None:
        trainer.resume_from(resume_meta)
    else:
        trainer.logger.info("\nStart training from scratch.\n")
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
