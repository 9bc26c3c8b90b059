"""Training engine: epoch loop, validation, checkpoints, metrics (port of
``resdepth_tpu/train/trainer.py``).

As in the JAX package and the reference:
  * per epoch a train pass over every training region, validation every
    ``evaluate_rate`` epochs on the served (EMA) weights, the denormalised
    masked MAE in meters as the one metric;
  * the train metric averaged and logged every ``freq_average_train_loss``
    iterations;
  * the best, periodic and last checkpoint roles, the LR scheduler stepped
    once per validation epoch;
  * resume bookkeeping (start epoch, best loss, scheduler, lr);
  * the periodic save reuses the latest val loss (or None) instead of
    crashing when it precedes the first validation (the reference's quirk).

Batch order is the JAX trainer's: each region's batches are grouped into
``steps_per_call`` chunks and the chunks shuffled by
``np.random.default_rng(rng_seed)``, so the same seed visits the same
batches in the same order. Under banded residency (``data/banded.py``) a
loader is one raster window: ``group_chunks_by_loader`` keeps each
loader's chunks together, so an epoch uploads each window once.
Augmentation draws from a ``torch.Generator`` on the device
(``data.pipeline.GeneratorDraws``), seeded from ``(rng_seed, epoch)``
and, past rank 0, the process's rank, so a resumed run draws as an
uninterrupted one would; a ``draw_factory`` replaces it with the draw
source it gives for ``(epoch, rank)``. Per-step metrics stay on the
device until a logging point.

A run that resumes from an epoch's checkpoint (``Model_last.npz``, or
``Model_after_{N}_epochs.npz`` of a run that was stopped) first replays
the batch order of the epochs before its start (``_epoch_chunks`` of
each, with no step run), so it trains the batches an uninterrupted run
would: with the per-epoch augmentation seeds, the resumed run is the
uninterrupted one, bit for bit on the same hardware.

With ``profile_dir`` the first trained epoch runs under
``utils.profiler.trace`` (as the JAX trainer traces it); validation is not
traced. Each step's call runs under ``step_annotation("train", step)``,
``step`` the run's 0-based step index: whenever a profiler is on
(``profile_dir``'s trace, or a caller's own), the trace and the span store
(``utils/profiler.py``) hold these spans, so a step's host time (the time
to enqueue it) and the loop's time between steps can be read; with none
on they record nothing. Tracing changes no result.

Under a multi-process launch (``parallel.bootstrap``) every process runs
every step and every validation (the steps' all-reduces need all of them),
and only the chief writes: checkpoints, metrics, ``training.log`` and the
console lines; the others log warnings and errors alone.
"""

from __future__ import annotations

import logging
import math
import os
import time

import numpy as np
import torch

from resdepth_tpu_torch.data.pipeline import GeneratorDraws
from resdepth_tpu_torch.models.weights import (adam_moments_to_jax,
                                               jax_params_from_state_dict)
from resdepth_tpu_torch.parallel.bootstrap import is_chief, process_index
from resdepth_tpu_torch.train import checkpoint as ckpt_io
from resdepth_tpu_torch.train.metrics import AverageMeter, MetricsWriter
from resdepth_tpu_torch.train.step import TrainState
from resdepth_tpu_torch.utils import fs, profiler
from resdepth_tpu_torch.utils.logging import setup_logger


def epoch_seed(rng_seed: int, epoch: int, rank: int = 0) -> int:
    """Seed of an epoch's augmentation generator on the process of ``rank``
    (rank 0 draws as one process does)."""
    entropy = [rng_seed, epoch] + ([rank] if rank else [])
    return int(np.random.SeedSequence(entropy).generate_state(1)[0])


def checkpoint_trees(state: TrainState) -> dict:
    """``save_checkpoint``'s trees from a TrainState, as host numpy in the
    JAX layout: ``params`` the served weights, ``raw_params`` the iterate
    under an EMA, ``opt_state`` the optax leaves. Copies to the host."""
    config = state.model.config
    params, bn_state = jax_params_from_state_dict(state.serve_model().state_dict(),
                                                  config)
    raw = None
    if state.ema_model is not None:
        raw = jax_params_from_state_dict(
            dict(state.model.named_parameters()), config)[0]
    adam = (adam_moments_to_jax(state.model, state.optimizer, config)
            if state.optimizer_name == "Adam" else None)
    return {"params": params, "bn_state": bn_state, "raw_params": raw,
            "opt_state": ckpt_io.opt_state_leaves(state.optimizer_name,
                                                  state.weight_decay, adam)}


class Trainer:
    def __init__(self, *, state: TrainState, train_step, eval_step,
                 steps_per_call: int = 1, train_loaders, val_loaders,
                 scheduler=None, n_epochs: int, evaluate_rate: int = 1,
                 save_model_rate: int = 20, freq_average_train_loss: int = 20,
                 checkpoint_dir: str, log_file: str | None = None,
                 tboard_log_dir: str | None = None,
                 metrics_jsonl: str | None = None, hparams: dict | None = None,
                 rng_seed: int = 0, logger: logging.Logger | None = None,
                 group_chunks_by_loader: bool = False,
                 profile_dir: str | None = None, draw_factory=None):
        """``train_loaders`` / ``val_loaders``: lists of ``(rasters,
        iterator)`` pairs, one per dataset region or raster window. Element
        0 is ``DeviceRasters`` or a provider with ``resolve()`` and
        ``release()`` (``data/banded.py``: ``BandWindow``, ``FullResident``),
        resolved per chunk; element 1 yields index batches
        (``BatchIndexIterator``). ``profile_dir``: trace the first trained
        epoch into this directory (``utils/profiler.py``). ``draw_factory``
        (None: the seeded generators): ``draw_factory(epoch, rank)`` gives
        the draw source of that epoch's steps on this process."""
        self.state = state
        self.train_step = train_step
        self.eval_step = eval_step
        self.steps_per_call = steps_per_call
        self.train_loaders = train_loaders
        self.val_loaders = val_loaders
        self.scheduler = scheduler
        self.n_epochs = n_epochs
        self.evaluate_rate = evaluate_rate
        self.save_model_rate = save_model_rate
        self.freq_average_train_loss = freq_average_train_loss
        self.group_chunks_by_loader = group_chunks_by_loader
        self.profile_dir = profile_dir
        self.draw_factory = draw_factory

        self.is_chief = is_chief()
        if self.is_chief:
            fs.make_dir(checkpoint_dir)
        self.checkpoint_dir = checkpoint_dir
        self.path_model_best = os.path.join(checkpoint_dir, "Model_best.npz")
        self.path_model_last = os.path.join(checkpoint_dir, "Model_last.npz")

        self.logger = logger or setup_logger(
            "train_logger", level=logging.INFO if self.is_chief else logging.WARNING,
            log_to_console=True, log_file=log_file if self.is_chief else None)
        self.writer = (MetricsWriter(tboard_log_dir, metrics_jsonl) if self.is_chief
                       else MetricsWriter(None, None))
        self._checkpointer = ckpt_io.AsyncCheckpointer()
        self.hparams = hparams or {}

        self.start_epoch = 0
        self.best_loss = math.inf
        self.index_best_loss = math.inf
        self.rng_seed = rng_seed
        self.epoch_rng = np.random.default_rng(rng_seed)
        self._last_val_loss = None
        self._last_train_loss = None
        self.val_history: list[tuple[int, float]] = []

    # ------------------------------ resume ------------------------------ #

    def resume_from(self, meta: dict) -> None:
        """Apply warm-start bookkeeping after the state is restored."""
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.n_epochs += self.start_epoch
        if meta.get("loss_val") is not None:
            self.best_loss = float(meta["loss_val"])
            self.index_best_loss = int(meta.get("epoch", -1))
        # Resuming from Model_last: the carried-over Model_best may hold a
        # better loss than the resumed file's, and must not be overwritten
        # by a worse model.
        if os.path.isfile(self.path_model_best):
            try:
                best_meta = ckpt_io.load_meta(self.path_model_best)
            except (OSError, KeyError, ValueError) as exc:
                self.logger.warning(
                    f"Could not read {self.path_model_best} for best-loss "
                    f"bookkeeping: {exc}")
            else:
                if best_meta.get("loss_val") is not None and \
                        float(best_meta["loss_val"]) < self.best_loss:
                    self.best_loss = float(best_meta["loss_val"])
                    self.index_best_loss = int(best_meta.get("epoch", -1))
        if self.scheduler is not None and meta.get("scheduler_state"):
            self.scheduler.load_state_dict(meta["scheduler_state"])
            self.state.lr = self.scheduler.lr
        elif meta.get("lr") is not None:
            self.state.lr = float(meta["lr"])
        self.logger.info(f"\n\nRestoring the pretrained model from epoch "
                         f"{self.start_epoch}.")
        self.logger.info(f"Current best loss {self.best_loss}\n")

    # ------------------------------ training ----------------------------- #

    def _epoch_chunks(self, loaders):
        """Each loader's batches grouped into ``steps_per_call`` chunks,
        then the chunks shuffled across loaders (the JAX trainer's order).
        With ``group_chunks_by_loader`` each loader's chunks stay
        contiguous: the chunks within each loader, then the loaders, are
        reshuffled each epoch."""
        k = self.steps_per_call
        per_loader = []
        for loader_id, (_, iterator) in enumerate(loaders):
            batches = list(iterator)
            per_loader.append([(loader_id, batches[i:i + k])
                               for i in range(0, len(batches), k)])
        if self.group_chunks_by_loader:
            for chunks in per_loader:
                self.epoch_rng.shuffle(chunks)
            self.epoch_rng.shuffle(per_loader)
            return [c for chunks in per_loader for c in chunks]
        chunks = [c for loader_chunks in per_loader for c in loader_chunks]
        self.epoch_rng.shuffle(chunks)
        return chunks

    @staticmethod
    def _resolve(rasters):
        """Loader element 0 as ``DeviceRasters``."""
        return rasters.resolve() if hasattr(rasters, "resolve") else rasters

    @staticmethod
    def _release(loaders) -> None:
        for rasters, _ in loaders:
            if hasattr(rasters, "release"):
                rasters.release()

    @staticmethod
    def _drain(pending, meter: AverageMeter) -> None:
        for value in torch.stack(pending).cpu().numpy():
            meter.update(float(value))
        pending.clear()

    def train_one_epoch(self, epoch: int) -> AverageMeter:
        """One pass over the training loaders, each step's call under
        ``profiler.step_annotation("train", step)``."""
        meter = AverageMeter()
        pending = []  # device scalars, fetched at logging points
        chunks = self._epoch_chunks(self.train_loaders)
        num_iter = sum(len(chunk) for _, chunk in chunks)
        generators = {}
        c_iter = -1
        for loader_id, chunk in chunks:
            rasters = self._resolve(self.train_loaders[loader_id][0])
            device = rasters.dsm_input.device
            if device not in generators:
                generators[device] = (
                    self.draw_factory(epoch, process_index()) if self.draw_factory
                    else GeneratorDraws(torch.Generator(device=device).manual_seed(
                        epoch_seed(self.rng_seed, epoch, process_index()))))
            for positions, pair_idx, bounds, weights in chunk:
                with profiler.step_annotation("train", num_iter * epoch + c_iter + 1):
                    pending.append(self.train_step(self.state, rasters, positions,
                                                   pair_idx, bounds, weights,
                                                   generators[device]))
                c_iter += 1
            if len(pending) >= self.freq_average_train_loss:
                self._drain(pending, meter)
                curr_iter = num_iter * epoch + (c_iter + 1)
                self.writer.add_scalar("train/MAE_metric", meter.avg, curr_iter)
                self.writer.add_scalar("train/learning_rate", self.state.lr, curr_iter)
                self.logger.info(f"train:\tEpoch: {epoch} [{c_iter + 1}/{num_iter}]\t"
                                 f"MAE_metric: {meter.avg:.6f}")
                self._last_train_loss = meter.avg
                meter.reset()
        if pending:
            self._drain(pending, meter)
        if meter.count:
            self._last_train_loss = meter.avg
        return meter

    def validate(self, epoch: int) -> float:
        meter = AverageMeter()
        model = self.state.serve_model()
        sums, counts = [], []
        # Banded residency: the train window goes before the val windows
        # come, so the budget is never held twice.
        self._release(self.train_loaders)
        for provider, iterator in self.val_loaders:
            rasters = self._resolve(provider)
            for positions, pair_idx, bounds, weights in iterator:
                num, den = self.eval_step(model, rasters, positions, pair_idx,
                                          bounds, weights)
                sums.append(num)
                counts.append(den)
        if sums:
            for num, den in zip(torch.stack(sums).cpu().numpy(),
                                torch.stack(counts).cpu().numpy()):
                if den > 0:
                    meter.update(float(num) / float(den))
        loss = meter.avg if meter.count else math.inf
        self._release(self.val_loaders)
        self.val_history.append((epoch, loss))
        self.writer.add_scalar("val/MAE_metric", loss, epoch)
        self.writer.add_scalar("val/learning_rate", self.state.lr, epoch)
        self.logger.info(f"\nval:\tEpoch: {epoch}\t\tMAE_metric: {loss:.6f}\n")
        return loss

    def _save(self, path: str, epoch: int) -> None:
        if not self.is_chief:
            return
        # Host snapshots now; the file is written in the background.
        self._checkpointer.save(
            path, epoch=epoch, **checkpoint_trees(self.state), lr=self.state.lr,
            loss_train=self._last_train_loss, loss_val=self._last_val_loss,
            scheduler_state=(self.scheduler.state_dict()
                             if self.scheduler is not None else None))

    def train(self) -> None:
        self.logger.info("Start training...\n")
        start_time = time.time()
        epoch = self.start_epoch
        # A resumed run: the host streams as they stood after the earlier
        # epochs (each loader's sample order, the chunk order).
        for _ in range(self.start_epoch):
            self._epoch_chunks(self.train_loaders)

        for epoch in range(self.start_epoch, self.n_epochs):
            header = f"Epoch {epoch}/{self.n_epochs - 1}"
            self.logger.info("\n{}\n{}\n".format(header, "-" * len(header)))
            # Trace the first trained epoch when a trace directory is set.
            traced = bool(self.profile_dir) and epoch == self.start_epoch
            with profiler.trace(self.profile_dir if traced else None,
                                next(self.state.model.parameters()).device):
                self.train_one_epoch(epoch)

            if (epoch + 1) % self.evaluate_rate == 0:
                val_loss = self.validate(epoch)
                self._last_val_loss = val_loss
                if val_loss < self.best_loss:
                    self.best_loss = val_loss
                    self.index_best_loss = epoch
                    self._save(self.path_model_best, epoch)
                    self.writer.add_hparams(dict(self.hparams),
                                            {"hparam/MAE_metric": val_loss})
                if self.scheduler is not None:
                    new_lr = self.scheduler.step(val_loss)
                    if new_lr != self.state.lr:
                        self.state.lr = new_lr

            if (epoch + 1) % self.save_model_rate == 0 and epoch > self.evaluate_rate:
                name = f"Model_after_{epoch + 1}_epochs.npz"
                self._save(os.path.join(self.checkpoint_dir, name), epoch)

        elapsed = time.time() - start_time
        self.logger.info("\n\nTraining finished!\nTraining time: {}".format(
            time.strftime("%H:%M:%S", time.gmtime(elapsed))))
        self.logger.info(f"\nBest model at epoch: {self.index_best_loss}")
        self.logger.info("Validation loss of the best model: {:.6f}".format(
            self.best_loss))
        self.writer.close()
        self._save(self.path_model_last, epoch)
        self._checkpointer.wait()  # Model_last exists when train() returns
        self._release(self.train_loaders)
        self._release(self.val_loaders)
