"""Training epochs back to back through the port's
``train/trainer.py::Trainer.train_one_epoch`` over
``train/step.py::make_train_step``, as the train CLI wires them: one
training region resident on the card, ``BatchIndexIterator`` batches,
augmentation drawn on the device, Adam, no validation or saves in the
window. An epoch is the configuration's ``n_training_samples``.

Traffic keys: ``scene`` (pixels a side, the whole scene is the training
region), ``train_precision`` and ``compute_dtype`` (the policy, as
``tpu.train_precision`` and ``tpu.compute_dtype``), ``profile_steps``
(the traced stretch of a ``--trace 1`` window, from its first step) and
``control`` (the control path's policy, ``readings.py`` only). Batch,
tile, learning rate and weight decay are the configuration's.

Set-up builds the Trainer and runs a first epoch of the first three
batches of its loader, which warms every shape. Those steps are recorded
(tile origins, dihedral bits, losses, step 1's input to the UNet, Adam's first
moments after step 1, the weights and BatchNorm's running statistics after
step 3), and the plain reference (``reference/train.py``) follows them
from the same initial weights once the window has closed. The same Trainer
then runs the window's epochs over the whole loader."""

from __future__ import annotations

import contextlib
import itertools
import logging
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.drivers._shared import k3_entry, memory_dataset, n_input_channels
from benchmark.inputs import city, weights
from benchmark.reference.train import train_steps

FOLLOWED_STEPS = 3
BN_STATS = ("running_mean", "running_var")


class FirstBatches:
    """The first ``n`` batches of an epoch of ``iterator``."""

    def __init__(self, iterator, n: int):
        self.iterator, self.n = iterator, n

    def __len__(self):
        return self.n

    def __iter__(self):
        return itertools.islice(iter(self.iterator), self.n)


@contextlib.contextmanager
def dihedral_bits_recorded():
    """Record the augmentation's draws (``GeneratorDraws.dihedral_bits``'
    results) while the block runs."""
    from resdepth_tpu_torch.data.pipeline import GeneratorDraws

    drawn, original = [], GeneratorDraws.dihedral_bits

    def recorded(self, *args, **kwargs):
        bits = original(self, *args, **kwargs)
        drawn.append(bits.clone())
        return bits

    GeneratorDraws.dihedral_bits = recorded
    try:
        yield drawn
    finally:
        GeneratorDraws.dihedral_bits = original


def run(ctx: harness.Context) -> dict:
    from resdepth_tpu_torch.data.pipeline import (BatchIndexIterator, DeviceRasters,
                                                  batch_spec_for)
    from resdepth_tpu_torch.models import unet
    from resdepth_tpu_torch.ops import conv
    from resdepth_tpu_torch.train import step as step_module
    from resdepth_tpu_torch.train.cli import FREQ_AVERAGE_TRAIN_LOSS
    from resdepth_tpu_torch.train.step import (init_train_state, make_train_step,
                                               select_train_precision)
    from resdepth_tpu_torch.train.trainer import Trainer

    phases = harness.Phases(ctx.started)
    phases.mark("imports")
    traffic, cfg = ctx.traffic, ctx.config
    model, assumed, settings = cfg["model"], cfg["assumed"], cfg["training_settings"]
    device, size = ctx.device, traffic["scene"]
    tile, batch = settings["tile_size"], settings["batch_size"]
    per_epoch = settings["n_training_samples"]
    stereo = n_input_channels(model) == 3

    scene = city.synth_city(size, size, ctx.seed, device)
    dsm, gt = scene["dsm"], scene["gt"]
    orthos = scene["orthos"] if stereo else None
    del scene
    phases.mark("city")
    ortho_mean = float(orthos.mean()) if stereo else 0.0
    ortho_std = float(orthos.std()) if stereo else 1.0
    ds = memory_dataset(dsm.cpu().numpy(), gt.cpu().numpy(),
                        orthos.permute(1, 2, 0).cpu().numpy() if stereo else None,
                        tile_size=tile, sampling_strategy="train",
                        n_samples=per_epoch, seed=ctx.seed,
                        dsm_std=assumed["dsm_std"], ortho_mean=ortho_mean,
                        ortho_std=ortho_std, augment=settings["augment"])
    rasters = DeviceRasters(dsm_input=dsm, dsm_target=gt, orthos=orthos,
                            pairs=torch.as_tensor(ds.pairs_array, dtype=torch.int64,
                                                  device=device),
                            nodata=float(city.NODATA))
    phases.mark("dataset")
    state0 = weights.make_state(model, n_input_channels(model), ctx.seed, device,
                                assumed["weight_gain"])
    net = unet.UNet(unet.unet_config_from_settings(
        {**model, "n_input_channels": n_input_channels(model)}), device)
    net.load_state_dict(state0)
    policy = traffic["control"] if ctx.control else traffic
    kwargs, dtype = select_train_precision(policy["train_precision"],
                                           policy["compute_dtype"], device)
    optimizer = cfg["optimizer"]
    train_state = init_train_state(net, optimizer["name"], optimizer["learning_rate"],
                                   assumed["weight_decay"])
    step = make_train_step(batch_spec_for(ds), weighted_bn=False, compute_dtype=dtype,
                           **kwargs)
    workdir = tempfile.mkdtemp(prefix="benchmark_train_")
    logger = logging.getLogger("benchmark.train")
    logger.setLevel(logging.WARNING)
    loader = BatchIndexIterator(ds, batch, shuffle=True, seed=ctx.seed)
    trainer = Trainer(state=train_state, train_step=step, eval_step=None,
                      train_loaders=[(rasters, FirstBatches(loader, FOLLOWED_STEPS))],
                      val_loaders=[], n_epochs=1, checkpoint_dir=workdir,
                      freq_average_train_loss=FREQ_AVERAGE_TRAIN_LOSS,
                      rng_seed=ctx.seed, logger=logger)

    phases.mark("model")

    # Set-up: a first epoch of the steps followed for the reference.
    followed = {"positions": [], "losses": []}

    def follow(state, rasters_, positions, pair_idx, bounds, sample_weights, draws):
        if state.step == 0:
            unet_call = [(step_module, "apply_unet")]
            with harness.recording(unet_call, lambda model, x, **k: x.detach().float()
                                   .clone()) as inputs:
                metric = step(state, rasters_, positions, pair_idx, bounds,
                              sample_weights, draws)
            followed["first_input"] = inputs[0]
        else:
            metric = step(state, rasters_, positions, pair_idx, bounds, sample_weights,
                          draws)
        followed["positions"].append(np.array(positions))
        followed["losses"].append(float(metric))
        if state.step == 1:
            beta1 = state.optimizer.defaults["betas"][0]
            # No first moment where the optimizer took no step.
            followed["first_grad"] = {
                name: state.optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                / (1 - beta1) for name, p in state.model.named_parameters()}
        if state.step == FOLLOWED_STEPS:
            followed["params"] = {name: p.detach().clone()
                                  for name, p in state.model.named_parameters()}
            followed["bn_stats"] = {name: b.detach().clone()
                                    for name, b in state.model.state_dict().items()
                                    if name.endswith(BN_STATS)}
            trainer.train_step = step
        return metric

    trainer.train_step = follow
    with dihedral_bits_recorded() as bits:
        trainer.train_one_epoch(0)
    followed["bits"] = bits[:FOLLOWED_STEPS]
    trainer.train_loaders = [(rasters, loader)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    phases.mark("first_epoch")
    record = {"setup_s": time.perf_counter() - ctx.started, "setup_phases": phases.seconds,
              "model": model,
              "input_channels": n_input_channels(model), "tile": tile}

    epoch, first_unprofiled = 1, 1
    start = time.perf_counter()
    if ctx.trace:
        profile = harness.Profile(device)
        traced = {"steps": 0}

        def traced_step(*args):
            if traced["steps"] == 0:
                profile.start()
            metric = step(*args)
            traced["steps"] += 1
            if traced["steps"] == traffic["profile_steps"]:
                profile.stop()
                trainer.train_step = step
            return metric

        def k3_while_traced(*args, **kwargs):
            return k3_entry(*args, **kwargs) if trainer.train_step is traced_step else None

        trainer.train_step = traced_step
        targets = [(conv, "conv3x3_bias_act"), (unet, "conv3x3_bias_act")]
        with harness.recording(targets, k3_while_traced) as k3_calls:
            trainer.train_one_epoch(epoch)
        record["k3_calls"] = [c for c in k3_calls if c is not None]
        epoch = first_unprofiled = 2
    unprofiled_start = time.perf_counter()
    while time.perf_counter() - start < ctx.seconds or epoch == first_unprofiled:
        trainer.train_one_epoch(epoch)
        epoch += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    end = time.perf_counter()
    samples = (epoch - 1) * per_epoch
    if ctx.trace:
        record["trace"] = profile.summary()
    record.update(samples=samples, window_wall_s=end - start,
                  unprofiled_samples=(epoch - first_unprofiled) * per_epoch,
                  unprofiled_wall_s=end - unprofiled_start,
                  memory_peak_bytes=(torch.cuda.max_memory_allocated(device)
                                     if device.type == "cuda" else 0))

    del trainer, train_state, net, step
    if device.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(workdir, ignore_errors=True)
    reference = train_steps(
        state0, model["depth"], list(zip(followed["positions"], followed["bits"])),
        lr=optimizer["learning_rate"], weight_decay=assumed["weight_decay"],
        dsm_std=assumed["dsm_std"], rasters={"dsm": dsm, "gt": gt, "orthos": orthos},
        tile=tile, ortho_mean=ortho_mean, ortho_std=ortho_std, nodata=city.NODATA)
    numbers = training_gaps(followed, reference, state0)
    record["checks"] = harness.compare(numbers, ctx.limits)
    record["attempted"] = samples // batch
    record["failed"] = 0
    return record


def training_gaps(program: dict, reference: dict, state0: dict) -> dict:
    """The numbers compared: the loss gap of each followed step after the
    first as a share of the reference's (step 1's reads too close to sound
    runs under the control and every fault to hold a limit, PERF.md §2);
    the widest gap of step 1's input to the UNet (the
    normalised, gathered and augmented batch, in its normalised units);
    and, by the worst leaf, the gap between the norms of the program's and
    the reference's first gradient, of their change of the weights and of
    BatchNorm's running statistics over the followed steps, each as a share
    of the reference's norm of that leaf or of the median leaf's, whichever
    is larger. Weights whose reference gradient is under a thousandth of
    the median leaf's (rounding moves them under Adam) are left out."""
    numbers = {f"loss_gap.{i + 1}": abs(a - b) / abs(b) for i, (a, b) in
               enumerate(zip(program["losses"][:FOLLOWED_STEPS], reference["losses"]))
               if i > 0}
    numbers["input_max_gap"] = float((program["first_input"].permute(0, 3, 1, 2)
                                      - reference["first_input"]).abs().max())
    ref_grad = {k: float(v.norm()) for k, v in reference["first_grad"].items()}
    median = float(np.median(list(ref_grad.values())))
    leaves = [k for k, v in ref_grad.items() if v >= 1e-3 * median]

    def worst(prog: dict, ref: dict) -> float:
        floor = float(np.median(list(ref.values())))
        return max(abs(prog[k] - ref[k]) / max(ref[k], floor) for k in ref)

    def change(after: dict, keys) -> dict:
        return {k: float((after[k] - state0[k]).norm()) for k in keys}

    numbers["grad_gap"] = worst({k: float(program["first_grad"][k].norm()) for k in leaves},
                                {k: ref_grad[k] for k in leaves})
    numbers["change_gap"] = worst(change(program["params"], leaves),
                                  change(reference["params"], leaves))
    stats = [k for k in state0 if k.endswith(BN_STATS)]
    numbers["bn_stats_gap"] = worst(change(program["bn_stats"], stats),
                                    change(reference["buffers"], stats))
    return numbers
