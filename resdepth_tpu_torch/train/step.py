"""Train and eval steps, on one device or one rank of a data-parallel group
(port of ``resdepth_tpu/train/step.py``).

A train step assembles the batch on the device (``data.pipeline.
build_batch``: gather, mask, normalise, augment), runs the UNet in training
mode with BatchNorm statistics weighted by the 0/1 sample weights,
takes the denormalised masked L1, back-propagates, steps the optimizer,
writes the new BatchNorm running statistics and, under a weight EMA,
moves the EMA. The host sends only the (B, 2) positions and a few (B,)
vectors per step; the step returns the batch's masked MAE as a device
scalar, so the loop never waits for the card.

The precision policy is ``train.py``'s (``select_train_precision``):
``tpu.train_precision`` 'high' (the default) and 'highest' train in IEEE
fp32 (TF32 off for cuDNN convs and matmuls; the JAX package runs 'high' as
3 bf16 passes on its chip); 'default' runs every conv at 1 bf16 pass,
'balanced' at 1 pass but the first and last convs at 3, and 'balanced16'
on a bf16 activation trunk with those two convs at 3 passes on float32
operands; the gradients of each conv at its passes (``models/unet.py``,
``ops/passes.py``). ``tpu.compute_dtype`` 'bfloat16' casts the batch input
to bfloat16: a bf16 trunk end to end on float32 weights. The master
weights, Adam state and EMA stay float32.

Under a ``torch.distributed`` group (``parallel.mesh``; the JAX step's
``mesh``) every rank is handed the same global batch and keeps its
contiguous shard, as ``P(axes)`` splits it; BatchNorm takes its statistics
and the loss its denominator over the group; after the backward pass one
all-reduce sums the gradients, flattened into one buffer, as the JAX step
``psum``s them (each rank's loss already divides by the global
denominator, so the sum is the gradient of the global mean). The ranks
then take the same optimizer step on the same weights.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from resdepth_tpu_torch.data.pipeline import BatchSpec, DeviceRasters, build_batch
from resdepth_tpu_torch.models.unet import (Precision, UNet, apply_unet,
                                            commit_bn_state, serving_precision)
from resdepth_tpu_torch.parallel import mesh
from resdepth_tpu_torch.train.loss import denormalized_masked_l1
from resdepth_tpu_torch.train.optim import build_optimizer, get_lr, set_lr


def select_train_precision(train_precision: str | None, compute_dtype: str | None,
                           device: torch.device) -> tuple[dict, torch.dtype]:
    """The precision policy of ``tpu.train_precision`` and
    ``tpu.compute_dtype``, built as ``train.py`` builds it: the
    ``apply_unet`` keyword arguments ('balanced' and 'balanced16' are the
    serving modes of those names, ``serving_precision(mode).apply_kwargs()``)
    and the compute dtype of the batch input. Turns TF32 off on CUDA, for
    the IEEE float32 convs and matmuls."""
    name = train_precision or "high"
    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    if name in ("balanced", "balanced16"):
        kwargs = serving_precision(name).apply_kwargs()
    else:
        kwargs = {"high": dict(precision=None),
                  "default": dict(precision=Precision.DEFAULT),
                  "highest": dict(precision=Precision.HIGHEST)}[name]
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return kwargs, dtype


def _check_mixed_precision_input(mixed_precision: bool, compute_dtype) -> None:
    """The bf16-trunk policies need the raw f32 batch input: with
    ``compute_dtype`` bfloat16 the first conv would read an already rounded
    input (``resdepth_tpu/train/step.py::_check_mixed_precision_input``;
    the train CLI rejects it at validation)."""
    if mixed_precision and compute_dtype != torch.float32:
        raise ValueError(
            "mixed_precision (bf16 activation trunk) requires compute_dtype "
            f"float32, got {str(compute_dtype).removeprefix('torch.')}; the trunk "
            "handles its own bf16 rounding.")


@dataclasses.dataclass
class TrainState:
    """The model being trained, its optimizer and the step count.

    ``ema_model`` (None = no EMA) is a copy of ``model`` whose parameters
    are the exponential moving average of ``model``'s; it is what
    validation, checkpoints and serving use (``serve_model``), while
    ``model`` stays the raw optimizer iterate."""
    model: UNet
    optimizer: torch.optim.Optimizer
    optimizer_name: str
    weight_decay: float
    step: int = 0
    ema_model: UNet | None = None

    @property
    def lr(self) -> float:
        return get_lr(self.optimizer)

    @lr.setter
    def lr(self, value: float) -> None:
        set_lr(self.optimizer, value)

    def serve_model(self) -> UNet:
        """The weights to evaluate, checkpoint and serve: the EMA with the
        raw model's BatchNorm statistics when the EMA is on, else the raw
        model."""
        if self.ema_model is None:
            return self.model
        commit_bn_state(self.ema_model, dict(self.model.named_buffers()))
        return self.ema_model


def init_train_state(model: UNet, optimizer_name: str, lr: float,
                     weight_decay: float = 0.0, ema: bool = False) -> TrainState:
    """A TrainState over ``model`` (trained in place). The EMA starts as a
    copy of the initial weights."""
    ema_model = None
    if ema:
        ema_model = copy.deepcopy(model)
        ema_model.requires_grad_(False)
    return TrainState(model=model,
                      optimizer=build_optimizer(optimizer_name, model.parameters(),
                                                lr, weight_decay),
                      optimizer_name=optimizer_name, weight_decay=weight_decay,
                      ema_model=ema_model)


def _on(device, array, dtype=None) -> torch.Tensor:
    return torch.as_tensor(array, dtype=dtype).to(device)


def shard(group, *arrays) -> tuple:
    """This rank's contiguous share of each global batch array (axis 0),
    as the JAX ``P(axes)`` splits it; the arrays themselves for None."""
    n, r = mesh.size(group), mesh.rank(group)
    if n == 1:
        return arrays
    size = len(arrays[0])
    if size % n:
        raise ValueError(f"a batch of {size} does not split over {n} ranks "
                         "(pad it with zero-weight samples: emit_size)")
    share = size // n
    return tuple(a[r * share:(r + 1) * share] for a in arrays)


def _all_reduce_grads(parameters, group) -> None:
    """Sum every parameter's gradient over ``group`` in one all-reduce of
    one flat buffer (a parameter without a gradient adds zeros)."""
    params = [p for p in parameters if p.requires_grad]
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    mesh.all_reduce_(flat, group)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)


def make_train_step(spec: BatchSpec, *, weighted_bn: bool = True,
                    remat: bool = False, ema_decay: float = 0.0,
                    compute_dtype: torch.dtype = torch.float32, precision=None,
                    layer_precisions: dict | None = None,
                    mixed_precision: bool = False, hifi_endpoints: bool = False,
                    group=None):
    """Build the train step.

    ``step(state, rasters, positions, pair_idx, bounds, weights, draws)
    -> metric``: one optimizer step on ``state`` (in place) and the batch's
    masked MAE in meters as a 0-d device tensor. ``draws`` is a draw
    source for augmentation and permutation (``data.pipeline.
    GeneratorDraws`` over a ``torch.Generator`` on the rasters' device); the
    step draws from its ``at_step(state.step)``, as the JAX step folds its
    step count into the key.

    ``weighted_bn=False`` leaves the sample weights out of the BatchNorm
    statistics, which is the same only when no sample is padding.
    ``remat`` recomputes each conv block in the backward pass. ``ema_decay``
    > 0 moves ``state.ema_model`` toward the new weights after each step.
    ``compute_dtype`` is the batch input's dtype, and ``precision``,
    ``layer_precisions``, ``mixed_precision`` and ``hifi_endpoints`` are
    ``apply_unet``'s: the policy of ``select_train_precision``.

    ``group`` (``parallel.mesh.data_mesh``) trains data-parallel: the step
    is handed the global batch, whose size the group's ranks divide, and
    runs this rank's shard (``shard``); ``draws`` should be seeded per
    rank, as the JAX step folds in the axis index. The metric is the
    global batch's.

    JAX's ``steps_per_call`` K > 1 scans K steps in one program to save
    dispatches; here K calls of this step in sequence are the same thing.
    """
    _check_mixed_precision_input(mixed_precision, compute_dtype)
    policy = dict(precision=precision, layer_precisions=layer_precisions,
                  mixed_precision=mixed_precision, hifi_endpoints=hifi_endpoints)
    decay = np.float32(ema_decay)
    keep = float(decay)
    move = float(np.float32(1) - decay)

    def step(state: TrainState, rasters: DeviceRasters, positions, pair_idx,
             bounds, weights, draws):
        device = rasters.dsm_input.device
        model = state.model
        model.train()
        positions, pair_idx, bounds, weights = shard(group, positions, pair_idx,
                                                     bounds, weights)
        w = _on(device, weights, torch.float32)
        batch = build_batch(rasters, _on(device, positions), _on(device, pair_idx),
                            spec, bounds=_on(device, bounds),
                            draws=None if draws is None else draws.at_step(state.step))
        pred, bn_state = apply_unet(model, batch["input"].to(compute_dtype),
                                    train=True,
                                    sample_weights=w if weighted_bn else None,
                                    remat=remat, group=group, **policy)
        loss, (num, den) = denormalized_masked_l1(
            pred, batch["target"], batch["loss_mask"], batch["dsm_mean"],
            spec.dsm_std, w, group)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if group is not None:
            _all_reduce_grads(model.parameters(), group)
            num, den = mesh.all_reduce_(torch.stack([num.detach(), den]), group)
        state.optimizer.step()
        commit_bn_state(model, bn_state)
        if ema_decay:
            with torch.no_grad():
                ema = list(state.ema_model.parameters())
                torch._foreach_mul_(ema, keep)
                torch._foreach_add_(ema, list(model.parameters()), alpha=move)
        state.step += 1
        return (num / torch.clamp_min(den, 1.0)).detach()

    return step


def make_eval_step(spec: BatchSpec, compute_dtype: torch.dtype = torch.float32,
                   group=None):
    """Build the eval step: ``eval_step(model, rasters, positions, pair_idx,
    bounds, weights) -> (num, den)`` device scalars, the masked absolute
    error sum in meters and the valid-pixel count, with BatchNorm running
    statistics. It runs the float32 policy at ``compute_dtype`` whatever the
    training precision, as ``train.py`` validates. Under ``group`` each rank
    runs its shard of the global batch and the sums are the global batch's."""

    @torch.no_grad()
    def eval_step(model: UNet, rasters: DeviceRasters, positions, pair_idx,
                  bounds, weights):
        device = rasters.dsm_input.device
        positions, pair_idx, bounds, weights = shard(group, positions, pair_idx,
                                                     bounds, weights)
        w = _on(device, weights, torch.float32)
        batch = build_batch(rasters, _on(device, positions), _on(device, pair_idx),
                            spec, bounds=_on(device, bounds))
        pred = apply_unet(model, batch["input"].to(compute_dtype))
        _, (num, den) = denormalized_masked_l1(
            pred, batch["target"], batch["loss_mask"], batch["dsm_mean"],
            spec.dsm_std, w)
        if group is not None:
            num, den = mesh.all_reduce_(torch.stack([num, den]), group)
        return num, den

    return eval_step
