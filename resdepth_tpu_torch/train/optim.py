"""Optimizers with the reference's torch semantics (port of
``resdepth_tpu/train/optim.py``).

Adam is ``torch.optim.Adam`` (betas 0.9/0.999, eps 1e-8) with L2 weight
decay added to the gradient before the moments, which is what optax's
``add_decayed_weights`` followed by ``scale_by_adam`` computes; SGD has no
momentum. The learning rate is a plain scalar that the shared
``resdepth_tpu.train.schedulers`` computes and ``set_lr`` writes into the
param groups.
"""

from __future__ import annotations

import torch

OPTIMIZERS = ("Adam", "SGD")


def build_optimizer(name: str, params, lr: float,
                    weight_decay: float = 0.0) -> torch.optim.Optimizer:
    if name == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    if name == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=0.0,
                               weight_decay=weight_decay)
    raise ValueError(f"Unknown optimizer: {name!r}. Choose among {list(OPTIMIZERS)}.")


def get_lr(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
