"""Learning-rate schedulers with torch semantics.

The reference exposes ReduceLROnPlateau / StepLR / ExponentialLR
(the reference's lib/utils.py:344-377) and advances the scheduler once per
VALIDATION epoch, not per training epoch (lib/Trainer.py:295-300) — preserved
by the Trainer. These are small host-side state machines (the LR itself is a
scalar fed into the jitted step), with state_dict round-trips for
checkpointing.

The port's copy of ``resdepth_tpu/train/schedulers.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

from __future__ import annotations


class _SchedulerBase:
    def __init__(self, initial_lr: float):
        self.initial_lr = float(initial_lr)
        self.lr = float(initial_lr)

    def step(self, metric=None) -> float:
        raise NotImplementedError

    def state_dict(self) -> dict:
        return dict(self.__dict__)

    def load_state_dict(self, state: dict) -> None:
        self.__dict__.update(state)


class StepLR(_SchedulerBase):
    """lr = initial * gamma^(n_steps // step_size)."""

    def __init__(self, initial_lr, step_size, gamma=0.1):
        super().__init__(initial_lr)
        self.step_size = int(step_size)
        self.gamma = float(gamma)
        self.n_steps = 0

    def step(self, metric=None) -> float:
        self.n_steps += 1
        self.lr = self.initial_lr * self.gamma ** (self.n_steps // self.step_size)
        return self.lr


class ExponentialLR(_SchedulerBase):
    """lr = initial * gamma^n_steps."""

    def __init__(self, initial_lr, gamma):
        super().__init__(initial_lr)
        self.gamma = float(gamma)
        self.n_steps = 0

    def step(self, metric=None) -> float:
        self.n_steps += 1
        self.lr = self.initial_lr * self.gamma ** self.n_steps
        return self.lr


class ReduceLROnPlateau(_SchedulerBase):
    """Multiply lr by ``factor`` after ``patience`` non-improving metrics.

    Torch semantics: relative threshold (metric < best * (1 - threshold)
    counts as improvement for mode='min'), cooldown after a reduction,
    ``min_lr`` floor, reductions smaller than ``eps`` skipped.
    """

    def __init__(self, initial_lr, factor=0.1, patience=10, threshold=1e-4,
                 threshold_mode="rel", cooldown=0, min_lr=0.0, eps=1e-8):
        super().__init__(initial_lr)
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(f"threshold_mode must be 'rel' or 'abs', "
                             f"got {threshold_mode!r}")
        self.factor = float(factor)
        self.patience = int(patience)
        self.threshold = float(threshold)
        self.threshold_mode = threshold_mode
        self.cooldown = int(cooldown)
        # torch accepts a per-param-group list; one group exists here
        self.min_lr = float(min_lr[0] if isinstance(min_lr, (list, tuple))
                            else min_lr)
        self.eps = float(eps)
        self.best = float("inf")
        self.num_bad = 0
        self.cooldown_counter = 0

    def step(self, metric=None) -> float:
        if metric is None:
            return self.lr
        metric = float(metric)
        improved = (metric < self.best - self.threshold
                    if self.threshold_mode == "abs"
                    else metric < self.best * (1.0 - self.threshold))
        if improved:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        # torch semantics: the cooldown window ticks down on EVERY step while
        # active (improvement or not) and suppresses bad-epoch counting.
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0

        if self.num_bad > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        return self.lr


def build_scheduler(cfg_scheduler, initial_lr):
    """Factory from the config section (parity: lib/utils.py:344-377).

    Returns None when disabled.
    """
    if not cfg_scheduler.get("enabled", False):
        return None
    name = cfg_scheduler.get("name", "StepLR")
    settings = dict(cfg_scheduler.get("settings", {}))
    # The reference crashes with a raw TypeError when required scheduler
    # settings are absent (default config: StepLR with empty settings —
    # lib/config.py:110-114 + lib/utils.py:362); fail with a clear message
    # instead.
    if name == "StepLR" and "step_size" not in settings:
        raise ValueError("scheduler 'StepLR' requires scheduler.settings."
                         "step_size (e.g. \"settings\": {\"step_size\": 200})")
    if name == "ExponentialLR" and "gamma" not in settings:
        raise ValueError("scheduler 'ExponentialLR' requires "
                         "scheduler.settings.gamma")
    if name == "StepLR":
        return StepLR(initial_lr, **settings)
    if name == "ExponentialLR":
        return ExponentialLR(initial_lr, **settings)
    if name == "ReduceLROnPlateau":
        settings.pop("mode", None)  # only 'min' is meaningful for this loss
        return ReduceLROnPlateau(initial_lr, **settings)
    raise ValueError(f"Unknown scheduler: {name!r}")
