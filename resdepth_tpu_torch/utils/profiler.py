"""Profiling hooks (port of ``resdepth_tpu/utils/profiler.py``).

``trace`` records the enclosed block with ``torch.profiler``, enabled by
``cfg.tpu.profile_dir`` (the train CLI traces the first trained epoch);
``step_annotation`` marks one step in it; ``StepTimer`` is a rolling
host-clock step timer.

Trace format: where the JAX package's ``jax.profiler`` writes
``plugins/profile/<run>/<host>.xplane.pb`` files, the port writes one
Chrome trace-event JSON file per traced block,
``<profile_dir>/<host>.<pid>.rank<r>.<time_ns>.pt.trace.json``
(``torch.profiler``'s ``export_chrome_trace``), which Perfetto
(ui.perfetto.dev), ``chrome://tracing`` and TensorBoard's profiler plugin
open. Its ``traceEvents`` hold the host's operators (``cat`` "cpu_op"),
the step annotations (``cat`` "user_annotation", named ``<name>#<step>``),
the CUDA runtime calls and, on a CUDA device, every kernel the card ran
(``cat`` "kernel"), those launched through ``ctypes`` (kernels K1, K2 and
K3) included: they have no operator above them, so count them by kernel
name.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time


@contextlib.contextmanager
def trace(profile_dir: str | None, device=None):
    """Trace the enclosed block with ``torch.profiler`` when a directory is
    set: the CPU activity, and the CUDA activity when ``device`` is a CUDA
    device. The trace file (module docstring) is written when the block
    ends. ``None`` or ``""`` traces nothing."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from resdepth_tpu_torch.parallel.bootstrap import process_index

    activities = [ProfilerActivity.CPU]
    on_cuda = device is not None and torch.device(device).type == "cuda"
    if on_cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if on_cuda:
                torch.cuda.synchronize(device)
    name = (f"{socket.gethostname()}.{os.getpid()}.rank{process_index()}."
            f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(os.path.join(profile_dir, name))


@contextlib.contextmanager
def step_annotation(name: str, step: int):
    """Mark one step as ``<name>#<step>`` in a trace (the step boundaries a
    torch trace lacks; XLA's traces carry them per program)."""
    import torch

    with torch.profiler.record_function(f"{name}#{step}"):
        yield


class StepTimer:
    """Rolling per-step wall-clock statistics (host view of device steps)."""

    def __init__(self, window: int = 100):
        self.window = window
        self._samples: list[float] = []
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._samples.append(now - self._last)
            if len(self._samples) > self.window:
                self._samples.pop(0)
        self._last = now

    @property
    def mean_ms(self) -> float:
        if not self._samples:
            return 0.0
        return 1e3 * sum(self._samples) / len(self._samples)
