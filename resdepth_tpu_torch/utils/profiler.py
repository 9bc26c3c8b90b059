"""Profiling hooks (port of ``resdepth_tpu/utils/profiler.py``): the one
place where the program records spans.

``trace`` records the enclosed block with ``torch.profiler``, enabled by
``cfg.tpu.profile_dir`` (the train CLI traces the first trained epoch).
``span`` marks a stretch of the program's own work: whenever a
``torch.profiler`` profile is on (``trace``, or any caller's own
``torch.profiler.profile``), a span puts a ``record_function`` range of
its name on the trace and appends a record to an in-memory store, which
``spans`` reads and ``clear`` empties (``trace`` empties it when its block
ends: the trace file holds the spans). With no profiler on, a span does
one flag check and records nothing. ``step_annotation`` is the span of
one train step, ``<name>#<step>``.

The spans the program records, each read by a per-layer metric of the
benchmark (``benchmark/spans.py``), by layer:

- the scene loop (``infer/tiled.py``): ``scene`` (the whole of
  ``predict_linear_blend``), under it ``scene.weight_table`` (host), and
  on the device, one of each a batch, ``scene.gather`` (``build_batch``)
  and ``scene.forward`` (the UNet with its TTA replicas), then
  ``scene.fetch`` (the canvas to host memory);
- the train loop (``train/trainer.py``): ``train#<step>`` around each
  step's call (its host time is the time to enqueue the step; from one
  step's end to the next one's start is the loop's own time between
  steps);
- the predict CLI (``predict.py``): ``cli.run``, under it ``cli.model``,
  ``cli.read``, ``cli.infer`` and ``cli.fetch``.

A record holds ``name``; ``start_ns`` and ``end_ns`` from
``time.time_ns()``, the clock of the Chrome trace's ``ts`` plus its
``baseTimeNanoseconds``; ``parent``, the store index of the enclosing
recording span on the same thread (None for a root); and
``outlived_profile``, True when the profiler stopped while the span was
open (its end lies past the trace, and its host time holds the
profiler's stop). A span given a CUDA ``device`` also records a timing
event on the device's current stream at entry and at exit; ``spans`` adds
their interval as ``device_ms``.

Trace format: where the JAX package's ``jax.profiler`` writes
``plugins/profile/<run>/<host>.xplane.pb`` files, the port writes one
Chrome trace-event JSON file per traced block,
``<profile_dir>/<host>.<pid>.rank<r>.<time_ns>.pt.trace.json``
(``torch.profiler``'s ``export_chrome_trace``), which Perfetto
(ui.perfetto.dev), ``chrome://tracing`` and TensorBoard's profiler plugin
open. Its ``traceEvents`` hold the host's operators (``cat`` "cpu_op"),
the program's spans (``cat`` "user_annotation", the train steps named
``train#<step>``), the CUDA runtime calls and, on a CUDA device, every
kernel the card ran (``cat`` "kernel"), those launched through ``ctypes``
(kernels K1, K2 and K3) included: they have no operator above them, so
count them by kernel name.
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()
_STORE: list[dict] = []
_STORE_LOCK = threading.Lock()
_OPEN = threading.local()   # per thread: the store indices of the open spans


@contextlib.contextmanager
def trace(profile_dir: str | None, device=None):
    """Trace the enclosed block with ``torch.profiler`` when a directory is
    set: the CPU activity, and the CUDA activity when ``device`` is a CUDA
    device. The trace file (module docstring) is written when the block
    ends, with the program's spans in it, and the span store is emptied.
    ``None`` or ``""`` traces nothing."""
    if not profile_dir:
        yield
        return
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
    clear()


class _Span:
    """A recording span (``span``)."""

    __slots__ = ("name", "device", "record", "function", "events")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.record = {"name": self.name, "start_ns": time.time_ns(), "end_ns": None,
                       "parent": stack[-1] if stack else None, "outlived_profile": False}
        with _STORE_LOCK:
            stack.append(len(_STORE))
            _STORE.append(self.record)
        self.function = torch.profiler.record_function(self.name)
        self.function.__enter__()
        self.events = None
        if self.device and torch.device(self.device).type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True), stream)
            self.events[0].record(stream)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.events[2])
            self.record["events"] = self.events[:2]
        self.function.__exit__(*exc)
        self.record["end_ns"] = time.time_ns()
        self.record["outlived_profile"] = not _autograd_profiler._is_profiler_enabled
        _OPEN.stack.pop()
        return False


def span(name: str, device=False):
    """A context manager that marks the enclosed block as ``name``
    (module docstring): when a ``torch.profiler`` profile is on as the
    block is entered, a ``record_function`` range on the trace and a record
    in the store; with ``device`` a CUDA device, two timing events on its
    current stream besides. A span entered with the profiler on is recorded
    whole though the profiler stops inside it; one entered with it off
    records nothing, makes no torch call and allocates nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def step_annotation(name: str, step: int):
    """The span of one step, ``<name>#<step>`` (the step boundaries a torch
    trace lacks; XLA's traces carry them per program)."""
    return span(f"{name}#{step}")


def spans() -> list[dict]:
    """Copies of the store's records, in the order the spans were entered
    (a record's index in the list is the one ``parent`` names). A device
    span that has closed gets ``device_ms``, its events' interval (waits
    for its end event)."""
    with _STORE_LOCK:
        records = list(_STORE)
    out = []
    for record in records:
        record = dict(record)
        events = record.pop("events", None)
        if events is not None:
            events[1].synchronize()
            record["device_ms"] = events[0].elapsed_time(events[1])
        out.append(record)
    return out


def clear() -> None:
    """Empty the store. Call it with no span open: a span opened before
    would name a parent that is gone."""
    with _STORE_LOCK:
        _STORE.clear()
