"""What every driver shares: the run's context, the wrappers that record
calls into the program from outside it, the profiled part of a window and
its reduction to busy time, kernel times and idle gaps, and the
comparison's numbers beside their limits."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "resdepth_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden:
    ``resdepth_tpu_torch`` is the program, ``resdepth_tpu`` is not."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Context:
    """One run of one cell: the configuration file's contents, the
    traffic mix's, the cell's limits, the seed, the window's length and
    whether the run is traced. ``control`` runs the traffic's control path
    in the program's place (``readings.py``, never a benchmark run)."""
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    started: float
    control: bool = False


class Phases:
    """The seconds of each stretch of set-up, from the run's start: each
    ``mark(name)`` closes the stretch since the last."""

    def __init__(self, started: float):
        self.last, self.seconds = started, {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name], self.last = now - self.last, now


def compare(numbers: dict, limits: dict) -> list[dict]:
    """Each number compared beside its limit (a number passes at or under
    its limit); a number without a limit is printed and passes nothing."""
    return [{"name": k, "value": v, "limit": limits.get(k),
             "ok": limits.get(k) is not None and v <= limits[k]}
            for k, v in numbers.items()]


@contextlib.contextmanager
def wrapped(targets, wrap):
    """Replace each ``(module, name)`` function by ``wrap(name, fn)``
    while the block runs: the benchmark's way into the program's calls."""
    originals = [getattr(m, n) for m, n in targets]
    for (module, name), fn in zip(targets, originals):
        setattr(module, name, wrap(name, fn))
    try:
        yield
    finally:
        for (module, name), fn in zip(targets, originals):
            setattr(module, name, fn)


@contextlib.contextmanager
def recording(targets, entry):
    """Append ``entry(*args, **kwargs)`` of every call to the yielded
    list, then call through."""
    calls = []

    def wrap(name, fn):
        def recorded(*args, **kwargs):
            calls.append(entry(*args, **kwargs))
            return fn(*args, **kwargs)
        return recorded

    with wrapped(targets, wrap):
        yield calls


@contextlib.contextmanager
def host_timed(targets, seconds: dict):
    """Time every call on the host clock: the seconds add up in
    ``seconds[name]``."""
    def wrap(name, fn):
        def timed(*args, **kwargs):
            start = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - start
        return timed

    with wrapped(targets, wrap):
        yield seconds


def annotated(targets):
    """Put every call in a profiler annotation of its name, so that a
    traced run's idle gaps say which of the program's calls the host was
    in."""
    import torch

    def wrap(name, fn):
        def annotated_call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return annotated_call

    return wrapped(targets, wrap)


class Profile:
    """``torch.profiler`` (CPU and CUDA activity) over a stretch of a
    window that the caller starts and stops; ``summary``, called once the
    window has closed, reduces its trace (``reduce_trace``) and adds
    ``window_s``, the stretch's host wall to the device's last op."""

    def __init__(self, device):
        self.device = device

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.started = time.perf_counter()

    def stop(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window = time.perf_counter() - self.started
        self.prof.stop()

    def summary(self) -> dict:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        return {**reduce_trace(events), "window_s": self.window}


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def reduce_trace(events: list, top: int = 10) -> dict:
    """A Chrome trace's device time: ``busy_s`` (the union of its device
    ops' intervals), ``kernel_s`` (seconds by kernel name), ``device_ops``
    (the ``top`` names by time) and ``idle_gaps`` (the ``top`` longest
    stretches without a device op, those before the first and after the
    last included, each named by the innermost host operator or, where
    none runs, annotation at the stretch's middle)."""
    ops = sorted((e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e),
                 key=lambda e: e["ts"])
    host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")
            and "dur" in e]
    kernel_s: dict = {}
    for e in ops:
        kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + e["dur"] / 1e6
    busy, gaps, reach = 0.0, [], None
    for e in ops:
        start, end = e["ts"], e["ts"] + e["dur"]
        if reach is not None and start > reach:
            gaps.append((reach, start))
        busy += max(0.0, end - max(start, reach if reach is not None else start))
        reach = end if reach is None else max(reach, end)
    if ops and host:
        gaps.append((min(e["ts"] for e in host), ops[0]["ts"]))
        gaps.append((reach, max(e["ts"] + e["dur"] for e in host)))
    named = []
    for a, b in sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) / 2
        over = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        ops_over = [e for e in over if e.get("cat") == "cpu_op"] or over
        name = min(ops_over, key=lambda e: e["dur"])["name"] if ops_over else "python"
        named.append([name, (b - a) / 1e6])
    ranked = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy / 1e6, "kernel_s": kernel_s,
            "device_ops": [[k, v] for k, v in ranked], "idle_gaps": named}
