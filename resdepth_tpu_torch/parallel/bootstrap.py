"""Multi-process runtime bootstrap: one process per GPU over
``torch.distributed``.

Port of ``resdepth_tpu/parallel/bootstrap.py``. The JAX package runs one
process over every local device of a mesh; PyTorch's idiom is one process
per GPU, each with its rank's device, joined in one process group. Every
process builds the same global batches from the same seeded host iterator
(the JAX package's "replicated host inputs") and keeps its rank's shard;
gradients, BatchNorm statistics and scene canvases are all-reduced over
the group (``parallel.mesh``).

Artifacts are written by rank 0, the chief (``is_chief``): checkpoints,
metrics, logs, refined rasters.
"""

from __future__ import annotations

import datetime
import importlib
import os
import socket
import subprocess
import tempfile
import time

import torch
import torch.distributed as dist

_ENV_COORDINATOR = "RESDEPTH_DIST_COORDINATOR"
_ENV_NUM_PROCESSES = "RESDEPTH_DIST_NUM_PROCESSES"
_ENV_PROCESS_ID = "RESDEPTH_DIST_PROCESS_ID"
_ENV_AUTO = "RESDEPTH_DISTRIBUTED"

# Case- and whitespace-insensitive spellings that leave the bootstrap off.
FALSY = ("", "0", "false", "no", "off")

# How long a collective waits for its peers before it raises (the init
# included): long enough for the chief's evaluation and raster writes
# between two scenes of the inference CLI, short of PyTorch's 30 minutes.
TIMEOUT = datetime.timedelta(minutes=10)


def wants_distributed(tpu_cfg=None) -> bool:
    """Whether a multi-process launch is asked for: the ``RESDEPTH_DIST_*``
    coordinator, ``RESDEPTH_DISTRIBUTED`` set to anything but a falsy
    spelling (``FALSY``), or ``distributed: true`` in the config's ``tpu``
    section."""
    return bool(os.environ.get(_ENV_COORDINATOR)
                or (tpu_cfg and tpu_cfg.get("distributed"))
                or os.environ.get(_ENV_AUTO, "").strip().lower() not in FALSY)


def maybe_initialize_distributed(tpu_cfg=None, logger=None, backend=None, *,
                                 device: str | None = None,
                                 timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Join the process group when a multi-process launch is asked for;
    no-op (returning False) otherwise. Triggers, first match wins:

    1. ``RESDEPTH_DIST_COORDINATOR`` (host:port) with
       ``RESDEPTH_DIST_NUM_PROCESSES`` and ``RESDEPTH_DIST_PROCESS_ID``:
       ``init_method="tcp://host:port"`` with that world size and rank.
    2. ``RESDEPTH_DISTRIBUTED`` truthy or ``tpu.distributed: true``:
       ``init_method="env://"``, which reads ``torchrun``'s ``MASTER_ADDR``,
       ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``.

    ``device`` is the entry point's device type, "cuda" (the default when
    CUDA is present) or "cpu". On CUDA the rank binds its card before the
    group forms (``LOCAL_RANK``, else the rank modulo the visible cards) and
    the backend is NCCL; on the CPU it is gloo. ``backend`` overrides that
    choice, for a caller that wants gloo on CUDA (ranks sharing one card).
    Call it before the first CUDA access. Idempotent: returns True at once
    when the group is up."""
    if dist.is_initialized():
        return True
    if not wants_distributed(tpu_cfg):
        return False
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    coordinator = os.environ.get(_ENV_COORDINATOR)
    if coordinator:
        world = int(os.environ[_ENV_NUM_PROCESSES])
        rank = int(os.environ[_ENV_PROCESS_ID])
        init = dict(init_method=f"tcp://{coordinator}", world_size=world, rank=rank)
    else:
        rank = int(os.environ.get("RANK", 0))
        init = dict(init_method="env://")
    if device == "cuda":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend or ("nccl" if device == "cuda" else "gloo"),
                            timeout=timeout, **init)
    if logger is not None:
        logger.info(f"torch.distributed initialized: process {dist.get_rank()} of "
                    f"{dist.get_world_size()} ({dist.get_backend()}"
                    + (f", cuda:{torch.cuda.current_device()}" if device == "cuda"
                       else "") + ")")
    return True


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_chief() -> bool:
    """True on the process that writes run artifacts: rank 0 of the process
    group, and the one process of a run without one."""
    return process_index() == 0


def broadcast_object(obj):
    """The chief's ``obj`` on every process (itself without a group)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def free_port() -> int:
    """A free TCP port on localhost, for a coordinator."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def plain_launch_size(device: str, data_parallel: bool) -> int:
    """How many processes a plain launch of an entry point runs: one per
    visible GPU on ``device`` "cuda" with ``data_parallel`` and more than one
    GPU, when no process group is up or asked for; else 1."""
    if (dist.is_initialized() or wants_distributed() or device != "cuda"
            or not data_parallel or not torch.cuda.is_available()):
        return 1
    return torch.cuda.device_count()


def _spawned(index: int, module: str, argv, coordinator: str, n: int) -> None:
    os.environ.update({_ENV_COORDINATOR: coordinator,
                       _ENV_NUM_PROCESSES: str(n), _ENV_PROCESS_ID: str(index),
                       "LOCAL_RANK": str(index)})
    importlib.import_module(module).main(argv)


def launch_per_gpu(module: str, argv, n: int) -> None:
    """Run ``module.main(argv)`` (an entry point's module, by name) in ``n``
    new processes, one per visible GPU, joined through a coordinator on
    localhost at a free port (``RESDEPTH_DIST_*``): the counterpart of the
    JAX CLIs' one process over every local device. Returns when all have
    finished; raises if one of them failed (the others are then stopped)."""
    import torch.multiprocessing as mp

    mp.start_processes(_spawned, args=(module, argv, f"localhost:{free_port()}", n),
                       nprocs=n, start_method="spawn")


class WorldFailed(RuntimeError):
    """A rank of ``run_world`` failed, or the world outlasted its timeout."""


def run_world(argv, n: int, *, timeout: float, cwd: str | None = None,
              env: dict | None = None, local_rank=None, log_dir: str | None = None,
              until=None) -> list:
    """Run the command ``argv`` as ranks 0..n-1 of one world: ``n``
    processes joined through ``RESDEPTH_DIST_*`` at a free localhost port,
    over ``env`` (default: this process's environment). Each rank's
    standard output and error go to ``log_dir/rank<r>.log`` (a temporary
    directory by default); returns each rank's output.

    A rank that fails, or a world that outlasts ``timeout`` seconds (a hung
    collective), stops every rank and raises ``WorldFailed`` with the
    failed ranks' last lines. ``local_rank(rank)``: the card a rank binds
    (``LOCAL_RANK``; None, or a call that returns None, leaves it to
    ``maybe_initialize_distributed``). ``until``: a call polled while the
    world runs; once it returns true every rank is stopped and the outputs
    so far are returned (``WorldFailed`` if the ranks all ended first)."""
    coordinator = f"localhost:{free_port()}"
    base = dict(os.environ if env is None else env)
    for key in (_ENV_AUTO, "LOCAL_RANK"):
        base.pop(key, None)
    with tempfile.TemporaryDirectory(prefix="world_") as scratch:
        log_dir = log_dir or scratch
        procs, logs = [], []
        try:
            for rank in range(n):
                rank_env = {**base, _ENV_COORDINATOR: coordinator,
                            _ENV_NUM_PROCESSES: str(n), _ENV_PROCESS_ID: str(rank)}
                local = local_rank(rank) if local_rank else None
                if local is not None:
                    rank_env["LOCAL_RANK"] = str(local)
                logs.append(open(os.path.join(log_dir, f"rank{rank}.log"), "w+"))
                procs.append(subprocess.Popen(argv, env=rank_env, cwd=cwd, stdout=logs[-1],
                                              stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            stopped = False
            while any(p.poll() is None for p in procs):
                if until is not None and until():
                    stopped = True
                    break
                if (any(p.poll() not in (None, 0) for p in procs)
                        or time.monotonic() > deadline):
                    break
                time.sleep(0.005 if until is not None else 0.1)
            failed = [] if stopped else [r for r, p in enumerate(procs) if p.poll() != 0]
            hung = [r for r in failed if procs[r].poll() is None]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        outputs = []
        for f in logs:
            f.seek(0)
            outputs.append(f.read())
            f.close()
    if failed:
        raise WorldFailed(
            f"a world of {n} rank(s) failed"
            + (f": it outlasted {timeout:.0f} s" if hung else "") + "\n" + "\n".join(
                f"rank {r} ({'running' if r in hung else f'exit {procs[r].returncode}'}):\n"
                + outputs[r][-4000:] for r in failed))
    if until is not None and not stopped:
        raise WorldFailed(f"a world of {n} rank(s) ended before it was to be stopped")
    return outputs
