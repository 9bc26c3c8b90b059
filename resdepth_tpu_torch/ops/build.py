"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with nvcc for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``; no PyTorch header
is compiled, so a build takes seconds. The library goes to
``build/resdepth_tpu_torch/`` beside the package, named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
reused. Different sources build concurrently when loaded from several
threads. A failed build or load raises: there is no fallback. ptxas
reports each kernel's registers, shared memory and spills (``-Xptxas=-v``);
a build keeps that report in ``BUILD_LOGS``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PACKAGE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE), "build", "resdepth_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()                       # guards _name_locks
_name_locks: dict[str, threading.Lock] = {}    # one build at a time per source
_libraries: dict[str, ctypes.CDLL] = {}
# Seconds each library took to build in this process (0.0 when reused),
# and nvcc's report of each build in this process.
BUILD_SECONDS: dict[str, float] = {}
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA kernels "
                       "are built from source at first use")


def library_path(name: str) -> str:
    """Path of the built library for ``csrc/<name>.cu`` at its current source."""
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}_{digest[:16]}.so")


def _build(name: str, target: str) -> None:
    # Compile to a private temp file and publish with an atomic rename, so
    # concurrent processes never load a half-written library.
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        result = subprocess.run(cmd, capture_output=True, text=True)
        if result.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{result.stderr}")
        BUILD_LOGS[name] = result.stdout + result.stderr
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name not in _libraries:
            target = library_path(name)
            start = time.perf_counter()
            if not os.path.exists(target):
                _build(name, target)
            BUILD_SECONDS[name] = time.perf_counter() - start
            _libraries[name] = ctypes.CDLL(target)
        return _libraries[name]
