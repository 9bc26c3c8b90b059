"""ctypes bindings to the native TIFF codec (resdepth_tpu_torch/native/tiffcodec.cc).

The shared library is built on demand with g++ (one-time, cached in
``build/resdepth_tpu_torch/`` beside the package, where ``ops/build.py``
puts the CUDA libraries). Every entry point has a pure-Python fallback in
geo/tiff.py, so the codec works without a toolchain — the native path exists because LZW is a
byte-sequential algorithm that Python executes ~100x slower than C++ (it is
the decode hot path when ingesting LZW-compressed GeoTIFF scenes, the
compression the reference's exporter writes — lib/rasterutils.py:228).

The port's copy of ``resdepth_tpu/geo/_native.py``, so that the port imports
nothing of the JAX package. It differs in its imports and in where it puts
the library: the JAX module builds it next to the source, this one into the
git-ignored build directory.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

from resdepth_tpu_torch.ops.build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "tiffcodec.cc")
_SO = os.path.join(BUILD_DIR, "_tiffcodec.so")
_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def _build() -> None:
    # Compile to a private temp file and publish with an atomic rename:
    # concurrent processes (parallel pytest workers, train+test side by
    # side) racing `g++ -o` on the same path would interleave writes and
    # persist a corrupt .so that every later run trusts by mtime.
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True, capture_output=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            try:
                _build()
            except (OSError, subprocess.CalledProcessError) as exc:
                raise NativeUnavailable(f"native codec build failed: {exc}") from exc
        try:
            lib = ctypes.CDLL(_SO)
        except OSError as exc:
            # A stale/corrupt artifact (e.g. from an interrupted older
            # build) — rebuild once before giving up.
            try:
                _build()
                lib = ctypes.CDLL(_SO)
            except (OSError, subprocess.CalledProcessError) as exc2:
                raise NativeUnavailable(
                    f"native codec load failed: {exc2}") from exc
        for name in ("rd_lzw_decode", "rd_lzw_encode", "rd_packbits_decode"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_long
            fn.argtypes = [ctypes.c_char_p, ctypes.c_long,
                           ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long]
        _lib = lib
    return _lib


def _run_growing(fn, data: bytes, initial_cap: int) -> bytes:
    cap = max(initial_cap, 1024)
    while True:
        buffer = (ctypes.c_ubyte * cap)()
        n = fn(data, len(data), buffer, cap)
        if n == -2:
            raise ValueError("malformed compressed stream")
        if n >= 0:
            return ctypes.string_at(buffer, n)  # one n-byte copy
        cap *= 4


def lzw_decode(data: bytes, expected_size: int | None = None) -> bytes:
    """``expected_size`` (the known decompressed strip size from the TIFF
    byte counts) sizes the output buffer exactly, skipping the grow-and-retry
    passes a highly compressible strip (nodata regions) would otherwise pay."""
    lib = _load()
    initial = expected_size + 1 if expected_size else 8 * len(data)
    return _run_growing(lib.rd_lzw_decode, data, initial)


def lzw_encode(data: bytes) -> bytes:
    lib = _load()
    return _run_growing(lib.rd_lzw_encode, data, 2 * len(data) + 1024)


def packbits_decode(data: bytes, expected_size: int | None = None) -> bytes:
    lib = _load()
    initial = expected_size + 1 if expected_size else 4 * len(data)
    return _run_growing(lib.rd_packbits_decode, data, initial)
