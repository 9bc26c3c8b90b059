"""Filesystem helpers (parity with the reference's lib/fdutil.py:4-63).

The port's copy of ``resdepth_tpu/utils/fs.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

from __future__ import annotations

import os


def make_dir(directory: str) -> None:
    """Create ``directory`` (and parents) if it does not exist."""
    os.makedirs(directory, exist_ok=True)


def file_extension(filepath: str) -> str:
    return os.path.splitext(filepath)[1]


def filename(filepath: str) -> str:
    return os.path.basename(filepath)


def filename_wo_ext(filepath: str) -> str:
    return os.path.splitext(os.path.basename(filepath))[0]


def file_exists(filepath) -> bool:
    return os.path.exists(filepath)
