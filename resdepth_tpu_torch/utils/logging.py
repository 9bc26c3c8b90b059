"""Logging setup with per-level formatters.

Re-creates the three-channel logging scheme of the reference
(the reference's lib/formatter.py:12-27, lib/utils.py:640-707): INFO lines are
bare messages, WARNING/ERROR are prefixed with the level, and other levels get
the full timestamped format. Handlers: console and/or append-mode file.

The port's copy of ``resdepth_tpu/utils/logging.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

from __future__ import annotations

import logging


class LeveledFormatter(logging.Formatter):
    """Formatter that dispatches to per-level sub-formatters."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._formats: dict[int, logging.Formatter] = {}

    def set_formatter(self, level: int, formatter: logging.Formatter) -> None:
        self._formats[level] = formatter

    def format(self, record: logging.LogRecord) -> str:
        sub = self._formats.get(record.levelno)
        if sub is None:
            return super().format(record)
        return sub.format(record)


def _default_formatter() -> LeveledFormatter:
    formatter = LeveledFormatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    formatter.set_formatter(logging.INFO, logging.Formatter("%(message)s"))
    formatter.set_formatter(logging.WARNING, logging.Formatter("%(levelname)s: %(message)s"))
    formatter.set_formatter(logging.ERROR, logging.Formatter("%(levelname)s: %(message)s"))
    return formatter


def setup_logger(logger_name, level=logging.INFO, log_to_console=True, log_file=None):
    """Idempotent: named loggers are process-cached by the logging module, so
    call sites that lazily set up 'their' logger per call (per evaluated
    prediction, per parsed pairlist, ...) would otherwise stack one more
    handler each time and print every line N times."""
    logger = logging.getLogger(logger_name)
    logger.setLevel(level)
    if log_to_console:
        add_console_logger(logger)
    if log_file:
        add_file_logger(logger, log_file)
    return logger


def add_console_logger(logger: logging.Logger) -> None:
    """Attach a console handler unless one is already attached."""
    for existing in logger.handlers:
        if type(existing) is logging.StreamHandler:
            return
    handler = logging.StreamHandler()
    handler.setFormatter(_default_formatter())
    logger.addHandler(handler)


def add_file_logger(logger: logging.Logger, log_file: str) -> None:
    """Attach an append-mode file handler unless that file is already
    attached (distinct files coexist — per-dataset/per-pair report loggers
    use dedicated logger names and files)."""
    import os

    target = os.path.abspath(log_file)
    for existing in logger.handlers:
        if isinstance(existing, logging.FileHandler) and \
                existing.baseFilename == target:
            return
    handler = logging.FileHandler(log_file, mode="a")
    handler.setFormatter(_default_formatter())
    logger.addHandler(handler)
