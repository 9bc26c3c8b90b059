"""Training metrics: running meters and the observability sink.

Parity surface:
  * ``AverageMeter`` — the reference's lib/AverageMeter.py:1-21;
  * ``MetricsWriter`` — the reference's three-channel scheme (SURVEY.md §5):
    TensorBoard scalars (``train/MAE_metric`` every N iters,
    ``val/MAE_metric`` + learning rate per eval epoch, hparams on new best —
    lib/Trainer.py:228-293) plus a machine-readable JSONL mirror the
    reference lacks. TensorBoard events go through ``tensorboardX`` when
    available; the JSONL sink always writes.

The port's copy of ``resdepth_tpu/train/metrics.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

from __future__ import annotations

import json
import math
import time


def _json_safe(value: float):
    """Strict-JSON scalar: json.dumps emits bare ``Infinity``/``NaN`` tokens
    for non-finite floats, which breaks non-Python consumers of the JSONL
    mirror (jq, most parsers) — map them to null."""
    value = float(value)
    return value if math.isfinite(value) else None


class AverageMeter:
    """Running value/sum/count/average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class MetricsWriter:
    def __init__(self, tboard_log_dir: str | None, jsonl_path: str | None = None):
        self._tb = None
        if tboard_log_dir:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(log_dir=tboard_log_dir)
            except Exception:
                self._tb = None
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._t0 = time.time()

    def add_scalar(self, tag: str, value, step: int):
        if self._tb:
            self._tb.add_scalar(tag, value, step)
        if self._jsonl:
            self._jsonl.write(json.dumps({
                "tag": tag, "value": _json_safe(value), "step": int(step),
                "wall_time": round(time.time() - self._t0, 3)}) + "\n")
            self._jsonl.flush()

    def add_hparams(self, hparams: dict, metrics: dict):
        if self._tb:
            try:
                self._tb.add_hparams(hparams, metrics)
            except Exception:
                pass
        if self._jsonl:
            metrics = {k: _json_safe(v) for k, v in metrics.items()}
            self._jsonl.write(json.dumps({"hparams": hparams, "metrics": metrics}) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._tb:
            self._tb.close()
        if self._jsonl:
            self._jsonl.close()
