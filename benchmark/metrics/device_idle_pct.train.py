"""The device's idle share under the train loop (``Trainer`` and the
train step): 1 - the union of its ops' intervals over the profiled
steps' wall."""

from benchmark.counts.shares import idle_pct


def read(record: dict):
    return idle_pct(record) if "samples" in record else None
