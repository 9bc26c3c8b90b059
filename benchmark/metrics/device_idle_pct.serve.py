"""The device's idle share under the scene loop: 1 - the union of its
ops' intervals over the profiled scenes' wall."""

from benchmark.counts.shares import idle_pct


def read(record: dict):
    return idle_pct(record) if "scene_tiles" in record else None
