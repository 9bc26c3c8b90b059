"""Host ms a train step takes to enqueue: the mean host time of the
program's ``train#<step>`` spans (``train/trainer.py``) in the profiled
steps, the one the profiler's stop fell inside left out."""

from benchmark import spans


def read(record: dict):
    return spans.step_launch_ms(spans.records())
