"""Host ms the train loop spends between steps: the mean time from one
profiled ``train#<step>`` span's end (``train/trainer.py``) to the next
one's start, the drains of the step metrics included."""

from benchmark import spans


def read(record: dict):
    return spans.step_gap_ms(spans.records())
