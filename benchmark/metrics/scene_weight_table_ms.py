"""Host ms a scene in the blend weight table (``ops/blend.py::weight_table``):
the program's ``scene.weight_table`` span (``infer/tiled.py``) under each
profiled ``scene`` span, mean over the scenes."""

from benchmark import spans


def read(record: dict):
    return spans.mean_per(spans.records(), "scene", ("scene.weight_table",))
