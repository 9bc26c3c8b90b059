"""Device ms a scene in the refined canvas's copy to host memory: the
``device_ms`` of the program's ``scene.fetch`` span (``infer/tiled.py``)
under each profiled ``scene`` span, mean over the scenes."""

from benchmark import spans


def read(record: dict):
    return spans.mean_per(spans.records(), "scene", ("scene.fetch",), device=True)
