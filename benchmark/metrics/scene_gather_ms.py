"""Device ms a scene in the batches' gathers (``data/pipeline.py::build_batch``):
the ``device_ms`` of the program's ``scene.gather`` spans (``infer/tiled.py``),
one a batch, summed under each profiled ``scene`` span, mean over the
scenes. A span's device interval holds the stream's idle time while the
host is behind."""

from benchmark import spans


def read(record: dict):
    return spans.mean_per(spans.records(), "scene", ("scene.gather",), device=True)
