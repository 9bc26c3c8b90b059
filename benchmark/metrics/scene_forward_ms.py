"""Device ms a scene in the UNet forward (``models/unet.py``, TTA replicas
included): the ``device_ms`` of the program's ``scene.forward`` spans
(``infer/tiled.py``), one a batch, summed under each profiled ``scene``
span, mean over the scenes."""

from benchmark import spans


def read(record: dict):
    return spans.mean_per(spans.records(), "scene", ("scene.forward",), device=True)
