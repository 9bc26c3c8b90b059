"""Host seconds a CLI scene in reading its GeoTIFFs (``open_raster`` and
``TileDataset``): the program's ``cli.read`` spans (``predict.py``) under
each profiled ``cli.run`` span, mean over the runs."""

from benchmark import spans


def read(record: dict):
    return spans.mean_per(spans.records(), "cli.run", ("cli.read",), scale=1e-3)
