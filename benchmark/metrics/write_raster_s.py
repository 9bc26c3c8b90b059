"""Host seconds a scene in ``geo/raster.py::write_raster`` (the refined
DSM and the residuals), summed over its calls, over the scenes after the
profiled part."""


def read(record: dict):
    seconds = record.get("host_seconds", {}).get("write_raster")
    return seconds / record["timed_scenes"] if seconds else None
