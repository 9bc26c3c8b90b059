"""Host seconds a scene in ``evaluation/performance.py::evaluate_performance``,
timed around each call at the name the CLI calls
(``predict.evaluate_performance``), over the scenes after the profiled
part."""


def read(record: dict):
    seconds = record.get("host_seconds", {}).get("evaluate_performance")
    return seconds / record["timed_scenes"] if seconds else None
