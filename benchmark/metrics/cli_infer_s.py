"""Host seconds a CLI scene in refining it and fetching the result: the
program's ``cli.infer`` and ``cli.fetch`` spans (``predict.py``) under each
profiled ``cli.run`` span, mean over the runs."""

from benchmark import spans


def read(record: dict):
    return spans.mean_per(spans.records(), "cli.run", ("cli.infer", "cli.fetch"),
                          scale=1e-3)
