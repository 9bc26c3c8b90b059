"""Host seconds a CLI scene in building the served model (``UNet``,
``load_state_dict``, ``serving_model``): the program's ``cli.model`` span
(``predict.py``) under each profiled ``cli.run`` span, mean over the runs."""

from benchmark import spans


def read(record: dict):
    return spans.mean_per(spans.records(), "cli.run", ("cli.model",), scale=1e-3)
