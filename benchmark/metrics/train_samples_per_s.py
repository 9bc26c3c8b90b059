"""Samples trained in the window's epochs over the wall from the window's
start to the sync after its last step."""


def read(record: dict):
    if "samples" not in record or not record["samples"]:
        return None
    return record["samples"] / record["window_wall_s"]
