"""Set-up: from the run's start to the window's (imports, inputs,
weights, the build or load of the kernels, the warm-up)."""


def read(record: dict):
    return record["setup_s"]
