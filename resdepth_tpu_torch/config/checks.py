"""Typed value checkers shared by the train/inference config validators.

Parity with the reference's lib/validate_arguments.py:4-171.

The port's copy of ``resdepth_tpu/config/checks.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

from __future__ import annotations



def _emit(logger, message: str) -> None:
    if logger:
        logger.error(message)
    else:
        print(f"ERROR: {message}")


def all_keys_known(dictionary, known_keys, logger=None) -> bool:
    unknown = [k for k in dictionary if k not in known_keys]
    if unknown:
        _emit(logger, "The following keys are unknown: {}.\n".format(
            ",".join(f"'{k}'" for k in unknown)))
        return False
    return True


def is_boolean(value, arg_name, logger=None) -> bool:
    if not isinstance(value, bool):
        _emit(logger, f"Invalid value for the argument '{arg_name}': {value}. Specify a boolean.\n")
        return False
    return True


def is_string(value, arg_name, logger=None) -> bool:
    if not isinstance(value, str):
        _emit(logger, f"Invalid value for the argument '{arg_name}': {value}. Specify a string.\n")
        return False
    return True


def is_positive_integer(value, arg_name, logger=None, zero_allowed=False) -> bool:
    lo = 0 if zero_allowed else 1
    if type(value) is not int or value < lo:
        kind = "an integer >= 0" if zero_allowed else "a positive integer"
        _emit(logger, f"Invalid value for the argument '{arg_name}': {value}. Specify {kind}.\n")
        return False
    return True


def is_positive_number(value, arg_name, logger=None, zero_allowed=False) -> bool:
    ok = isinstance(value, (int, float)) and not isinstance(value, bool)
    if ok:
        ok = value >= 0 if zero_allowed else value > 0
    if not ok:
        _emit(logger, f"Invalid value for the argument '{arg_name}': {value}. Specify a positive number.\n")
        return False
    return True


def in_enum(value, valid_values, arg_name, logger=None) -> bool:
    if value not in valid_values:
        _emit(logger, f"Invalid value for the argument '{arg_name}': '{value}'. "
                      f"Choose among {valid_values}.\n")
        return False
    return True


def valid_tile_size(value, arg_name, min_power=4, logger=None) -> bool:
    """Tile size must be a power of two in [2^min_power, 2^11].

    ``min_power = depth + 2`` ensures the bottleneck resolution stays >= 4 px
    (reference check: lib/validate_arguments.py:143-171).
    """
    valid = [2 ** i for i in range(min_power, 12)]
    if not isinstance(value, int) or value not in valid:
        _emit(logger, f"Invalid value for the argument {arg_name}: {value}. Choose among {valid}.\n")
        return False
    return True
