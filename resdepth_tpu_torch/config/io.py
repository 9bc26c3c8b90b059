"""Config file IO and recursive merging.

Parity with the reference's lib/cfg_utils.py:7-90: JSON read/write/print, a
recursive user-over-default merge that deep-copies both sides, and pruning of
obsolete sections.

The port's copy of ``resdepth_tpu/config/io.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

from __future__ import annotations

import copy
import json
from collections.abc import Mapping

from resdepth_tpu_torch.utils.attrdict import AttrDict


def read_json(file: str) -> AttrDict:
    """Read a JSON config file; returns an empty AttrDict on parse failure."""
    try:
        with open(file) as f:
            cfg = json.load(f)
    except json.JSONDecodeError:
        print(f"ERROR: Cannot read the file: {file}")
        return AttrDict()
    return AttrDict(cfg)


def write_json(data, outfile: str) -> None:
    with open(outfile, "w") as f:
        json.dump(data, f, indent=2)


def print_json(cfg, sort_keys: bool = False, logger=None) -> None:
    if not isinstance(cfg, dict):
        cfg = read_json(cfg)
    text = json.dumps(cfg, indent=4, sort_keys=sort_keys)
    if logger:
        logger.info(text)
    else:
        print(text)


def merge(cfg_default, cfg_user) -> AttrDict:
    """Recursively merge ``cfg_user`` into a deep copy of ``cfg_default``.

    Values present in ``cfg_user`` win; nested mappings merge key-wise
    (reference behaviour: lib/cfg_utils.py:56-75).
    """
    result = copy.deepcopy(dict(cfg_default))
    for key, value in cfg_user.items():
        if isinstance(value, Mapping):
            result[key] = merge(result.get(key, {}) or {}, value)
        else:
            result[key] = copy.deepcopy(value)
    return AttrDict(result)


def remove_obsolete_keys(cfg) -> None:
    """Prune config sections that do not apply to the chosen model (in-place).

    Reference behaviour (lib/cfg_utils.py:78-90): the ``multiview`` section is
    dropped unless the input-channel mode is 'geom-multiview'.
    """
    if cfg.get("model", {}).get("input_channels") != "geom-multiview":
        cfg.pop("multiview", None)
