"""Attribute-access dictionaries for config trees.

The reference pipeline threads an ``easydict.EasyDict`` config through every
layer (e.g. the reference's lib/config.py:7). ``easydict`` is not available in
this environment, so the framework ships its own minimal equivalent with the
same ergonomics: recursive attribute access, auto-wrapping of nested dicts,
and transparent JSON serialisation (it *is* a dict).

The port's copy of ``resdepth_tpu/utils/attrdict.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

from __future__ import annotations

import copy


class AttrDict(dict):
    """A dict whose string keys are also attributes; nests recursively."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        data = dict(*args, **kwargs)
        for key, value in data.items():
            self[key] = value

    @staticmethod
    def _wrap(value):
        if isinstance(value, AttrDict):
            return value
        if isinstance(value, dict):
            return AttrDict(value)
        if isinstance(value, (list, tuple)):
            return type(value)(AttrDict._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, AttrDict._wrap(value))

    def __setattr__(self, name, value):
        self[name] = value

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def update(self, *args, **kwargs):
        # dict.update is C-level and bypasses __setitem__; route through it
        # so merged values keep attribute access (nested dicts get wrapped).
        for key, value in dict(*args, **kwargs).items():
            self[key] = value

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]

    def __deepcopy__(self, memo):
        out = AttrDict()
        memo[id(self)] = out
        for key, value in self.items():
            dict.__setitem__(out, key, copy.deepcopy(value, memo))
        return out

    def copy(self):
        return copy.deepcopy(self)
