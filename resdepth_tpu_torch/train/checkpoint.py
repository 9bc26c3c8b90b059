"""Checkpoints in the JAX package's ``.npz`` layout (port of
``resdepth_tpu/train/checkpoint.py``).

One ``.npz`` holds every leaf under the key path ``jax.tree_util.keystr``
gives it in the JAX trees (``params['encoder'][0]['conv']['kernel']`` in
HWIO, ``bn_state...``, ``raw_params...`` under a weight EMA, and the optax
optimizer state ``opt_state...``), plus a ``__meta__`` JSON blob with
``format_version`` 1. So a checkpoint the port writes restores in the JAX
``load_checkpoint``, and one JAX writes resumes in the port. Roles as in the
reference: ``Model_best``, ``Model_after_{N}_epochs``, ``Model_last``.
"""

from __future__ import annotations

import io
import json
import os
import threading

import numpy as np

from resdepth_tpu_torch.models.weights import (flatten_keystr, read_npz_trees,
                                              unflatten_keystr)

_META_KEY = "__meta__"


def opt_state_leaves(optimizer_name: str, weight_decay: float,
                     adam=None) -> dict:
    """``{keystr suffix: array}`` of the JAX optimizer state: for Adam the
    ``count``, ``mu`` and ``nu`` of ``adam`` = ``(mu, nu, count)``
    (``models.weights.adam_moments_to_jax``); SGD's state has no leaves."""
    if optimizer_name != "Adam":
        return {}
    mu, nu, count = adam
    # optax's ScaleByAdamState is the second link of a chain after
    # add_decayed_weights under weight decay, the whole state otherwise
    # (resdepth_tpu/train/optim.py::build_optimizer).
    prefix = "[1]" if weight_decay else ""
    leaves = {f"{prefix}.count": np.asarray(count, np.int32)}
    for name, tree in (("mu", mu), ("nu", nu)):
        for key, leaf in flatten_keystr(tree).items():
            leaves[f"{prefix}.{name}{key}"] = leaf
    return leaves


def adam_from_opt_state(opt_state: dict):
    """``(mu, nu, count)`` back from ``read_npz_trees``' ``opt_state``, with
    or without the chain index; None when it holds no Adam state."""
    parts: dict = {"mu": {}, "nu": {}}
    count = None
    for key, leaf in opt_state.items():
        rest = key[len("[1]"):] if key.startswith("[1]") else key
        if rest == ".count":
            count = int(leaf)
        for name in parts:
            if rest.startswith(f".{name}["):
                parts[name][rest[len(name) + 1:]] = leaf
    if count is None:
        return None
    return unflatten_keystr(parts["mu"]), unflatten_keystr(parts["nu"]), count


def save_checkpoint(path: str, *, epoch: int, params, bn_state,
                    opt_state: dict | None = None, raw_params=None,
                    lr: float | None = None, loss_train=None, loss_val=None,
                    scheduler_state: dict | None = None,
                    extra: dict | None = None) -> None:
    """Write a checkpoint ``.npz``. ``params``, ``bn_state`` and
    ``raw_params`` are nested numpy trees in the JAX layout
    (``models.weights.jax_params_from_state_dict``); ``opt_state`` is
    ``opt_state_leaves``' dict. Under a weight EMA ``params`` holds the
    served (EMA) weights and ``raw_params`` the optimizer's iterate. The
    file appears whole or not at all: written to a temporary name, then
    renamed."""
    arrays = {}
    for name, tree in (("params", params), ("bn_state", bn_state),
                       ("raw_params", raw_params)):
        if tree is not None:
            for key, leaf in flatten_keystr(tree).items():
                arrays[f"{name}{key}"] = np.asarray(leaf)
    for key, leaf in (opt_state or {}).items():
        arrays[f"opt_state{key}"] = np.asarray(leaf)
    meta = {
        "epoch": int(epoch),
        "lr": None if lr is None else float(lr),
        "loss_train": None if loss_train is None else float(loss_train),
        "loss_val": None if loss_val is None else float(loss_val),
        "scheduler_state": scheduler_state,
        "format_version": 1,
    }
    if extra:
        meta.update(extra)
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)

    buffer = io.BytesIO()
    np.savez(buffer, **arrays)
    tmp_path = f"{path}.tmp"
    with open(tmp_path, "wb") as f:
        f.write(buffer.getvalue())
    os.replace(tmp_path, path)


def load_meta(path: str) -> dict:
    """A checkpoint's metadata alone (``np.load`` reads members lazily)."""
    with np.load(path) as blob:
        return json.loads(bytes(blob[_META_KEY].tobytes()).decode())


def load_checkpoint(path: str) -> dict:
    """``{"meta", "params", "bn_state", "raw_params", "adam"}``: the trees
    as numpy in the JAX layout, ``raw_params`` None without an EMA, ``adam``
    the ``(mu, nu, count)`` of an Adam state or None."""
    trees = read_npz_trees(path)
    trees["meta"] = load_meta(path)
    trees["adam"] = adam_from_opt_state(trees.pop("opt_state"))
    return trees


class AsyncCheckpointer:
    """Writes checkpoints in a background thread. The caller hands over
    host (numpy) snapshots, so training goes on while the file is written;
    saves serialise through one writer, and ``wait()`` joins it and
    re-raises its error, if any."""

    def __init__(self):
        self._thread = None
        self._error = None

    def save(self, path: str, **kwargs) -> None:
        self.wait()

        def work():
            try:
                save_checkpoint(path, **kwargs)
            except Exception as exc:  # surfaced on the next wait()/save()
                self._error = exc

        # Non-daemon: interpreter exit joins the writer instead of killing
        # it mid-write.
        self._thread = threading.Thread(target=work, daemon=False,
                                        name="ckpt-writer")
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error
