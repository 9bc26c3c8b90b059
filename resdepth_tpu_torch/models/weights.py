"""Checkpoint readers: JAX ``.npz`` checkpoints and reference ``.pth`` files.

Port of the load side of ``resdepth_tpu/models/torch_import.py`` and
``resdepth_tpu/train/checkpoint.py``. Every reader returns a state_dict in
the reference key layout that ``models.unet.UNet`` loads verbatim.

Layout conversions (JAX HWIO -> torch):
  * conv kernel (kH, kW, I, O)             -> Conv2d weight (O, I, kH, kW)
  * transposed-conv kernel (2, 2, I, O)    -> ConvTranspose2d weight (I, O, 2, 2)
  * bn scale/bias, bn state mean/var       -> BatchNorm2d weight/bias,
                                              running_mean/running_var
"""

from __future__ import annotations

import re

import numpy as np
import torch

from resdepth_tpu_torch.models.unet import UNetConfig

_KEYSTR_PART = re.compile(r"\[(?:'([^']*)'|(\d+))\]")


def _tensor(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value, dtype=np.float32))


def state_dict_from_jax_params(params, bn_state, config: UNetConfig) -> dict:
    """Reference-layout state_dict from JAX ``(params, bn_state)`` pytrees.

    Takes nested dicts and lists of numpy arrays (or anything ``np.array``
    reads), as ``init_unet`` or ``load_checkpoint`` produce them. State
    entries without leaves (blocks without BatchNorm) may be missing.
    """
    sd: dict = {}

    def put_conv(prefix, layer):
        sd[f"{prefix}.weight"] = _tensor(layer["kernel"]).permute(3, 2, 0, 1).contiguous()
        if "bias" in layer:
            sd[f"{prefix}.bias"] = _tensor(layer["bias"])

    def put_bn(prefix, bn_params, bn_stats):
        sd[f"{prefix}.weight"] = _tensor(bn_params["scale"])
        sd[f"{prefix}.bias"] = _tensor(bn_params["bias"])
        sd[f"{prefix}.running_mean"] = _tensor(bn_stats["mean"])
        sd[f"{prefix}.running_var"] = _tensor(bn_stats["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    def put_up(prefix, layer):
        if config.up_mode == "transpose":
            sd[f"{prefix}.weight"] = _tensor(layer["kernel"]).permute(2, 3, 0, 1).contiguous()
            sd[f"{prefix}.bias"] = _tensor(layer["bias"])
        else:
            put_conv(f"{prefix}.1", layer)

    act_index = 2 if config.do_BN else 1

    def put_block(prefix, block, block_state, act_fn):
        put_conv(f"{prefix}.0", block["conv"])
        if config.do_BN:
            put_bn(f"{prefix}.1", block["bn"], block_state["bn"])
        if act_fn == "prelu":
            sd[f"{prefix}.{act_index}.weight"] = _tensor(block["act"]["alpha"])

    def state_of(section, index=None):
        entry = bn_state.get(section, [] if index is not None else {})
        if index is None:
            return entry
        return entry[index] if index < len(entry) else {}

    for i, block in enumerate(params["encoder"]):
        put_block(f"encoder.{i}.0", block, state_of("encoder", i),
                  config.act_fn_encoder)
    put_block("bottleneck", params["bottleneck"], state_of("bottleneck"),
              config.act_fn_bottleneck)
    for i in range(config.depth - 1):
        put_up(f"decoder.{i}.0", params["decoder"][i]["up"])
        put_block(f"decoder.{i}.1", params["decoder"][i],
                  state_of("decoder", i), config.act_fn_decoder)
    put_up(f"decoder.{config.depth - 1}", params["decoder"][-1]["up"])
    put_conv("last_layer", params["last"])
    if config.outer_skip and config.outer_skip_BN:
        put_bn("layer_outer_skip.0", params["outer_skip_bn"],
               bn_state["outer_skip_bn"]["bn"])
    return sd


def _unflatten(flat: dict) -> dict:
    """Nested dicts/lists from ``jax.tree_util.keystr`` leaf paths such as
    ``['encoder'][0]['conv']['kernel']``."""
    root: dict = {}
    for path, value in flat.items():
        parts = [name if name else int(index)
                 for name, index in _KEYSTR_PART.findall(path)]
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        children = {k: listify(v) for k, v in node.items()}
        if children and all(isinstance(k, int) for k in children):
            return [children[i] for i in range(len(children))]
        return children

    return listify(root)


def read_npz_checkpoint(path: str) -> tuple[dict, dict]:
    """``(params, bn_state)`` nested numpy trees from a JAX ``.npz``
    checkpoint (``train/checkpoint.py::save_checkpoint``), read with numpy
    alone."""
    trees: dict = {"params": {}, "bn_state": {}}
    with np.load(path) as blob:
        for key in blob.files:
            for name in trees:
                if key.startswith(name + "["):
                    trees[name][key[len(name):]] = blob[key]
    if not trees["params"]:
        raise KeyError(f"Checkpoint {path!r} holds no 'params' leaves")
    return _unflatten(trees["params"]), _unflatten(trees["bn_state"])


def read_pth_state_dict(path: str) -> dict:
    """Model state_dict of a reference ``.pth`` checkpoint: the
    ``model_state_dict`` entry of a ``torch.save`` payload, or a bare
    state_dict."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = blob.get("model_state_dict", blob) if isinstance(blob, dict) else blob
    return {k: v.detach().cpu() for k, v in state_dict.items()
            if isinstance(v, torch.Tensor)}


def load_state_dict(path: str, config: UNetConfig) -> dict:
    """Reference-layout state_dict from a ``.pth`` file or a JAX ``.npz``
    checkpoint (any other extension is read as ``.npz``, as ``test.py``
    does)."""
    if path.endswith(".pth"):
        return read_pth_state_dict(path)
    params, bn_state = read_npz_checkpoint(path)
    return state_dict_from_jax_params(params, bn_state, config)
