"""The weight carrier between the JAX layout and the torch modules.

Port of ``resdepth_tpu/models/torch_import.py`` and the read side of
``resdepth_tpu/train/checkpoint.py``. Every reader returns a state_dict in
the reference key layout that ``models.unet.UNet`` loads verbatim, and
``jax_params_from_state_dict`` goes the other way, so that the port writes
checkpoints the JAX package restores. Adam moments cross between torch's
optimizer state (indexed by ``model.parameters()`` order, the reference's
order) and the optax ``mu``/``nu`` trees the same way.

Layout conversions (JAX HWIO -> torch, and back):
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
    ``bn_state=None`` gives the parameters alone (no BatchNorm buffers), as
    for a tree of Adam moments.
    """
    sd: dict = {}

    def put_conv(prefix, layer):
        sd[f"{prefix}.weight"] = _tensor(layer["kernel"]).permute(3, 2, 0, 1).contiguous()
        if "bias" in layer:
            sd[f"{prefix}.bias"] = _tensor(layer["bias"])

    def put_bn(prefix, bn_params, bn_stats):
        sd[f"{prefix}.weight"] = _tensor(bn_params["scale"])
        sd[f"{prefix}.bias"] = _tensor(bn_params["bias"])
        if bn_stats is None:
            return
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
            put_bn(f"{prefix}.1", block["bn"],
                   None if block_state is None else block_state["bn"])
        if act_fn == "prelu":
            sd[f"{prefix}.{act_index}.weight"] = _tensor(block["act"]["alpha"])

    def state_of(section, index=None):
        if bn_state is None:
            return None
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
               None if bn_state is None else bn_state["outer_skip_bn"]["bn"])
    return sd


def _array(tensor) -> np.ndarray:
    return np.array(tensor.detach().cpu().float().numpy(), dtype=np.float32)


def jax_params_from_state_dict(sd: dict, config: UNetConfig):
    """``(params, bn_state)`` nested numpy trees in the JAX layout (the
    structure ``resdepth_tpu.models.unet.init_unet`` builds) from a
    reference-layout state_dict; the inverse of ``state_dict_from_jax_params``.
    A state_dict without BatchNorm buffers (a tree of Adam moments) gives
    ``bn_state`` None."""
    has_bn = config.do_BN or (config.outer_skip and config.outer_skip_BN)
    with_state = not has_bn or any(k.endswith("running_mean") for k in sd)
    act_index = 2 if config.do_BN else 1

    def conv(prefix):
        layer = {"kernel": _array(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}
        if f"{prefix}.bias" in sd:
            layer["bias"] = _array(sd[f"{prefix}.bias"])
        return layer

    def bn(prefix):
        stats = ({"mean": _array(sd[f"{prefix}.running_mean"]),
                  "var": _array(sd[f"{prefix}.running_var"])}
                 if with_state else None)
        return {"scale": _array(sd[f"{prefix}.weight"]),
                "bias": _array(sd[f"{prefix}.bias"])}, stats

    def up(prefix):
        if config.up_mode == "transpose":
            return {"kernel": _array(sd[f"{prefix}.weight"]).transpose(2, 3, 0, 1),
                    "bias": _array(sd[f"{prefix}.bias"])}
        return conv(f"{prefix}.1")

    def block(prefix, act_fn):
        out, state = {"conv": conv(f"{prefix}.0")}, {}
        if config.do_BN:
            out["bn"], stats = bn(f"{prefix}.1")
            state = {"bn": stats}
        if act_fn == "prelu":
            out["act"] = {"alpha": _array(sd[f"{prefix}.{act_index}.weight"])}
        return out, state

    params: dict = {"encoder": [], "decoder": []}
    bn_state: dict = {"encoder": [], "decoder": []}
    for i in range(config.depth):
        b, st = block(f"encoder.{i}.0", config.act_fn_encoder)
        params["encoder"].append(b)
        bn_state["encoder"].append(st)
    params["bottleneck"], bn_state["bottleneck"] = block(
        "bottleneck", config.act_fn_bottleneck)
    for i in range(config.depth - 1):
        b, st = block(f"decoder.{i}.1", config.act_fn_decoder)
        b["up"] = up(f"decoder.{i}.0")
        params["decoder"].append(b)
        bn_state["decoder"].append(st)
    params["decoder"].append({"up": up(f"decoder.{config.depth - 1}")})
    bn_state["decoder"].append({})
    params["last"] = conv("last_layer")
    if config.outer_skip and config.outer_skip_BN:
        params["outer_skip_bn"], stats = bn("layer_outer_skip.0")
        bn_state["outer_skip_bn"] = {"bn": stats}
    return params, (bn_state if with_state else None)


def flatten_keystr(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` with the paths ``jax.tree_util.keystr`` prints for
    nested dicts and lists (``['encoder'][0]['conv']['kernel']``); dict keys
    in sorted order, as JAX flattens them."""
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(flatten_keystr(tree[key], f"{prefix}['{key}']"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for index, item in enumerate(tree):
            out.update(flatten_keystr(item, f"{prefix}[{index}]"))
        return out
    return {prefix: tree}


def adam_moments_to_jax(model, optimizer, config: UNetConfig):
    """``(mu, nu, count)`` of a ``torch.optim.Adam`` over ``model``'s
    parameters as the trees of optax's ``ScaleByAdamState`` (JAX layout).
    Parameters without state (as before the first step) get zero moments;
    ``count`` is the largest step (optax keeps one count)."""
    mu_sd, nu_sd, count = {}, {}, 0
    for name, param in model.named_parameters():
        entry = optimizer.state.get(param, {})
        if "exp_avg" not in entry:
            mu_sd[name] = nu_sd[name] = torch.zeros_like(param)
            continue
        mu_sd[name] = entry["exp_avg"]
        nu_sd[name] = entry["exp_avg_sq"]
        count = max(count, int(entry["step"]))
    return (jax_params_from_state_dict(mu_sd, config)[0],
            jax_params_from_state_dict(nu_sd, config)[0], count)


def adam_moments_from_jax(model, optimizer, config: UNetConfig, mu, nu,
                          count: int) -> None:
    """Set a ``torch.optim.Adam``'s state from optax moment trees (JAX
    layout) and a step count, for every parameter of ``model``."""
    mu_sd = state_dict_from_jax_params(mu, None, config)
    nu_sd = state_dict_from_jax_params(nu, None, config)
    adam_state_from_state_dicts(model, optimizer, mu_sd, nu_sd, count)


def adam_state_from_state_dicts(model, optimizer, mu_sd: dict, nu_sd: dict,
                                count: int) -> None:
    """Set Adam's per-parameter state from moment state_dicts keyed like
    ``model``'s parameters, all at step ``count``."""
    for name, param in model.named_parameters():
        optimizer.state[param] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu_sd[name].detach().to(param).clone(),
            "exp_avg_sq": nu_sd[name].detach().to(param).clone()}


def unflatten_keystr(flat: dict) -> dict:
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


def read_npz_trees(path: str) -> dict:
    """Every tree of a JAX ``.npz`` checkpoint (``train/checkpoint.py::
    save_checkpoint``), read with numpy alone: ``params``, ``bn_state`` and
    ``raw_params`` as nested numpy trees (``raw_params`` None when absent),
    ``opt_state`` as ``{keystr suffix: array}`` (empty for SGD)."""
    flat: dict = {"params": {}, "bn_state": {}, "raw_params": {}, "opt_state": {}}
    with np.load(path) as blob:
        for key in blob.files:
            for name in flat:
                if key.startswith(name + "[") or key.startswith(name + "."):
                    flat[name][key[len(name):]] = blob[key]
    if not flat["params"]:
        raise KeyError(f"Checkpoint {path!r} holds no 'params' leaves")
    return {"params": unflatten_keystr(flat["params"]),
            "bn_state": unflatten_keystr(flat["bn_state"]),
            "raw_params": unflatten_keystr(flat["raw_params"]) if flat["raw_params"] else None,
            "opt_state": flat["opt_state"]}


def _model_state_dict(blob) -> dict:
    state_dict = blob.get("model_state_dict", blob) if isinstance(blob, dict) else blob
    return {k: v.detach().cpu() for k, v in state_dict.items()
            if isinstance(v, torch.Tensor)}


def read_pth_state_dict(path: str) -> dict:
    """Model state_dict of a reference ``.pth`` checkpoint: the
    ``model_state_dict`` entry of a ``torch.save`` payload, or a bare
    state_dict."""
    return _model_state_dict(torch.load(path, map_location="cpu",
                                        weights_only=False))


_BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")


def read_reference_checkpoint(path: str, want_adam: bool = True):
    """One-pass read of a reference ``.pth`` (``torch_import.py::
    load_reference_checkpoint``) -> ``(state_dict, adam, meta)``.

    ``adam`` is ``(mu, nu, count)``, the optimizer's moments as state_dicts
    keyed by parameter name, or None without an optimizer state. The
    reference's optimizer state indexes parameters by position, the
    state_dict's order without buffers; parameters it never stepped get
    zero moments and ``count`` is the largest step. ``meta`` holds the
    epoch, val loss, the optimizer's lr and the translated scheduler state.
    """
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = _model_state_dict(blob)
    adam = None
    if want_adam and isinstance(blob, dict) and "optimizer_state_dict" in blob:
        names = [k for k in blob["model_state_dict"] if not k.endswith(_BUFFER_SUFFIXES)]
        mu, nu, count = {}, {}, 0
        for index, name in enumerate(names):
            entry = blob["optimizer_state_dict"]["state"].get(index)
            if entry is None:
                mu[name] = nu[name] = torch.zeros_like(state_dict[name])
                continue
            mu[name] = entry["exp_avg"].detach().cpu()
            nu[name] = entry["exp_avg_sq"].detach().cpu()
            count = max(count, int(entry["step"]))
        adam = (mu, nu, count)

    meta = {"epoch": -1, "loss_val": None, "lr": None, "scheduler_state": None}
    if isinstance(blob, dict):
        if "epoch" in blob:
            meta["epoch"] = int(blob["epoch"])
        if blob.get("loss_val") is not None:
            meta["loss_val"] = float(blob["loss_val"])
        opt = blob.get("optimizer_state_dict")
        groups = opt.get("param_groups") if isinstance(opt, dict) else None
        if groups and groups[0].get("lr") is not None:
            meta["lr"] = float(groups[0]["lr"])
        if isinstance(blob.get("scheduler_state_dict"), dict):
            meta["scheduler_state"] = scheduler_state_from_torch(
                blob["scheduler_state_dict"], lr=meta["lr"])
    return state_dict, adam, meta


def scheduler_state_from_torch(sched_sd: dict, lr: float | None = None) -> dict:
    """A torch LR-scheduler state_dict as the state of the shared
    ``resdepth_tpu.train.schedulers`` (``torch_import.py::
    scheduler_state_from_torch``): StepLR and ExponentialLR carry
    ``last_epoch``, ``_last_lr`` and ``base_lrs``; ReduceLROnPlateau its
    bookkeeping and no lr of its own (pass the optimizer's as ``lr``).
    Only keys present in the source appear in the result."""
    out: dict = {}
    if "last_epoch" in sched_sd:
        out["n_steps"] = int(sched_sd["last_epoch"])
    if sched_sd.get("_last_lr"):
        out["lr"] = float(sched_sd["_last_lr"][0])
    if sched_sd.get("base_lrs"):
        out["initial_lr"] = float(sched_sd["base_lrs"][0])
    for src, dst in (("step_size", "step_size"), ("gamma", "gamma"),
                     ("factor", "factor"), ("patience", "patience"),
                     ("threshold", "threshold"),
                     ("threshold_mode", "threshold_mode"),
                     ("cooldown", "cooldown"),
                     ("cooldown_counter", "cooldown_counter"),
                     ("best", "best"), ("num_bad_epochs", "num_bad"),
                     ("eps", "eps")):
        if src in sched_sd:
            out[dst] = sched_sd[src]
    if sched_sd.get("min_lrs"):
        out["min_lr"] = float(sched_sd["min_lrs"][0])
    if "lr" not in out and lr is not None:
        out["lr"] = float(lr)
    return out


def load_state_dict(path: str, config: UNetConfig) -> dict:
    """Reference-layout state_dict from a ``.pth`` file or a JAX ``.npz``
    checkpoint (any other extension is read as ``.npz``, as ``test.py``
    does)."""
    if path.endswith(".pth"):
        return read_pth_state_dict(path)
    trees = read_npz_trees(path)
    return state_dict_from_jax_params(trees["params"], trees["bn_state"], config)


def export_checkpoint(path: str, model_or_state_dict, *, epoch: int = 0,
                      loss_train=None, loss_val=None) -> None:
    """Write a reference-compatible ``.pth`` checkpoint: ``epoch``,
    ``model_state_dict`` (reference keys, on the CPU), ``loss_train`` and
    ``loss_val``, the payload of ``torch_import.py::export_checkpoint``
    (``lib/Trainer.py``'s, without the optimizer state). Takes a ``UNet``
    or its state_dict."""
    sd = (model_or_state_dict.state_dict() if isinstance(model_or_state_dict, torch.nn.Module)
          else model_or_state_dict)
    torch.save({"epoch": epoch,
                "model_state_dict": {k: v.detach().cpu() for k, v in sd.items()},
                "loss_train": loss_train, "loss_val": loss_val}, path)
