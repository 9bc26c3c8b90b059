"""The port's reference ``.pth`` export (``models.weights.export_checkpoint``
and ``python -m resdepth_tpu_torch.export_torch``) against the JAX
package's (``resdepth_tpu.models.torch_import.export_checkpoint`` through
``scripts/export_torch.py``) on the same ``.npz`` checkpoint, on the CPU.

Both files hold the same payload (``epoch``, ``model_state_dict``,
``loss_train``, ``loss_val``) with the same keys in the same order, every
tensor bitwise equal in value, dtype and shape. The port's file then loads
into the port's ``UNet``, whose forward is bitwise that of the model built
from the ``.npz`` (the same weights).
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from resdepth_tpu.models import unet as junet
from resdepth_tpu.train.checkpoint import save_checkpoint
from resdepth_tpu_torch import export_torch
from resdepth_tpu_torch.models import unet as tunet
from resdepth_tpu_torch.models import weights
from test_torch_unet import CASES, _jax_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _checkpoint(tmp_path, case):
    """A JAX-layout ``.npz`` and its ``model_config.json`` for a small UNet
    of one of ``test_torch_unet.CASES``."""
    mode, n_in, overrides = case
    config = junet.UNetConfig(n_input_channels=n_in, depth=2, start_kernel=4,
                              max_filter_depth=8, **overrides)
    params, state = _jax_weights(config, seed=3)
    npz = str(tmp_path / "Model_best.npz")
    save_checkpoint(npz, epoch=7, params=params, bn_state=state, loss_train=0.25,
                    loss_val=0.125)
    arch = str(tmp_path / "model_config.json")
    with open(arch, "w") as f:
        json.dump({"name": "ResDepth", "input_channels": mode,
                   "settings": dataclasses.asdict(config)}, f)
    return npz, arch, tunet.UNetConfig(**dataclasses.asdict(config))


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[3]],
                         ids=["geom", "geom-stereo-prelu-bn-skip", "stereo-bilinear"])
def test_export_is_bitwise_the_jax_export(tmp_path, monkeypatch, case):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import export_torch as jax_export
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    npz, arch, config = _checkpoint(tmp_path, case)
    port_pth, jax_pth = str(tmp_path / "port.pth"), str(tmp_path / "jax.pth")
    export_torch.main([npz, arch, port_pth])
    monkeypatch.setattr(sys, "argv", ["export_torch.py", npz, arch, jax_pth])
    jax_export.main()

    port, want = (torch.load(p, map_location="cpu", weights_only=False)
                  for p in (port_pth, jax_pth))
    assert list(port) == list(want) == ["epoch", "model_state_dict", "loss_train",
                                        "loss_val"]
    assert (port["epoch"], port["loss_train"], port["loss_val"]) == (7, 0.25, 0.125)
    assert (want["epoch"], want["loss_train"], want["loss_val"]) == (7, 0.25, 0.125)
    got_sd, want_sd = port["model_state_dict"], want["model_state_dict"]
    assert list(got_sd) == list(want_sd)
    for key, value in want_sd.items():
        assert got_sd[key].dtype == value.dtype and got_sd[key].shape == value.shape, key
        assert torch.equal(got_sd[key], value), key

    model = tunet.UNet(config)
    model.load_state_dict(got_sd)
    reference = tunet.UNet(config)
    reference.load_state_dict(weights.load_state_dict(npz, config))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 16, 16, config.n_input_channels)).astype(np.float32))
    with torch.inference_mode():
        assert torch.equal(tunet.apply_unet(model.eval(), x),
                           tunet.apply_unet(reference.eval(), x))


def test_export_takes_a_model(tmp_path):
    """``export_checkpoint`` takes the module itself too: its state_dict,
    on the CPU."""
    model = tunet.init_unet(tunet.UNetConfig(n_input_channels=3, depth=2, start_kernel=4,
                                             max_filter_depth=8),
                            torch.Generator().manual_seed(0))
    path = str(tmp_path / "m.pth")
    weights.export_checkpoint(path, model, epoch=3)
    blob = torch.load(path, map_location="cpu", weights_only=False)
    assert (blob["epoch"], blob["loss_train"], blob["loss_val"]) == (3, None, None)
    assert blob["model_state_dict"].keys() == model.state_dict().keys()
    assert all(torch.equal(blob["model_state_dict"][k], v)
               for k, v in model.state_dict().items())
