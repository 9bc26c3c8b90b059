"""Export a checkpoint as a reference-compatible ``.pth`` file (the port of
``scripts/export_torch.py``).

    python -m resdepth_tpu_torch.export_torch <checkpoint.npz> <model_config.json> <out.pth>

Reads the ``.npz`` (the JAX layout, written by either package) with
``train/checkpoint.py`` and writes ``epoch``, ``model_state_dict`` in the
reference's keys, ``loss_train`` and ``loss_val``
(``models.weights.export_checkpoint``). The file loads into the reference
PyTorch implementation (``UNet(**model_config['settings'])
.load_state_dict(torch.load(out)['model_state_dict'])``) and into the
port's ``models.unet.UNet``.
"""

from __future__ import annotations

import sys

from resdepth_tpu_torch.config import io as cfg_io
from resdepth_tpu_torch.models.unet import unet_config_from_settings
from resdepth_tpu_torch.models.weights import (export_checkpoint,
                                               state_dict_from_jax_params)
from resdepth_tpu_torch.train import checkpoint as ckpt_io


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 3:
        print(__doc__)
        sys.exit(1)
    ckpt_path, arch_path, out_path = argv
    config = unet_config_from_settings(cfg_io.read_json(arch_path).settings)
    loaded = ckpt_io.load_checkpoint(ckpt_path)
    meta = loaded["meta"]
    export_checkpoint(out_path,
                      state_dict_from_jax_params(loaded["params"], loaded["bn_state"],
                                                 config),
                      epoch=meta.get("epoch", 0), loss_train=meta.get("loss_train"),
                      loss_val=meta.get("loss_val"))
    print(f"Exported {ckpt_path} (epoch {meta.get('epoch')}) -> {out_path}")


if __name__ == "__main__":
    main()
