"""The JAX package's augmentation draws and initial weights, for the port
to replay (``tests/test_torch_convergence.py``; the init for runs on the
card).

    python tests/_jax_draws.py init --out INIT.npz --seed 0 [--depth 5
        --start-kernel 64 --max-filter-depth 512]

writes ``init_unet(PRNGKey(seed))`` of a geom-stereo model as an epoch -1
checkpoint without optimizer state (``model.pretrained_path``,
``convergence_study port --init``), the weights ``train.py`` starts from
at that ``random_seed``. Run from the repository root with
``JAX_PLATFORMS=cpu``; the file is for the card, which has no JAX.

``JaxReplay`` is a draw source of the port (``Trainer(draw_factory=)``,
``replay_factory``) that makes the draws from JAX's key chain:

* the trainer's ``fold_in(PRNGKey(random_seed), epoch)``
  (``resdepth_tpu/train/trainer.py:106,216``);
* the step's ``fold_in(key, state.step)``, then the device's index on the
  mesh (``resdepth_tpu/train/step.py:170-172``; ``train.py`` always trains
  on a mesh, of 1 device with ``tpu.data_parallel`` false);
* ``build_batch``'s ``split`` for the permutations (when it permutes),
  then its ``split`` for the augmentation
  (``resdepth_tpu/data/pipeline.py:228-260``), and in them ``split(perm_rng,
  B)`` a sample and ``split(aug_rng, 3)`` for the transpose, row-flip and
  column-flip bits (``:158-185``).
"""

import argparse
import os
import sys

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _StepDraws:
    """One train step's draws on the devices of ``keys`` (one key a
    device, its samples contiguous in the batch, as ``P(axes)`` shards it).
    Each call splits every device's key as ``build_batch`` does."""

    def __init__(self, keys):
        self.keys = list(keys)

    def _split(self) -> list:
        subs = []
        for i, key in enumerate(self.keys):
            self.keys[i], sub = jax.random.split(key)
            subs.append(sub)
        return subs

    def view_permutations(self, batch: int, n_views: int, device) -> torch.Tensor:
        subs = self._split()
        share = batch // len(subs)
        perms = [jax.vmap(lambda k: jax.random.permutation(k, n_views))(
                     jax.random.split(sub, share)) for sub in subs]
        return torch.from_numpy(np.concatenate([np.asarray(p) for p in perms])
                                .astype(np.int64)).to(device)

    def dihedral_bits(self, batch: int, device) -> torch.Tensor:
        subs = self._split()
        share = batch // len(subs)
        bits = [np.stack([np.asarray(jax.random.bernoulli(k, 0.5, (share,)))
                          for k in jax.random.split(sub, 3)]) for sub in subs]
        return torch.from_numpy(np.concatenate(bits, axis=1)).to(device)


class JaxReplay:
    """JAX's draws for one epoch of the port's steps on one process: the
    process holds the mesh's devices ``first_device`` ..
    ``first_device + devices - 1``."""

    def __init__(self, seed: int, epoch: int, devices: int = 1, first_device: int = 0):
        self.key = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
        self.devices = range(first_device, first_device + devices)

    def at_step(self, step: int) -> _StepDraws:
        key = jax.random.fold_in(self.key, step)
        return _StepDraws([jax.random.fold_in(key, d) for d in self.devices])


def replay_factory(seed: int, devices: int):
    """``Trainer(draw_factory=)`` for a JAX run on a mesh of ``devices``
    devices a process: rank r of the port holds devices r * devices .."""
    return lambda epoch, rank: JaxReplay(seed, epoch, devices, rank * devices)


def write_jax_init(path: str, seed: int, model: dict, adam: bool = True) -> str:
    """JAX's ``init_unet(PRNGKey(seed))`` for a geom-stereo ``model`` (the
    config ``train.py`` builds from those settings) as an epoch -1
    checkpoint: training from it starts at epoch 0. ``adam``: with a fresh
    Adam state (zero moments, count 0, which is how Adam starts without
    one)."""
    from resdepth_tpu.config.schema import count_input_channels
    from resdepth_tpu.models import unet as junet
    from resdepth_tpu.train import checkpoint as jckpt
    from resdepth_tpu.train.optim import build_optimizer

    config = junet.UNetConfig(n_input_channels=count_input_channels("geom-stereo"),
                              bias_conv_layer=True, **model)
    params, bn_state = junet.init_unet(jax.random.PRNGKey(seed), config)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    jckpt.save_checkpoint(path, epoch=-1, params=params, bn_state=bn_state,
                          opt_state=build_optimizer("Adam", 1e-5).init(params)
                          if adam else None)
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("init",))
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--start-kernel", type=int, default=64)
    ap.add_argument("--max-filter-depth", type=int, default=512)
    args = ap.parse_args(argv)
    write_jax_init(args.out, args.seed, dict(depth=args.depth,
                                             start_kernel=args.start_kernel,
                                             max_filter_depth=args.max_filter_depth),
                   adam=False)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
