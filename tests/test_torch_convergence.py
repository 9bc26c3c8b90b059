"""The port's training run against the JAX package's, given JAX's random
draws (ROADMAP section 3's fault: the port trained to a lower error).

The port draws augmentation and view permutations from a torch Philox
generator, the JAX package from threefry keys, so the two trainers never
saw the same batches. ``_jax_draws.JaxReplay`` (a test helper: it imports
JAX, the port does not) is a draw source for the port's ``build_batch``
(``resdepth_tpu_torch/data/pipeline.py::GeneratorDraws`` has its calls)
that makes JAX's draws from JAX's key chain, handed to the port's
Trainer through ``cli.main(..., draw_factory=)``.

Tests:

* the replayed bits and permutations are bitwise those of JAX's own
  ``_augment`` and ``_permutation_per_sample`` on the same keys, the
  port's default source draws as the generator did before the seam, and
  a replayed batch is JAX's
  ``build_batch``'s (within ``test_torch_pipeline.py``'s bars for the
  normalisation's f32 rounding);
* the decisive runs: ``train.py`` and the port's train CLI in this process,
  warm-started from one ``.npz`` of JAX's ``init_unet(PRNGKey(0))``, the
  port given JAX's draws (``cli.main(..., draw_factory=)``), on the golden
  pipeline's train config (``scripts/make_demo_data.py:127-139``: 4 epochs
  of 8 steps, augmentation on, JAX on its 8-device mesh as the goldens were
  made) and on ``test_torch_train.py``'s e2e config with augmentation and
  ``permute_images_within_pair`` on (2 epochs of 6 steps, a 1-device
  mesh). Per-epoch val MAE within 1e-4 m and the final weights within
  1e-4 relative L2 per tensor, the bars of
  ``test_torch_train.py::test_cli_trains_like_train_py``, or, where the
  same config's augmentation-off twin (run beside it, from the same init)
  misses that, within twice the twin's gap: after 32 Adam steps the two
  frameworks' sums in other orders move a small tensor that starts at
  zero (the golden model's bottleneck BatchNorm shift: 0.0254 relative L2
  with augmentation off, 0.0178 with JAX's draws, on this CPU) by a few
  per cent of its own norm, draws or no draws. Both gaps are printed, so a
  gap that only the draws open shows against the twin's;
* what the card then showed to matter, the init: the port's flagship init
  has JAX's per-tensor distribution, and a port run from its own seeded
  init is bitwise its run warm-started from the same weights.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from resdepth_tpu.data import pipeline as jpipe
from resdepth_tpu.data.dataset import TileDataset as JTileDataset
from resdepth_tpu_torch import make_demo_data
from resdepth_tpu_torch.data import pipeline as tpipe
from resdepth_tpu_torch.models import weights
from resdepth_tpu_torch.train import checkpoint as tckpt
from resdepth_tpu_torch.train import cli
from _jax_draws import JaxReplay, replay_factory, write_jax_init
from test_torch_pipeline import _training_dataset, _training_scene
from test_torch_train import E2E_MODEL, _e2e_config, _val_maes
from test_torch_unet import _rel_l2

VAL_ATOL = 1e-4            # m, per epoch
WEIGHTS_REL_L2 = 1e-4      # per tensor of params and bn_state


# ------------------------------ the draws ----------------------------------- #

class _Fixed:
    """A draw source that hands out given dihedral bits."""

    def __init__(self, bits):
        self.bits = bits

    def dihedral_bits(self, batch, device):
        return self.bits


def _jax_keys(seed, epoch, step, device):
    """The key ``build_batch`` gets, and its permutation and augmentation
    keys, as the JAX package derives them."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(seed), epoch), step), device)
    rng, perm = jax.random.split(key)
    _, aug = jax.random.split(rng)
    return key, perm, aug


@pytest.mark.parametrize("seed,epoch,step,device,batch,views", [
    (0, 0, 0, 0, 8, 2), (3, 2, 17, 1, 5, 3), (11, 5, 123, 7, 16, 2)],
    ids=["first-step", "device-1", "device-7"])
def test_replay_is_jax_draws(seed, epoch, step, device, batch, views):
    """The replayed permutations equal ``_permutation_per_sample``'s, and
    the replayed bits applied by the port's ``_augment`` give JAX's
    ``_augment`` image for image, bitwise, on the same keys."""
    _, perm_key, aug_key = _jax_keys(seed, epoch, step, device)
    draws = JaxReplay(seed, epoch, 1, device).at_step(step)
    got = draws.view_permutations(batch, views, "cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jpipe._permutation_per_sample(
        perm_key, batch, views)))
    assert sorted(got[0]) == list(range(views))

    tile = 4
    index = np.arange(batch * tile * tile * 2, dtype=np.float32).reshape(batch, tile, tile, 2)
    want = np.asarray(jpipe._augment(jnp.asarray(index), aug_key))
    bits = draws.dihedral_bits(batch, "cpu")
    assert bits.shape == (3, batch) and bits.dtype == torch.bool
    port = tpipe._augment(torch.from_numpy(index).permute(0, 3, 1, 2), _Fixed(bits))
    np.testing.assert_array_equal(port.permute(0, 2, 3, 1).numpy(), want)


def test_default_source_draws_as_the_generator():
    """The default source (``GeneratorDraws``, what the Trainer and the
    seeded callers hand the step) draws what the generator drew before the
    seam: the permutations as an argsort of (B, V) uniforms, then the bits
    as (3, B) uniforms below 1/2, every step on from one stream
    (``at_step`` is the source itself)."""
    source = tpipe.GeneratorDraws(torch.Generator().manual_seed(9))
    plain = torch.Generator().manual_seed(9)
    for step in range(3):
        draws = source.at_step(step)
        assert draws is source
        assert torch.equal(draws.view_permutations(5, 3, "cpu"),
                           torch.argsort(torch.rand((5, 3), generator=plain), dim=1))
        assert torch.equal(draws.dihedral_bits(5, "cpu"),
                           torch.rand((3, 5), generator=plain) < 0.5)


def test_replay_covers_every_device_of_a_mesh():
    """A process that holds 4 devices draws each device's share from that
    device's key: the same bits as 4 one-device replays side by side."""
    whole = JaxReplay(1, 2, devices=4).at_step(9)
    parts = [JaxReplay(1, 2, 1, d).at_step(9) for d in range(4)]
    np.testing.assert_array_equal(
        whole.view_permutations(8, 2, "cpu").numpy(),
        np.concatenate([p.view_permutations(2, 2, "cpu").numpy() for p in parts]))
    np.testing.assert_array_equal(
        whole.dihedral_bits(8, "cpu").numpy(),
        np.concatenate([p.dihedral_bits(2, "cpu").numpy() for p in parts], axis=1))


def test_replayed_batch_is_jax_build_batch(make_geotiff):
    """A training batch with permutation and augmentation on: the port's
    ``build_batch`` with the replay equals JAX's with the step's key, within
    ``test_torch_pipeline.py``'s bars (a wrong transform or view moves a
    value by metres)."""
    paths = _training_scene(make_geotiff)
    kwargs = dict(pairs=((2, 1), (0, 1), (0, 2)), augment=True,
                  permute_images_within_pair=True)
    ds = _training_dataset(paths, "geom-stereo", "train", **kwargs)
    jds = _training_dataset(paths, "geom-stereo", "train", cls=JTileDataset, **kwargs)
    spec, jspec = tpipe.batch_spec_for(ds), jpipe.batch_spec_for(jds)
    assert spec.augment and spec.permute_images_within_pair
    idx = np.arange(6)
    positions, pairs = ds.positions[idx], ds.pair_indices[idx]
    bounds = np.zeros((6, 4), np.int32)
    key, _, _ = _jax_keys(4, 1, 3, 0)
    want = jpipe.build_batch(jpipe.device_put_dataset(jds), positions, pairs, bounds,
                             key, jspec)
    got = tpipe.build_batch(tpipe.device_put_dataset(ds, "cpu", include_target=True),
                            torch.from_numpy(positions), torch.from_numpy(pairs), spec,
                            bounds=torch.from_numpy(bounds),
                            draws=JaxReplay(4, 1).at_step(3))
    # test_torch_pipeline.py's bars: the masked mean of heights near 400 m
    # summed in another order, and the inputs normalised by it
    for name, atol in (("input", 5e-5), ("target", 5e-5), ("loss_mask", 0),
                       ("dsm_mean", 2.5e-4)):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=0, atol=atol, err_msg=name)


# ------------------------------ the runs ------------------------------------ #

def _golden_configs(work: str):
    """The golden pipeline's train config, warm-started from JAX's init:
    returns ``config(name, draws_on) -> path`` and the run's suffix."""
    golden = make_demo_data.write_golden_scene(os.path.join(work, "golden"))
    with open(golden["train"]) as f:
        base = json.load(f)
    init = write_jax_init(os.path.join(work, "init", "checkpoints", "init.npz"), 0,
                          {k: base["model"][k] for k in ("depth", "start_kernel",
                                                         "max_filter_depth")})

    def config(name, draws_on):
        cfg = json.loads(json.dumps(base))
        cfg["model"]["pretrained_path"] = init
        cfg["training_settings"]["augment"] = draws_on
        cfg["output"] = {"output_directory": os.path.join(work, name), "suffix": "golden"}
        path = os.path.join(work, f"{name}.json")
        with open(path, "w") as f:
            json.dump(cfg, f, indent=2)
        return path
    return config, "golden"


def _permute_configs(work: str):
    """``test_torch_train.py``'s e2e config (1-device mesh) with
    augmentation and view permutation on, warm-started from JAX's init."""
    scene = chip_smoke.write_scene(os.path.join(work, "scene"), 96, 96)
    init = write_jax_init(os.path.join(work, "init", "checkpoints", "init.npz"), 0,
                          E2E_MODEL)

    def config(name, draws_on):
        return _e2e_config(work, scene, os.path.join(work, name), init,
                           training={"tile_size": 16, "batch_size": 4, "n_epochs": 2,
                                     "augment": draws_on},
                           stereopair_settings={"use_all_stereo_pairs": True,
                                                "permute_images_within_pair": draws_on})
    return config, "e2e"


# (configs, JAX's mesh devices, epochs)
CASES = {"golden": (_golden_configs, 8, 4), "e2e-permute": (_permute_configs, 1, 2)}


def _gaps(jax_run: str, port_run: str) -> tuple:
    """The largest per-epoch val MAE gap (m), the largest relative L2 of a
    final-weights tensor and that tensor's name, and the epochs validated,
    between the two run directories."""
    want, got = _val_maes(jax_run), _val_maes(port_run)
    assert [e for e, _ in got] == [e for e, _ in want]
    val = max(abs(g - w) for (_, g), (_, w) in zip(got, want))
    last = [tckpt.load_checkpoint(os.path.join(run, "checkpoints", "Model_last.npz"))
            for run in (jax_run, port_run)]
    rel = {}
    for tree in ("params", "bn_state"):
        a, b = (weights.flatten_keystr(c[tree]) for c in last)
        assert a.keys() == b.keys()
        rel.update({f"{tree}{k}": _rel_l2(b[k], a[k]) for k in a})
    worst = max(rel, key=rel.get)
    return val, rel[worst], worst, len(want)


@pytest.mark.parametrize("case", list(CASES))
def test_same_init_same_draws_same_run(case, tmp_path, capsys):
    """``train.py`` and the port's CLI from JAX's init: with augmentation
    (and, in e2e-permute, view permutation) on and JAX's draws replayed in
    the port, the per-epoch val MAE within ``VAL_ATOL`` and the final
    weights within ``WEIGHTS_REL_L2``; the augmentation-off twin's gaps,
    measured beside them, are printed."""
    import train as jax_train

    make_configs, devices, epochs = CASES[case]
    work = str(tmp_path)
    config, suffix = make_configs(work)
    gaps = {}
    for draws_on in (True, False):
        tag = "on" if draws_on else "off"
        argv = sys.argv
        try:
            sys.argv = ["train.py", config(f"jax_{tag}", draws_on)]
            jax_train.main()
        finally:
            sys.argv = argv
        trainer = cli.main([config(f"port_{tag}", draws_on), "--device", "cpu"],
                           draw_factory=replay_factory(0, devices) if draws_on else None)
        runs = [chip_smoke.run_dir_of(os.path.join(work, f"{name}_{tag}"), suffix)
                for name in ("jax", "port")]
        gaps[tag] = _gaps(*runs)
        assert gaps[tag][3] == epochs
        assert trainer.val_history == _val_maes(runs[1])
    val_bar = max(VAL_ATOL, 2 * gaps["off"][0])
    weights_bar = max(WEIGHTS_REL_L2, 2 * gaps["off"][1])
    with capsys.disabled():
        print(f"\n{case}: JAX's draws replayed: val MAE gap {gaps['on'][0]:.3g} m (bar "
              f"{val_bar:.3g}), weights rel L2 {gaps['on'][1]:.3g} at {gaps['on'][2]} "
              f"(bar {weights_bar:.3g}); augmentation off: {gaps['off'][0]:.3g} m, "
              f"{gaps['off'][1]:.3g} at {gaps['off'][2]}")
    assert gaps["on"][0] <= val_bar, gaps
    assert gaps["on"][1] <= weights_bar, gaps


# ------------------------- what is left: the init --------------------------- #

def test_init_draws_jax_init_distribution():
    """The flagship's initial weights (ROADMAP section 3: the init sample
    decides the reduced protocol's outcome): every tensor of the port's
    ``init_unet`` has JAX's shape and lies within JAX's bound, and each one
    of 500 values or more has the std of that uniform draw (bound /
    sqrt(3)) within 10 % (the sample std's spread is 2 % at 500 values)."""
    from resdepth_tpu.models import unet as junet
    from resdepth_tpu_torch.models import unet as tunet

    settings = dict(n_input_channels=3, bias_conv_layer=True, depth=5, start_kernel=64,
                    max_filter_depth=512)
    params, state = junet.init_unet(jax.random.PRNGKey(0), junet.UNetConfig(**settings))
    config = tunet.UNetConfig(**settings)
    want = weights.state_dict_from_jax_params(params, state, config)
    got = tunet.init_unet(config, torch.Generator().manual_seed(0)).state_dict()
    assert got.keys() == want.keys()
    for key, value in got.items():
        a, b = value.numpy(), np.asarray(want[key])
        assert a.shape == b.shape, key
        if a.size < 500 or np.ptp(b) == 0:
            continue
        bound = np.abs(b).max()
        assert np.abs(a).max() <= bound * (1 + 1e-3), key
        assert abs(a.std() / (bound / np.sqrt(3)) - 1) < 0.1, key


def test_fresh_run_is_its_warm_start(tmp_path):
    """The port's CLI from its own seeded init and from the same weights
    as a warm start (``model.pretrained_path``) train the same run,
    bitwise: starting from a file changes nothing but the weights' source,
    as the JAX-init replays on the card assume."""
    from resdepth_tpu.config.schema import count_input_channels
    from resdepth_tpu_torch.models import unet as tunet

    work = str(tmp_path)
    scene = chip_smoke.write_scene(os.path.join(work, "scene"), 96, 96)
    config = tunet.UNetConfig(n_input_channels=count_input_channels("geom-stereo"),
                              bias_conv_layer=True, **E2E_MODEL)
    model = tunet.init_unet(config, torch.Generator().manual_seed(0))
    init = os.path.join(work, "init", "checkpoints", "init.npz")
    os.makedirs(os.path.dirname(init))
    params, bn_state = weights.jax_params_from_state_dict(model.state_dict(), config)
    tckpt.save_checkpoint(init, epoch=-1, params=params, bn_state=bn_state)
    sections = dict(training={"tile_size": 16, "batch_size": 4, "n_epochs": 2,
                              "augment": True},
                    stereopair_settings={"use_all_stereo_pairs": True,
                                         "permute_images_within_pair": True})
    runs = {}
    for name, start in (("fresh", None), ("warm", init)):
        trainer = cli.main([_e2e_config(work, scene, os.path.join(work, name), start,
                                        **sections), "--device", "cpu"])
        runs[name] = (trainer.val_history, tckpt.load_checkpoint(os.path.join(
            chip_smoke.run_dir_of(os.path.join(work, name), "e2e"), "checkpoints",
            "Model_last.npz")))
    assert runs["fresh"][0] == runs["warm"][0]
    for tree in ("params", "bn_state"):
        a, b = (weights.flatten_keystr(runs[n][1][tree]) for n in ("fresh", "warm"))
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a), tree
