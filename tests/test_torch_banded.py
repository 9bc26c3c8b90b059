"""Banded training residency in the port (``resdepth_tpu_torch/data/
banded.py``) against the JAX package's ``data/banded.py`` on the CPU.

* The band geometry (``iter_bands``, ``iter_bands_2d``, ``resident_pixels``,
  ``window_budgets_for``, ``rows_budget_for``) equals JAX's on the same
  datasets at 1-D, 2-D, floor and infeasible budgets, errors included, and
  ``make_banded_loaders`` gives JAX's windows and index batches for 2
  epochs.
* The port's ``BandedRasterSource`` keeps one window on the device, pads it
  (DSM planes with nodata, orthos with 0) and counts its uploads; its
  windows hold JAX's values.
* Banded training equals its ``band_resident=False`` twin over 2 epochs at
  ``rtol=1e-6`` (1-D and 2-D windows); the trainer orders chunks as JAX's
  with ``group_chunks_by_loader``; one banded epoch from the same weights
  (augmentation off) matches JAX's banded epoch at the tolerance
  ``tests/test_torch_train.py`` holds the resident epochs to: val MAE
  within 1e-4 m, weights within 1e-4 relative L2 per tensor.
"""

import jax
import numpy as np
import pytest
import torch

from resdepth_tpu.data import banded as jbanded
from resdepth_tpu.data.dataset import TileDataset as JTileDataset
from resdepth_tpu.data.pipeline import batch_spec_for as jbatch_spec_for
from resdepth_tpu.models import unet as junet
from resdepth_tpu.train.optim import build_optimizer as jbuild_optimizer
from resdepth_tpu.train.step import init_train_state as jinit_state
from resdepth_tpu.train.step import make_eval_step as jmake_eval_step
from resdepth_tpu.train.step import make_train_step as jmake_train_step
from resdepth_tpu.train.trainer import Trainer as JTrainer
from resdepth_tpu_torch.data import banded
from resdepth_tpu_torch.data.dataset import TileDataset
from resdepth_tpu_torch.data.pipeline import batch_spec_for
from resdepth_tpu_torch.models import unet as tunet
from resdepth_tpu_torch.models import weights
from resdepth_tpu_torch.train.step import (init_train_state, make_eval_step,
                                           make_train_step)
from resdepth_tpu_torch.train.trainer import Trainer, checkpoint_trees
from test_banded import BUDGET, BUDGET_2D, COLS, PLANES, ROWS, _scene
from test_torch_unet import _jax_weights, _rel_l2

TILE = 16
SETTINGS = dict(n_input_channels=3, start_kernel=4, max_filter_depth=8, depth=2)
# Budgets by name: 1-D row bands, 2-D windows (one full-width tile band
# does not fit), one tile window exactly, no banding, below one tile window.
BUDGETS = {"1d": BUDGET, "2d": BUDGET_2D, "floor": PLANES * TILE * TILE,
           "whole": 10**9, "infeasible": 100}


def _datasets(paths, strategy="train", **kwargs):
    """The port's TileDataset and the JAX package's over the same files."""
    entry = {"raster_in": paths["raster_in"], "raster_gt": paths["raster_gt"],
             "image_list": paths["image_list"], "image_pairs": [(0, 1), (1, 2)],
             "area_defn": {"x_extent": [(0, COLS - 1)], "y_extent": [(0, ROWS - 1)]},
             "n_samples": 40}
    settings = dict(input_channels="geom-stereo", tile_size=TILE,
                    sampling_strategy=strategy, dsm_std=5.0, ortho_mean=120.0,
                    ortho_std=25.0, seed=3, **kwargs)
    return TileDataset(entry, **settings), JTileDataset(entry, **settings)


def _bands(module, positions, *args):
    return [(rw, cw, idx.tolist(), pos.tolist())
            for rw, cw, idx, pos in module.iter_bands_2d(positions, *args)]


@pytest.mark.parametrize("include_target", [True, False], ids=["target", "no-target"])
@pytest.mark.parametrize("budget", list(BUDGETS), ids=list(BUDGETS))
def test_band_geometry_matches_jax(make_geotiff, budget, include_target):
    ds, jds = _datasets(_scene(make_geotiff))
    pixels = BUDGETS[budget]
    assert banded.resident_pixels(ds, include_target) == \
        jbanded.resident_pixels(jds, include_target)

    def outcome(module, dataset, fn):
        try:
            return getattr(module, fn)(dataset, pixels, include_target)
        except ValueError as exc:
            return ("ValueError", str(exc))

    for fn in ("window_budgets_for", "rows_budget_for"):
        assert outcome(banded, ds, fn) == outcome(jbanded, jds, fn), fn
    if budget == "infeasible":
        with pytest.raises(ValueError, match="tpu.max_device_pixels"):
            banded.window_budgets_for(ds, pixels, include_target)
        return
    rb, cb = banded.window_budgets_for(ds, pixels, include_target)
    np.testing.assert_array_equal(ds.positions, jds.positions)
    assert (_bands(banded, ds.positions, TILE, rb, cb, COLS)
            == _bands(jbanded, jds.positions, TILE, rb, cb, COLS))
    rows = [(w, idx.tolist(), pos.tolist())
            for w, idx, pos in banded.iter_bands(ds.positions, TILE, rb)]
    assert rows == [(w, idx.tolist(), pos.tolist())
                    for w, idx, pos in jbanded.iter_bands(jds.positions, TILE, rb)]


@pytest.mark.parametrize("rows_budget,cols_budget", [(20, 64), (28, 28), (16, 17)])
def test_iter_bands_match_jax_on_random_positions(rows_budget, cols_budget):
    """Random positions (ties, unsorted, a budget below a tile too)."""
    rng = np.random.default_rng(rows_budget)
    positions = np.stack([rng.integers(0, ROWS - TILE, 60),
                          rng.integers(0, COLS - TILE, 60)], axis=1)
    positions[10:14] = positions[3]
    for tile in (TILE, 24):
        assert (_bands(banded, positions, tile, rows_budget, cols_budget, COLS)
                == _bands(jbanded, positions, tile, rows_budget, cols_budget, COLS))


@pytest.mark.parametrize("budget", ["1d", "2d"])
def test_loaders_match_jax(make_geotiff, budget):
    """The same windows (origins and common shape) and, for 2 epochs, the
    same index batches as the JAX loaders, seeded ``(seed, band)``."""
    ds, jds = _datasets(_scene(make_geotiff))
    loaders = banded.make_banded_loaders(ds, 4, max_device_pixels=BUDGETS[budget],
                                         seed=7, device="cpu")
    jloaders = jbanded.make_banded_loaders(jds, 4, max_device_pixels=BUDGETS[budget],
                                           seed=7)
    assert len(loaders) == len(jloaders) >= 3
    source, jsource = loaders[0][0].source, jloaders[0][0].source
    assert (source.window_rows, source.window_cols) == \
        (jsource.window_rows, jsource.window_cols)
    assert [(p.y0, p.x0) for p, _ in loaders] == [(p.y0, p.x0) for p, _ in jloaders]
    for _ in range(2):
        for (_, iterator), (_, jiterator) in zip(loaders, jloaders):
            got, want = list(iterator), list(jiterator)
            assert len(got) == len(want)
            for batch, jbatch in zip(got, want):
                for a, b in zip(batch, jbatch):
                    np.testing.assert_array_equal(a, b)


def test_source_keeps_one_window(make_geotiff):
    """One window on the device per source: a second request of the same
    window uploads nothing, another window replaces it, release() drops
    it; the window's values are JAX's."""
    ds, jds = _datasets(_scene(make_geotiff))
    loaders = banded.make_banded_loaders(ds, 4, max_device_pixels=BUDGET, seed=1,
                                         device="cpu")
    jloaders = jbanded.make_banded_loaders(jds, 4, max_device_pixels=BUDGET, seed=1)
    source = loaders[0][0].source
    first = loaders[0][0].resolve()
    assert source.uploads == 1
    assert loaders[0][0].resolve() is first
    assert source.uploads == 1
    second = loaders[1][0].resolve()
    assert source.uploads == 2 and second is not first
    assert source._resident is second
    jsecond = jloaders[1][0].resolve()
    for name in ("dsm_input", "dsm_target", "orthos"):
        np.testing.assert_array_equal(getattr(second, name).numpy(),
                                      np.asarray(getattr(jsecond, name)), err_msg=name)
    np.testing.assert_array_equal(second.pairs.numpy(), ds.pairs_array)
    assert second.pairs.dtype == torch.int64 and second.nodata == ds.nodata
    loaders[1][0].release()
    assert source._resident is None
    assert second.dsm_input.shape == (source.window_rows, COLS)
    assert source.window_rows * COLS * PLANES <= BUDGET


@pytest.mark.parametrize("budget", ["1d", "2d"])
def test_window_padding_and_layout(make_geotiff, budget):
    """Every window has the common shape; the last row band's (and, in
    2-D, the last column band's) padding is nodata in the DSM planes and 0
    in the orthos, which are image-major (V, rows, cols) as
    ``device_put_dataset`` lays them out."""
    ds, _ = _datasets(_scene(make_geotiff))
    loaders = banded.make_banded_loaders(ds, 4, max_device_pixels=BUDGETS[budget],
                                         seed=1, device="cpu")
    source = loaders[0][0].source
    shape = (source.window_rows, source.window_cols)
    assert {tuple(p.resolve().dsm_input.shape) for p, _ in loaders} == {shape}
    last = max((p for p, _ in loaders), key=lambda p: (p.y0, p.x0))
    window = last.resolve()
    true_rows = min(ROWS - last.y0, shape[0])
    true_cols = min(COLS - last.x0, shape[1])
    assert (true_rows, true_cols) != shape      # this window is padded
    views = ds.orthos.shape[2]
    assert window.orthos.shape == (views,) + shape
    np.testing.assert_array_equal(
        window.orthos[:, :true_rows, :true_cols].numpy(),
        ds.orthos[last.y0:last.y0 + true_rows, last.x0:last.x0 + true_cols]
        .transpose(2, 0, 1))
    for name in ("dsm_input", "dsm_target"):
        plane = getattr(window, name).numpy()
        assert (plane[true_rows:] == ds.nodata).all()
        assert (plane[:, true_cols:] == ds.nodata).all()
    assert (window.orthos[:, true_rows:].numpy() == 0).all()
    assert (window.orthos[:, :, true_cols:].numpy() == 0).all()


def _train(ds, val_ds, tmp_path, *, budget, band_resident, tag, epochs=2):
    """The port's Trainer on banded loaders (or their resident twin) from
    seeded weights: the trainer and its train loaders."""
    model = tunet.init_unet(tunet.UNetConfig(**SETTINGS), torch.Generator().manual_seed(0))
    state = init_train_state(model, "Adam", 3e-3, 1e-5)
    train_loaders = banded.make_banded_loaders(
        ds, 4, max_device_pixels=budget, seed=7, device="cpu",
        band_resident=band_resident)
    val_loaders = banded.make_banded_loaders(
        val_ds, 4, max_device_pixels=budget, seed=0, device="cpu", shuffle=False,
        band_resident=band_resident)
    trainer = Trainer(state=state, train_step=make_train_step(batch_spec_for(ds)),
                      eval_step=make_eval_step(batch_spec_for(val_ds)),
                      train_loaders=train_loaders, val_loaders=val_loaders,
                      n_epochs=epochs, checkpoint_dir=str(tmp_path / tag), rng_seed=5,
                      group_chunks_by_loader=True)
    trainer.train()
    return trainer, train_loaders


@pytest.mark.parametrize("budget", ["1d", "2d"])
def test_banded_training_matches_its_twin(make_geotiff, tmp_path, budget):
    """2 epochs with augmentation on a scene over the budget: the banded
    run and its twin (same loaders and batch order, full scene resident)
    train to the same weights; each window is uploaded once an epoch and
    nothing stays resident after ``train()``."""
    paths = _scene(make_geotiff)
    ds, _ = _datasets(paths, augment=True)
    val_ds, _ = _datasets(paths, "val")
    pixels = BUDGETS[budget]
    assert banded.resident_pixels(ds) > pixels
    trainer_b, loaders_b = _train(ds, val_ds, tmp_path, budget=pixels,
                                  band_resident=True, tag="banded")
    trainer_r, _ = _train(ds, val_ds, tmp_path, budget=pixels, band_resident=False,
                          tag="resident")
    source = loaders_b[0][0].source
    assert source.uploads == 2 * len(loaders_b)
    assert source._resident is None
    assert trainer_b.val_loaders[0][0].source._resident is None
    assert source.window_rows * source.window_cols * PLANES <= pixels
    if budget == "2d":
        assert len({p.x0 for p, _ in loaders_b}) > 1
    for (name, a), b in zip(trainer_b.state.model.state_dict().items(),
                            trainer_r.state.model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    assert trainer_b.best_loss == pytest.approx(trainer_r.best_loss, rel=1e-6)


@pytest.mark.parametrize("group", [True, False], ids=["grouped", "shuffled"])
def test_epoch_chunks_order_as_jax(make_geotiff, tmp_path, group):
    """``Trainer._epoch_chunks`` draws the JAX trainer's chunk order from
    the same ``rng_seed``, grouped by loader or not, for 2 epochs
    (``steps_per_call`` 2)."""
    ds, jds = _datasets(_scene(make_geotiff))
    loaders = banded.make_banded_loaders(ds, 4, max_device_pixels=BUDGET, seed=7,
                                         device="cpu")
    jloaders = jbanded.make_banded_loaders(jds, 4, max_device_pixels=BUDGET, seed=7)
    trainer = Trainer(state=None, train_step=None, eval_step=None, steps_per_call=2,
                      train_loaders=loaders, val_loaders=[], n_epochs=1,
                      checkpoint_dir=str(tmp_path / "port"), rng_seed=11,
                      group_chunks_by_loader=group)
    jtrainer = JTrainer(state=None, train_step=None, eval_step=None,
                        train_step_multi=object(), steps_per_call=2,
                        train_loaders=jloaders, val_loaders=[], n_epochs=1,
                        checkpoint_dir=str(tmp_path / "jax"), rng_seed=11,
                        group_chunks_by_loader=group)
    for _ in range(2):
        got = trainer._epoch_chunks(loaders)
        want = jtrainer._epoch_chunks(jloaders)
        assert [i for i, _ in got] == [i for i, _ in want]
        if group:   # each loader's chunks together
            ids = [i for i, _ in got]
            assert len(set(ids)) == sum(1 for a, b in zip([None] + ids, ids) if a != b)
        for (_, chunk), (_, jchunk) in zip(got, want):
            for batch, jbatch in zip(chunk, jchunk):
                np.testing.assert_array_equal(batch[0], jbatch[0])


def test_banded_epoch_matches_jax(make_geotiff, tmp_path):
    """One banded epoch (2-D windows, augmentation and permutation off) in
    both packages from the same weights: val MAE within 1e-4 m, weights
    and BatchNorm state within 1e-4 relative L2 per tensor."""
    paths = _scene(make_geotiff)
    ds, jds = _datasets(paths)
    val_ds, jval_ds = _datasets(paths, "val")
    jconfig = junet.UNetConfig(**SETTINGS)
    params, bn_state = _jax_weights(jconfig, seed=4)
    lr, wd = 1e-3, 1e-5

    tx = jbuild_optimizer("Adam", wd)
    jtrainer = JTrainer(
        state=jinit_state(params, bn_state, tx, lr),
        train_step=jmake_train_step(jconfig, jbatch_spec_for(jds), tx, mesh=None,
                                    donate=False, weighted_bn=True),
        eval_step=jmake_eval_step(jconfig, jbatch_spec_for(jval_ds), mesh=None),
        train_loaders=jbanded.make_banded_loaders(jds, 4, max_device_pixels=BUDGET_2D,
                                                  seed=7),
        val_loaders=jbanded.make_banded_loaders(jval_ds, 4, max_device_pixels=BUDGET_2D,
                                                seed=0, shuffle=False),
        n_epochs=1, checkpoint_dir=str(tmp_path / "jax"), rng_seed=5,
        group_chunks_by_loader=True)
    jtrainer.train()

    model = tunet.UNet(tunet.UNetConfig(**SETTINGS))
    model.load_state_dict(weights.state_dict_from_jax_params(params, bn_state,
                                                             model.config))
    trainer = Trainer(
        state=init_train_state(model, "Adam", lr, wd),
        train_step=make_train_step(batch_spec_for(ds)),
        eval_step=make_eval_step(batch_spec_for(val_ds)),
        train_loaders=banded.make_banded_loaders(ds, 4, max_device_pixels=BUDGET_2D,
                                                 seed=7, device="cpu"),
        val_loaders=banded.make_banded_loaders(val_ds, 4, max_device_pixels=BUDGET_2D,
                                               seed=0, device="cpu", shuffle=False),
        n_epochs=1, checkpoint_dir=str(tmp_path / "port"), rng_seed=5,
        group_chunks_by_loader=True)
    trainer.train()

    assert trainer.val_history[0][1] == pytest.approx(jtrainer.best_loss, abs=1e-4)
    trees = checkpoint_trees(trainer.state)
    for tree, want in (("params", jtrainer.state.params),
                       ("bn_state", jtrainer.state.bn_state)):
        got = weights.flatten_keystr(trees[tree])
        want = weights.flatten_keystr(jax.tree_util.tree_map(np.asarray, want))
        assert got.keys() == want.keys()
        for key in want:
            assert _rel_l2(got[key], want[key]) <= 1e-4, key
