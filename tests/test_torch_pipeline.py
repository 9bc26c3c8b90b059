"""Port batch assembly (resdepth_tpu_torch.data.pipeline) against the JAX
build_batch: under the inference spec of ``infer/tiled.py::_inference_spec``
and under the training specs (target, loss mask, bounds, augmentation,
view permutation), and the port's BatchIndexIterator against JAX's.

Each package reads the same files into its own 'test'-strategy
TileDataset (``tests/test_torch_host.py`` holds the two datasets equal), and
each package's batch assembly runs on its own dataset on the CPU. The DSM
carries nodata pixels so that the masked patch mean has work to do.
Tolerances, measured on this scene: XLA's CPU sum of a tile's 256 f32
heights lands up to 1.6e-4 m from the float64 mean, the port's within
4.3e-5 m (1.4 ulps at 400 m). So ``dsm_mean`` is held to 2.5e-4 m against
JAX and to 2 ulps (6.1e-5 m) against a float64 oracle, and ``input`` to
5e-5 in normalised units (2.5e-4 m over the DSM sigma of 5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resdepth_tpu.data import pipeline as jpipe
from resdepth_tpu.data.dataset import TileDataset as JTileDataset
from resdepth_tpu.infer import tiled as jtiled
from resdepth_tpu_torch.data import pipeline as tpipe
from resdepth_tpu_torch.data.dataset import TileDataset
from resdepth_tpu_torch.infer import tiled as ttiled

ROWS, COLS, TILE = 48, 64, 16
NODATA = -9999.0


def _scene(make_geotiff, n_images=3):
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:ROWS, 0:COLS].astype(np.float32)
    dsm = (400.0 + 5.0 * np.sin(yy / 9.0) + 4.0 * np.cos(xx / 11.0)
           + rng.normal(0.0, 0.8, (ROWS, COLS))).astype(np.float32)
    dsm[5:9, 3:7] = NODATA
    dsm[30, 40] = NODATA
    images = rng.normal(120.0, 25.0, (ROWS, COLS, n_images)).astype(np.float32)
    return {"raster_in": make_geotiff("dsm.tif", dsm, nodata=NODATA),
            "image_list": [make_geotiff(f"img{j}.tif", images[..., j])
                           for j in range(n_images)]}


def _dataset(paths, channels, ortho_mean, cls=TileDataset):
    """The port's dataset, or with ``cls=JTileDataset`` the JAX package's."""
    entry = {"raster_in": paths["raster_in"],
             "area_defn": {"x_extent": [(0, COLS - 1)], "y_extent": [(0, ROWS - 1)]}}
    if channels != "geom":
        entry.update(image_list=paths["image_list"], image_pairs=[(2, 1)])
    return cls(entry, input_channels=channels, tile_size=TILE,
               sampling_strategy="test", dsm_std=5.0,
               ortho_mean=ortho_mean, ortho_std=25.0)


@pytest.mark.parametrize("channels,ortho_mean", [
    ("geom", None), ("geom-stereo", None), ("geom-stereo", 120.0),
    ("stereo", None), ("stereo", 120.0)])
def test_build_batch_matches_jax(make_geotiff, channels, ortho_mean):
    ds = _dataset(_scene(make_geotiff), channels, ortho_mean)
    n = len(ds.positions)

    jspec = jtiled._inference_spec(ds)
    want = jpipe.build_batch(
        jpipe.device_put_dataset(ds, include_target=False),
        jnp.asarray(ds.positions), jnp.asarray(ds.pair_indices),
        jnp.zeros((n, 4), jnp.int32), jax.random.PRNGKey(0), jspec)

    tspec = ttiled._inference_spec(ds)
    assert tspec == tpipe.BatchSpec(**vars(jspec))
    rasters = tpipe.device_put_dataset(ds, "cpu")
    assert rasters.dsm_target is None
    got = tpipe.build_batch(rasters, torch.from_numpy(ds.positions),
                            torch.from_numpy(ds.pair_indices), tspec)

    channels_out = {"geom": 1, "geom-stereo": 3, "stereo": 2}[channels]
    assert got["input"].shape == (n, TILE, TILE, channels_out)
    np.testing.assert_allclose(got["dsm_mean"].numpy(),
                               np.asarray(want["dsm_mean"]), rtol=0, atol=2.5e-4)
    np.testing.assert_allclose(got["input"].numpy(), np.asarray(want["input"]),
                               rtol=0, atol=5e-5)

    exact = []
    for y, x in ds.positions:
        patch = ds.dsm_input[y:y + TILE, x:x + TILE].astype(np.float64)
        exact.append(patch[patch != ds.nodata].mean())
    np.testing.assert_allclose(got["dsm_mean"].numpy(), exact, rtol=0,
                               atol=2 * np.spacing(np.float32(400.0)))


def test_orthos_are_image_major(make_geotiff):
    ds = _dataset(_scene(make_geotiff), "geom-stereo", None)
    rasters = tpipe.device_put_dataset(ds, "cpu", include_target=True)
    assert rasters.orthos.shape == (3, ROWS, COLS)
    np.testing.assert_array_equal(rasters.orthos[2].numpy(), ds.orthos[..., 2])
    assert rasters.pairs.tolist() == ds.pairs_array.tolist()


def _training_scene(make_geotiff, n_images=3):
    """DSM and ground truth with nodata holes and exact zeros in the truth
    (the reference's ``!= 0`` mask quirk)."""
    paths = _scene(make_geotiff, n_images)
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:ROWS, 0:COLS].astype(np.float32)
    gt = (401.0 + 5.0 * np.sin(yy / 9.0) + 4.0 * np.cos(xx / 11.0)
          + rng.normal(0.0, 0.3, (ROWS, COLS))).astype(np.float32)
    gt[10:14, 20:27] = NODATA
    gt[33:35, 5:9] = 0.0
    gt[2, 50] = 0.0
    paths["raster_gt"] = make_geotiff("gt.tif", gt, nodata=NODATA)
    return paths


def _training_dataset(paths, channels, strategy, strict_zero_mask=True,
                      pairs=((2, 1),), cls=TileDataset, **kwargs):
    """The port's dataset, or with ``cls=JTileDataset`` the JAX package's."""
    entry = {"raster_in": paths["raster_in"], "raster_gt": paths["raster_gt"],
             "area_defn": {"x_extent": [(0, COLS - 1)], "y_extent": [(0, ROWS - 1)]},
             "n_samples": 24}
    if channels != "geom":
        entry.update(image_list=paths["image_list"], image_pairs=list(pairs))
    return cls(entry, input_channels=channels, tile_size=TILE,
               sampling_strategy=strategy, dsm_std=5.0, ortho_mean=None,
               ortho_std=25.0, strict_zero_mask=strict_zero_mask, seed=3,
               **kwargs)


def _both(ds, jds, spec_overrides=None, seed=0):
    """The JAX batch over ``jds`` and the port batch over ``ds``, the same
    samples, same spec."""
    jspec = jpipe.batch_spec_for(jds)
    if spec_overrides:
        jspec = dataclasses.replace(jspec, **spec_overrides)
    n = len(ds)
    bounds = (ds.valid_bounds if ds.valid_bounds is not None
              else np.zeros((n, 4), np.int32))
    want = jpipe.build_batch(jpipe.device_put_dataset(jds),
                             jnp.asarray(jds.positions), jnp.asarray(jds.pair_indices),
                             jnp.asarray(bounds), jax.random.PRNGKey(seed), jspec)
    tspec = tpipe.BatchSpec(**vars(jspec))
    assert tspec == tpipe.batch_spec_for(ds) or spec_overrides
    got = tpipe.build_batch(tpipe.device_put_dataset(ds, "cpu", include_target=True),
                            torch.from_numpy(ds.positions),
                            torch.from_numpy(ds.pair_indices), tspec,
                            bounds=torch.from_numpy(bounds),
                            draws=tpipe.GeneratorDraws(torch.Generator().manual_seed(seed)))
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


@pytest.mark.parametrize("channels,strategy,strict_zero_mask", [
    ("geom-stereo", "train", True), ("geom-stereo", "val", True),
    ("geom", "val", False), ("stereo", "train", False)],
    ids=["stereo-train", "stereo-val-bounds", "geom-val-nozeroquirk",
         "stereo-only-train"])
def test_training_batch_matches_jax(make_geotiff, channels, strategy,
                                    strict_zero_mask):
    """Target and loss mask (nodata, the ``!= 0`` quirk, the inclusive
    bounds) exactly; the normalised target and input at the inference
    tolerances."""
    paths = _training_scene(make_geotiff)
    ds = _training_dataset(paths, channels, strategy, strict_zero_mask)
    jds = _training_dataset(paths, channels, strategy, strict_zero_mask,
                            cls=JTileDataset)
    assert (ds.valid_bounds is not None) == (strategy == "val")
    want, got = _both(ds, jds)
    assert set(got) == {"input", "target", "loss_mask", "dsm_mean"}
    np.testing.assert_array_equal(got["loss_mask"], want["loss_mask"])
    assert got["loss_mask"].dtype == np.float32
    masked_out = got["loss_mask"].size - got["loss_mask"].sum()
    assert masked_out > 0
    for i in range(len(ds)):
        np.testing.assert_array_equal(got["loss_mask"][i, ..., 0],
                                      ds.loss_mask_host(i))
    np.testing.assert_allclose(got["dsm_mean"], want["dsm_mean"], rtol=0, atol=2.5e-4)
    np.testing.assert_allclose(got["target"], want["target"], rtol=0, atol=5e-5)
    np.testing.assert_allclose(got["input"], want["input"], rtol=0, atol=5e-5)
    # the raw target comes back exactly from the normalised one's mean
    t = TILE
    for i, (y, x) in enumerate(ds.positions):
        raw = ds.dsm_target[y:y + t, x:x + t]
        valid = raw != NODATA
        np.testing.assert_allclose(
            (got["target"][i, ..., 0] * 5.0 + got["dsm_mean"][i])[valid],
            raw[valid], rtol=0, atol=1e-3)


_DIHEDRAL = [lambda a, k=k, f=f: np.rot90(a[:, ::-1] if f else a, k)
             for f in (False, True) for k in range(4)]


def test_augment_is_one_dihedral_transform_per_sample(make_geotiff):
    """Under augment each sample is one of the 8 symmetries of its
    unaugmented self, the same one for mask, target and every channel,
    and all 8 occur."""
    ds = _training_dataset(_training_scene(make_geotiff), "geom-stereo", "train")
    spec = tpipe.batch_spec_for(ds)
    rasters = tpipe.device_put_dataset(ds, "cpu", include_target=True)
    idx = np.arange(len(ds)).repeat(4)        # 96 samples
    args = (rasters, torch.from_numpy(ds.positions[idx]),
            torch.from_numpy(ds.pair_indices[idx]))
    plain = tpipe.build_batch(*args, spec)
    aug = tpipe.build_batch(*args, dataclasses.replace(spec, augment=True),
                            draws=tpipe.GeneratorDraws(torch.Generator().manual_seed(4)))
    stack = lambda b, i: torch.cat(
        [b["loss_mask"][i], b["target"][i], b["input"][i]], dim=-1).numpy()
    seen = set()
    for i in range(len(idx)):
        base, out = stack(plain, i), stack(aug, i)
        matches = [g for g, f in enumerate(_DIHEDRAL) if np.array_equal(f(base), out)]
        assert matches, i
        seen.add(matches[0])
    assert seen == set(range(8))
    np.testing.assert_array_equal(aug["dsm_mean"].numpy(), plain["dsm_mean"].numpy())


def test_permutation_is_a_permutation_of_the_pair(make_geotiff):
    """Under permute_images_within_pair each sample's ortho channels are its
    pair's views in some order, and both orders occur."""
    ds = _training_dataset(_training_scene(make_geotiff), "stereo", "train")
    spec = dataclasses.replace(tpipe.batch_spec_for(ds), transform_orthos=False,
                               ortho_mean=0.0, ortho_std=1.0)
    rasters = tpipe.device_put_dataset(ds, "cpu", include_target=True)
    args = (rasters, torch.from_numpy(ds.positions), torch.from_numpy(ds.pair_indices))
    plain = tpipe.build_batch(*args, spec)["input"].numpy()
    perm = tpipe.build_batch(*args, dataclasses.replace(
        spec, permute_images_within_pair=True),
        draws=tpipe.GeneratorDraws(torch.Generator().manual_seed(5)))["input"].numpy()
    orders = set()
    for i in range(len(ds)):
        if np.array_equal(perm[i], plain[i]):
            orders.add("same")
        else:
            np.testing.assert_array_equal(perm[i], plain[i][..., ::-1])
            orders.add("swapped")
    assert orders == {"same", "swapped"}


def test_random_branches_need_a_generator(make_geotiff):
    ds = _training_dataset(_training_scene(make_geotiff), "geom", "train")
    spec = dataclasses.replace(tpipe.batch_spec_for(ds), augment=True)
    with pytest.raises(ValueError, match="generator"):
        tpipe.build_batch(tpipe.device_put_dataset(ds, "cpu", include_target=True),
                          torch.from_numpy(ds.positions), torch.from_numpy(ds.pair_indices),
                          spec)


@pytest.mark.parametrize("batch_size,emit_size,shuffle", [
    (5, None, True), (5, 8, True), (6, None, False), (24, None, True)])
def test_batch_index_iterator_matches_jax(make_geotiff, batch_size, emit_size,
                                          shuffle):
    """Same seed, same arrays: positions, pair indices, bounds and the
    zero-weight wrap-around padding, over two epochs."""
    paths = _training_scene(make_geotiff)
    ds = _training_dataset(paths, "geom-stereo", "val", pairs=((2, 1), (0, 1)))
    jds = _training_dataset(paths, "geom-stereo", "val", pairs=((2, 1), (0, 1)),
                            cls=JTileDataset)
    got = tpipe.BatchIndexIterator(ds, batch_size, shuffle, seed=7,
                                   emit_size=emit_size)
    want = jpipe.BatchIndexIterator(jds, batch_size, shuffle, seed=7,
                                    emit_size=emit_size)
    assert len(got) == len(want)
    for _ in range(2):
        pairs = list(zip(got, want))
        assert len(pairs) == len(want)
        for g, w in pairs:
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
    if len(ds) % batch_size or emit_size:
        assert pairs[-1][0][3].min() == 0.0
