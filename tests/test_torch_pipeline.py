"""Port batch assembly (resdepth_tpu_torch.data.pipeline) against the JAX
build_batch, under the inference spec of ``infer/tiled.py::_inference_spec``.

The same 'test'-strategy TileDataset feeds both packages on the CPU. The
DSM carries nodata pixels so that the masked patch mean has work to do.
Tolerances, measured on this scene: XLA's CPU sum of a tile's 256 f32
heights lands up to 1.6e-4 m from the float64 mean, the port's within
4.3e-5 m (1.4 ulps at 400 m). So ``dsm_mean`` is held to 2.5e-4 m against
JAX and to 2 ulps (6.1e-5 m) against a float64 oracle, and ``input`` to
5e-5 in normalised units (2.5e-4 m over the DSM sigma of 5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resdepth_tpu.data import pipeline as jpipe
from resdepth_tpu.data.dataset import TileDataset
from resdepth_tpu.infer import tiled as jtiled
from resdepth_tpu_torch.data import pipeline as tpipe
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


def _dataset(paths, channels, ortho_mean):
    entry = {"raster_in": paths["raster_in"],
             "area_defn": {"x_extent": [(0, COLS - 1)], "y_extent": [(0, ROWS - 1)]}}
    if channels != "geom":
        entry.update(image_list=paths["image_list"], image_pairs=[(2, 1)])
    return TileDataset(entry, input_channels=channels, tile_size=TILE,
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


@pytest.mark.parametrize("field", ["has_target", "use_bounds", "augment",
                                   "permute_images_within_pair"])
def test_training_branches_raise(make_geotiff, field):
    ds = _dataset(_scene(make_geotiff), "geom-stereo", None)
    spec = tpipe.BatchSpec(**{**vars(ttiled._inference_spec(ds)), field: True})
    rasters = tpipe.device_put_dataset(ds, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpipe.build_batch(rasters, torch.from_numpy(ds.positions[:2]),
                          torch.from_numpy(ds.pair_indices[:2]), spec)
