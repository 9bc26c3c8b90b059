"""Streaming inference in the port (``infer/tiled.py::
predict_linear_blend_streaming``) on the CPU.

* Against the JAX ``predict_linear_blend_streaming`` (the cases of
  ``tests/test_pipeline.py::test_streaming_inference_matches_full``: stride
  T/2 and 12, tta 1 and 4, a budget of 32 rows x 64 cols x 4 rasters) on the
  same weights, within ``SCENE_ULPS`` f32 ulps of the largest height.
* Against the port's resident scene: bitwise, the rows where two bands'
  windows overlap included (a band's canvas starts from the sums of the
  band above).
* Every band batches at the resident scene's batch size and pads its own
  last batch on its real tiles, so every stitch gets its batch's real box;
  a budget below one tile-high band raises.
"""

import numpy as np
import pytest

import chip_smoke
from resdepth_tpu.data.dataset import TileDataset as JTileDataset
from resdepth_tpu.infer import tiled as jtiled
from resdepth_tpu.models import unet as junet
from resdepth_tpu_torch.data.dataset import TileDataset
from resdepth_tpu_torch.infer import tiled as ttiled
from resdepth_tpu_torch.models import unet as tunet
from resdepth_tpu_torch.models import weights
from test_pipeline import _scene
from test_torch_infer import SCENE_ULPS
from test_torch_unet import _jax_weights

ROWS, COLS, TILE = 96, 64, 16
BUDGET = 32 * COLS * 4          # 32-row windows of the DSM and 3 orthos
SETTINGS = dict(n_input_channels=3, start_kernel=4, max_filter_depth=8, depth=2)


def _datasets(make_geotiff, stride):
    paths, _, _, _ = _scene(make_geotiff, rows=ROWS, cols=COLS)
    entry = {"raster_in": paths["raster_in"], "image_list": paths["image_list"],
             "image_pairs": [(0, 1)],
             "area_defn": {"x_extent": [(0, COLS - 1)], "y_extent": [(0, ROWS - 1)]}}
    return [cls(entry, input_channels="geom-stereo", tile_size=TILE,
                sampling_strategy="test", stride=stride, dsm_std=5.0,
                ortho_mean=120.0, ortho_std=25.0)
            for cls in (TileDataset, JTileDataset)]


def _models():
    jconfig = junet.UNetConfig(**SETTINGS)
    params, state = _jax_weights(jconfig, seed=2)
    model = tunet.UNet(tunet.UNetConfig(**SETTINGS))
    model.load_state_dict(weights.state_dict_from_jax_params(params, state,
                                                             model.config))
    return jconfig, params, state, model


def _seam_rows(ds, budget):
    """Rows that tiles of more than one band cover."""
    rows_budget = budget // (COLS * 4)
    bands = np.zeros(ROWS, np.int32)
    for window, _, positions in ttiled._iter_bands(ds, rows_budget):
        covered = np.zeros(ROWS, bool)
        for y in positions[:, 0] + window.start:
            covered[y:y + TILE] = True
        bands += covered
    return bands > 1


CASES = pytest.mark.parametrize("stride,tta", [(None, 1), (12, 1), (None, 4)],
                                ids=["T/2", "stride12", "tta4"])


@CASES
def test_streaming_matches_jax(make_geotiff, stride, tta):
    ds, jds = _datasets(make_geotiff, stride)
    jconfig, params, state, model = _models()
    want = np.asarray(jtiled.predict_linear_blend_streaming(
        jconfig, params, state, jds, batch_size=4, max_device_pixels=BUDGET,
        use_pallas=False, tta=tta))
    got = ttiled.predict_linear_blend_streaming(
        model, ds, device="cpu", batch_size=4, max_device_pixels=BUDGET, tta=tta)
    assert got.shape == (ROWS, COLS) and got.dtype == np.float32
    assert np.isfinite(got).all() and (got != 0).all()   # every pixel stitched
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=chip_smoke.ulps(want, SCENE_ULPS))


@CASES
def test_streaming_matches_the_resident_scene(make_geotiff, stride, tta):
    ds, _ = _datasets(make_geotiff, stride)
    model = _models()[3]
    resident = ttiled.predict_linear_blend(model, ds, device="cpu", batch_size=4,
                                           tta=tta)
    streamed = ttiled.predict_linear_blend_streaming(
        model, ds, device="cpu", batch_size=4, max_device_pixels=BUDGET, tta=tta)
    assert 0 < _seam_rows(ds, BUDGET).sum() < ROWS
    np.testing.assert_array_equal(streamed, resident)


def test_each_band_stitches_its_real_tiles(make_geotiff, monkeypatch):
    """Each band's canvas gets its own tiles in batches of the resident
    scene's size (cuDNN may compute a tile otherwise at another batch
    size), the last padded on its real tiles: every stitch's box is its
    real tiles' (K2's launch box)."""
    ds, _ = _datasets(make_geotiff, None)
    model = _models()[3]
    calls = []
    stitch_tiles = ttiled.stitch.stitch_tiles

    def record(canvas, tiles, positions, wy, wx, means, sigma, **kwargs):
        calls.append((tuple(canvas.shape), positions.numpy().copy(),
                      wy.numpy().copy(), kwargs["bounds"]))
        return stitch_tiles(canvas, tiles, positions, wy, wx, means, sigma, **kwargs)

    monkeypatch.setattr(ttiled.stitch, "stitch_tiles", record)
    batch_size = 8
    ttiled.predict_linear_blend_streaming(model, ds, device="cpu",
                                          batch_size=batch_size,
                                          max_device_pixels=BUDGET)
    expected = []
    for window, idx, positions in ttiled._iter_bands(ds, BUDGET // (COLS * 4)):
        for start in range(0, len(idx), batch_size):
            expected.append(((window.stop - window.start, COLS),
                             positions[start:start + batch_size]))
    assert len(calls) == len(expected) > 3
    assert any(len(real) < batch_size for _, real in expected)
    for (shape, positions, wy, bounds), (want_shape, real) in zip(calls, expected):
        assert shape == want_shape and len(positions) == batch_size
        assert bounds == (real[:, 0].min(), real[:, 1].min(),
                          real[:, 0].max() + TILE, real[:, 1].max() + TILE)
        np.testing.assert_array_equal(positions[:len(real)], real)
        assert (wy[len(real):] == 0).all()


def test_budget_below_one_band_raises(make_geotiff):
    """The JAX package takes one tile-high band over its budget; the port
    raises, naming the budget and the band it needs."""
    ds, _ = _datasets(make_geotiff, None)
    model = _models()[3]
    need = TILE * COLS * 4
    with pytest.raises(ValueError, match=f"{need - 1:,} cannot hold one 16-row "
                                         f"band.*{need:,} pixels"):
        ttiled.predict_linear_blend_streaming(model, ds, device="cpu",
                                              max_device_pixels=need - 1)
    out = ttiled.predict_linear_blend_streaming(model, ds, device="cpu",
                                                batch_size=16,
                                                max_device_pixels=need)
    assert np.isfinite(out).all() and out.shape == (ROWS, COLS)
