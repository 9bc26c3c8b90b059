"""The port's blend weight table and the resident scene's fetched canvas,
on the CPU.

* ``ops/blend.py::weight_table`` computes each distinct border once and
  gathers its rows; the table is bitwise the JAX package's, which
  calls ``axis_weights`` for every tile, on grids from
  ``geo/grid.py::create_regular_grid``: a 4096² scene, a ragged area with
  edge-shifted last tiles, stride equal to the tile, overlap 1, a region
  narrower than a tile, two regions, and no tiles at all.
* ``predict_linear_blend`` hands each call's caller an array of its own: a
  later scene neither writes to an earlier scene's array nor shares its
  memory. It fetches a canvas through ``_fetch`` (pinned memory on CUDA)
  up to ``PINNED_SCENE_BYTES`` and a larger one as before.
* ``_fetch`` records its event on the canvas device's stream, which the
  copy runs on, and not on the current device's (CUDA mocked).
"""

import types
from unittest import mock

import numpy as np
import pytest
import torch

from resdepth_tpu.ops import blend as j_blend
from resdepth_tpu_torch.data.dataset import TileDataset
from resdepth_tpu_torch.geo import grid
from resdepth_tpu_torch.infer import tiled
from resdepth_tpu_torch.models import unet
from resdepth_tpu_torch.ops import blend


def _area(*regions):
    """An ``area_defn`` of inclusive (y0, y1, x0, x1) regions."""
    return {"y_extent": [(y0, y1) for y0, y1, _, _ in regions],
            "x_extent": [(x0, x1) for _, _, x0, x1 in regions]}


@pytest.mark.parametrize("area,tile,stride,n_tiles", [
    (_area((0, 4095, 0, 4095)), 256, 128, 961),
    (_area((0, 999, 0, 1299)), 256, 128, 70),
    (_area((0, 999, 0, 1299)), 256, 256, 24),
    (_area((0, 999, 0, 1299)), 256, 255, 24),
    (_area((0, 199, 5, 180)), 256, 128, 1),
    (_area((3, 700, 0, 510), (900, 1400, 40, 600)), 128, 96, 65),
    (_area(), 16, 8, 0),
], ids=["4096", "ragged", "stride=tile", "overlap1", "narrow", "two-regions",
        "no-tiles"])
def test_weight_table_is_bitwise_the_per_tile_loop(area, tile, stride, n_tiles):
    _, borders = grid.create_regular_grid(area, tile, stride)
    assert len(borders) == n_tiles
    if n_tiles == 1:     # the region narrower than a tile: ul < overlap
        assert borders[0][0] < tile - stride
    got = blend.weight_table(tile, stride, np.asarray(borders, np.int32))
    want = j_blend.weight_table(tile, stride, borders)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (n_tiles, tile)
        assert np.array_equal(g, w)


def _scenes(make_geotiff, n):
    """``n`` seeded 32x40 geom scenes on 16-px tiles, and a small UNet."""
    rng = np.random.default_rng(3)
    area = {"x_extent": [(0, 39)], "y_extent": [(0, 31)]}
    datasets = [TileDataset({"raster_in": make_geotiff(f"dsm{i}.tif", dsm),
                             "area_defn": area},
                            input_channels="geom", tile_size=16,
                            sampling_strategy="test", dsm_std=5.0)
                for i, dsm in enumerate(
                    (400.0 + rng.normal(0.0, 3.0, (n, 32, 40))).astype(np.float32))]
    model = unet.init_unet(
        unet.UNetConfig(n_input_channels=1, start_kernel=4, max_filter_depth=8, depth=2),
        torch.Generator().manual_seed(0))
    return datasets, model


def test_scene_array_belongs_to_its_caller(make_geotiff):
    """Two scenes in a row: the first scene's array still holds what it
    held, and shares no memory with the second's."""
    datasets, model = _scenes(make_geotiff, 2)
    first = tiled.predict_linear_blend(model, datasets[0], device="cpu", batch_size=4)
    kept = first.copy()
    second = tiled.predict_linear_blend(model, datasets[1], device="cpu", batch_size=4)
    assert not np.shares_memory(first, second)
    np.testing.assert_array_equal(first, kept)
    assert not np.array_equal(first, second)


@pytest.mark.parametrize("bound,pinned", [(tiled.PINNED_SCENE_BYTES, True), (0, False)],
                         ids=["up-to-the-bound", "past-the-bound"])
def test_scene_fetch_pins_up_to_the_bound(make_geotiff, monkeypatch, bound, pinned):
    """A canvas of at most ``PINNED_SCENE_BYTES`` goes through ``_fetch``; a
    larger one does not. Either way the array is the canvas."""
    (ds,), model = _scenes(make_geotiff, 1)
    want = tiled.predict_linear_blend(model, ds, device="cpu", batch_size=4,
                                      as_numpy=False).numpy()
    fetched = []
    fetch = tiled._fetch
    monkeypatch.setattr(tiled, "_fetch", lambda canvas: fetched.append(canvas) or fetch(canvas))
    monkeypatch.setattr(tiled, "PINNED_SCENE_BYTES", bound)
    got = tiled.predict_linear_blend(model, ds, device="cpu", batch_size=4)
    assert len(fetched) == pinned
    np.testing.assert_array_equal(got, want)


def test_fetch_records_on_the_canvas_devices_stream(monkeypatch):
    """With cuda:0 current, a canvas on cuda:1 is copied on cuda:1's stream,
    so the event that ``_fetch`` hands back is recorded there."""
    recorded = []

    class Event:
        def record(self, stream=None):
            recorded.append(stream)

    host = mock.MagicMock()
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: ("stream of", torch.device(device or "cuda:0")))
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch, "empty", lambda *args, **kwargs: host)
    canvas = types.SimpleNamespace(device=torch.device("cuda", 1), shape=(4, 5),
                                   dtype=torch.float32)
    got, done = tiled._fetch(canvas)
    assert got is host and isinstance(done, Event)
    host.copy_.assert_called_once_with(canvas, non_blocking=True)
    assert recorded == [("stream of", torch.device("cuda", 1))]
