"""Tile-grid generation over geographic regions.

Pure-function re-implementations of the reference's grid math:
  * ``create_regular_grid``  — lib/rasterutils.py:100-191
  * ``indices_from_area_defn`` — lib/data_allocation.py:332-378

Semantics preserved exactly (unit-tested against hand-derived goldens):
tiles advance by ``stride``; a tile that would cross the region border is
shifted inward so its trailing edge coincides with the border, and the
per-tile exclusive ("without overlap") pixel bounds account for the
accumulated shift. These exclusive bounds feed both validation loss masking
and inference blend weights.

The port's copy of ``resdepth_tpu/geo/grid.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

from __future__ import annotations

import numpy as np


def _axis_tiles(a: int, b: int, tile: int, stride: int):
    """Tile starts + forward-exclusive tile-local bounds along one axis.

    Closed form of the reference's marching loop over the inclusive pixel
    range ``[a, b]`` (tiles advance by ``stride``; the final tile is shifted
    inward so its trailing edge lands on ``b``):
      * ``starts[k] = a + k*stride``, except the last, clamped to
        ``b - tile + 1``;
      * exclusive bounds ``[lo, hi]`` (tile-local): the first tile owns its
        leading ``stride`` pixels (``[0, stride-1]``), every later tile owns
        ``[tile-stride, stride-1]``; the clamp adds the inward shift to the
        last tile's ``lo`` and extends its ``hi`` to the tile edge.
    Degenerate ranges (``a >= b``) produce no tiles, exactly like the
    reference's ``while`` condition.
    """
    if a >= b:
        empty = np.empty(0, np.int64)
        return empty, empty, empty
    span = b - a + 1
    n = 1 if tile >= span else 1 - ((span - tile) // -stride)  # ceil div
    starts = a + stride * np.arange(n, dtype=np.int64)
    lo = np.full(n, tile - stride, np.int64)
    hi = np.full(n, stride - 1, np.int64)
    lo[0] = 0
    shift = int(starts[-1]) + tile - 1 - b          # inward clamp distance
    starts[-1] = b - tile + 1
    lo[-1] += shift
    hi[-1] = tile - 1
    return starts, lo, hi


def create_regular_grid(area_defn, tile_size: int, stride: int | None = None):
    """Enumerate (possibly overlapping) tiles covering each region.

    Returns ``(tile_position, region_wo_overlap)``:
      tile_position[i] = (uly, ulx): upper-left raster coordinates of tile i;
      region_wo_overlap[i] = (border_uly, border_ulx, border_lry, border_lrx):
        tile-local pixel bounds of the part of tile i not covered by any
        earlier tile along each axis.

    The grid separates per axis, so each region is the cross product of two
    1-D tilings (:func:`_axis_tiles`), emitted row-major.
    """
    if stride is None:
        stride = tile_size

    tile_position: list[tuple[int, int]] = []
    region_wo_overlap: list[tuple[int, int, int, int]] = []

    for x_ext, y_ext in zip(area_defn["x_extent"], area_defn["y_extent"]):
        xs, xlo, xhi = _axis_tiles(int(x_ext[0]), int(x_ext[1]), tile_size, stride)
        ys, ylo, yhi = _axis_tiles(int(y_ext[0]), int(y_ext[1]), tile_size, stride)
        for y, lo_y, hi_y in zip(ys.tolist(), ylo.tolist(), yhi.tolist()):
            tile_position.extend((y, x) for x in xs.tolist())
            region_wo_overlap.extend(
                (lo_y, lo_x, hi_y, hi_x)
                for lo_x, hi_x in zip(xlo.tolist(), xhi.tolist()))

    return tile_position, region_wo_overlap


def indices_from_area_defn(area_defn, tile_size: int):
    """All valid tile upper-left positions fully inside each region.

    Returns a list of (y, x) tuples; a position is valid when the whole
    ``tile_size`` x ``tile_size`` patch fits inside the region.
    """
    valid_positions: list[tuple[int, int]] = []
    for x_ext, y_ext in zip(area_defn["x_extent"], area_defn["y_extent"]):
        x_start, x_end = int(x_ext[0]), int(x_ext[1]) - tile_size + 1
        y_start, y_end = int(y_ext[0]), int(y_ext[1]) - tile_size + 1
        if x_end < x_start or y_end < y_start:
            continue
        ys = np.arange(y_start, y_end + 1)
        xs = np.arange(x_start, x_end + 1)
        grid_y, grid_x = np.meshgrid(ys, xs, indexing="ij")
        valid_positions.extend(zip(grid_y.ravel().tolist(), grid_x.ravel().tolist()))
    return valid_positions


def positions_as_array(positions) -> np.ndarray:
    """(N, 2) int32 array of (y, x) positions — device-friendly layout."""
    return np.asarray(positions, dtype=np.int32).reshape(-1, 2)
