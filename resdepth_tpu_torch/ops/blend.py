"""Linear-blend weights for overlap-add tile stitching.

Re-derivation of the reference's per-tile blend weights
(the reference's lib/evaluation.py:516-567) in separable form: the reference
builds a (T, T) weight image per tile by multiplying column ramps and row
ramps into a ones image — which factorises exactly as an outer product
``w[i, j] = wy[i] * wx[j]``. The TPU build exploits this: per-tile weights are
stored as two (T,) vectors (N*2*T floats instead of N*T^2) and the outer
product is formed on device inside the fused stitch step.

Semantics per axis, given the tile's exclusive (non-overlap) bounds [ul, lr]
(tile-local, inclusive) from the grid generator:
  * weight 1 inside the exclusive region,
  * a linear 0->1 ramp over the ``overlap = tile - stride`` band entering it,
  * a 1->0 ramp over the trailing band when the tile is not flush with the
    region border (lr < tile-1),
  * 0 beyond the leading ramp for edge-shifted tiles (ul > overlap).

Partition of unity: for any grid produced by ``create_regular_grid`` with
ceil(tile/2) <= stride <= tile, the stitched weights sum to exactly 1 over
the region (unit-tested). Below tile/2 more than two tiles overlap per axis
position and two linear ramps cannot sum to 1 — the config validator rejects
such strides (`general.tile_stride`).

The port's copy of ``resdepth_tpu/ops/blend.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

from __future__ import annotations

import numpy as np


def axis_weights(tile_size: int, stride: int, ul: int, lr: int) -> np.ndarray:
    """(T,) blend weights along one axis for exclusive bounds [ul, lr]."""
    weights = np.ones(tile_size, dtype=np.float32)
    overlap = tile_size - stride
    if overlap <= 0:
        # Non-overlapping grid: overlap exists only where an edge-shifted
        # final tile re-covers earlier tiles. No ramp band exists, so the
        # exclusive-region indicator is the exact partition of unity. (The
        # reference never blends at stride == tile — lib/evaluation.py:460 is
        # only called on stride = tile/2 grids — and its weight code would
        # fail on this case; this generalisation keeps stitching exact for
        # any stride.)
        weights[:ul] = 0.0
        weights[lr + 1:] = 0.0
        return weights
    if overlap == 1:
        # linspace(0, 1, 1) = [0]: both tiles would zero the shared pixel.
        ramp = np.full(1, 0.5, dtype=np.float32)
    else:
        ramp = np.linspace(0.0, 1.0, overlap, endpoint=True, dtype=np.float32)

    if ul > 0:
        if ul >= overlap:
            weights[ul - overlap:ul] *= ramp
            weights[:ul - overlap] = 0.0
        else:
            # ul < overlap: a single clamped tile serves a region narrower
            # than the tile (stride < span < tile), so no in-region
            # neighbour exists and the leading band is entirely OUT of the
            # region. Clip the ramp's head at the tile start — the natural
            # limit of the reference formula, whose [ul-overlap, ul) slice
            # collapses to an empty array and crashes on this case
            # (lib/evaluation.py:541-545).
            weights[:ul] *= ramp[overlap - ul:]
    if lr < tile_size - 1:
        n_trailing = tile_size - lr - 1
        weights[lr + 1:] *= ramp[::-1][:n_trailing]
    return weights


def tile_weights(tile_size: int, stride: int, bounds) -> np.ndarray:
    """(T, T) blend weight image for one tile (reference-compatible form).

    ``bounds`` = (uly, ulx, lry, lrx), tile-local inclusive exclusive-region
    bounds as produced by ``geo.grid.create_regular_grid``.
    """
    uly, ulx, lry, lrx = bounds
    wy = axis_weights(tile_size, stride, uly, lry)
    wx = axis_weights(tile_size, stride, ulx, lrx)
    return np.outer(wy, wx)


def weight_table(tile_size: int, stride: int, borders) -> tuple[np.ndarray, np.ndarray]:
    """Separable blend weights for a whole tile grid.

    Returns ``(wy, wx)`` of shape (N, T) each; tile i's weight image is
    ``outer(wy[i], wx[i])``.
    """
    n = len(borders)
    wy = np.empty((n, tile_size), dtype=np.float32)
    wx = np.empty((n, tile_size), dtype=np.float32)
    for i, (b_uly, b_ulx, b_lry, b_lrx) in enumerate(borders):
        wy[i] = axis_weights(tile_size, stride, b_uly, b_lry)
        wx[i] = axis_weights(tile_size, stride, b_ulx, b_lrx)
    return wy, wx
