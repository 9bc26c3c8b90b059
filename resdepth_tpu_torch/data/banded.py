"""Banded residency: refine and train on regions larger than the device's
raster budget.

Port of ``resdepth_tpu/data/banded.py``. The full rasters stay in host RAM,
as the reference keeps them; the samples (or, for inference, the tiles) are
grouped into windows whose rasters fit ``max_device_pixels``, and one
window at a time is on the device:

  * ``iter_bands`` cuts full-width row bands (inference and 1-D training
    windows); ``iter_bands_2d`` cuts each row band along columns too when
    one tile-high band of the full width does not fit (2-D windows), so the
    only hard floor is one tile x tile window of all planes;
  * ``make_banded_loaders`` gives one ``(provider, iterator)`` loader per
    window; the trainer resolves a provider per chunk and visits each
    window's batches contiguously (``Trainer(group_chunks_by_loader=True)``),
    so an epoch uploads each window once.

Every training window is padded to one common shape (DSM planes with
``nodata``, orthos with 0). Positions are rebased into their window and
never reach the padding.

Semantics: positions, pair assignments, masks and normalisation are the
resident path's; banding changes only how an epoch groups its batches
(samples batch within their window, one more shuffle level).
``band_resident=False`` builds the twin: the same loaders and batch order
with the full scene resident and global positions, which must train to the
same weights.

Budget: one window per source is resident, so size ``max_device_pixels``
at no more than half the device memory spare for rasters
(``docs/SCALING.md``), as for the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from resdepth_tpu_torch.data.pipeline import (BatchIndexIterator, DeviceRasters,
                                              device_put_dataset, to_device)


def iter_bands(positions: np.ndarray, tile: int, rows_budget: int):
    """Partition samples into horizontal bands of <= rows_budget raster rows.

    Yields ``(window, band_idx, band_positions)``: the band's raster row
    slice, the indices of its samples, and their positions rebased to the
    window. A sample goes to the band that holds its top row, so adjacent
    windows overlap by < tile rows; the bands' canvases together give the
    whole scene's stitch (``infer/tiled.py``).
    """
    order = np.argsort(positions[:, 0], kind="stable")
    start = 0
    n = len(order)
    while start < n:
        band_y0 = int(positions[order[start], 0])
        end = start
        max_uly = band_y0
        while end < n:
            uly = int(positions[order[end], 0])
            if uly + tile - band_y0 > rows_budget and end > start:
                break
            max_uly = max(max_uly, uly)
            end += 1
        window_rows = max_uly + tile - band_y0
        band_idx = order[start:end]
        band_positions = positions[band_idx].copy()
        band_positions[:, 0] -= band_y0
        yield slice(band_y0, band_y0 + window_rows), band_idx, band_positions
        start = end


def iter_bands_2d(positions: np.ndarray, tile: int, rows_budget: int,
                  cols_budget: int, cols: int):
    """Partition samples into 2-D windows of <= rows_budget x cols_budget px.

    Yields ``(row_window, col_window, band_idx, band_positions)`` with
    positions rebased on both axes. With ``cols_budget >= cols`` these are
    ``iter_bands``'s full-width bands; otherwise each row band is cut along
    columns by the same greedy on axis-swapped positions.
    """
    for row_window, row_idx, row_positions in iter_bands(positions, tile,
                                                         rows_budget):
        if cols_budget >= cols:
            yield row_window, slice(0, cols), row_idx, row_positions
            continue
        swapped = row_positions[:, ::-1].copy()  # (x, y): cut along columns
        for col_window, col_idx, col_positions in iter_bands(swapped, tile,
                                                             cols_budget):
            yield (row_window, col_window, row_idx[col_idx],
                   col_positions[:, ::-1].copy())


def resident_pixels(ds, include_target: bool = True) -> int:
    """Raster pixels ``device_put_dataset`` puts on the device."""
    rows, cols = ds.dsm_input.shape
    planes = 1
    if include_target and ds.dsm_target is not None:
        planes += 1
    if ds.orthos is not None:
        planes += ds.orthos.shape[2]
    return planes * rows * cols


def window_budgets_for(ds, max_device_pixels: int,
                       include_target: bool = True) -> tuple[int, int]:
    """``(rows_budget, cols_budget)`` affordable under the pixel budget.

    Full-width row bands come first (``cols_budget == cols``: fewest
    windows, least overlap). When the budget cannot hold one tile-high band
    of the full width, the windows go 2-D: near square (the least overlap
    per cut), clamped to [tile, raster extent] on both axes. Raises below
    one tile x tile window of all planes.
    """
    rows, cols = ds.dsm_input.shape
    planes = resident_pixels(ds, include_target) // (rows * cols)
    tile = ds.tile_size
    if max_device_pixels < planes * tile * tile:
        raise ValueError(
            f"tpu.max_device_pixels {max_device_pixels:,} cannot fit a "
            f"single {tile}x{tile}-px tile window of this region's "
            f"{planes} raster planes (needs at least "
            f"{planes * tile * tile:,} pixels). Raise tpu.max_device_pixels "
            f"or reduce training_settings.tile_size.")
    if max_device_pixels >= planes * cols * tile:
        return int(max_device_pixels // (cols * planes)), cols
    area = max_device_pixels // planes
    rows_budget = min(rows, max(tile, int(np.sqrt(area))))
    cols_budget = min(cols, max(tile, int(area // rows_budget)))
    return rows_budget, cols_budget


def rows_budget_for(ds, max_device_pixels: int,
                    include_target: bool = True) -> int:
    """Full-width window rows affordable under the pixel budget; raises
    when the region needs 2-D windows (``window_budgets_for`` is the
    general entry point)."""
    rows_budget, cols_budget = window_budgets_for(ds, max_device_pixels,
                                                  include_target)
    if cols_budget != ds.dsm_input.shape[1]:
        raise ValueError(
            f"tpu.max_device_pixels {max_device_pixels:,} cannot fit a "
            f"single {ds.tile_size}-row band spanning this region's full "
            f"width; row-only banding is infeasible (training uses 2-D "
            f"windows automatically — window_budgets_for).")
    return rows_budget


@dataclasses.dataclass
class _BandView:
    """One band's samples, as ``BatchIndexIterator`` reads a dataset."""
    positions: np.ndarray
    pair_indices: np.ndarray
    valid_bounds: np.ndarray | None

    def __len__(self) -> int:
        return len(self.positions)


class BandedRasterSource:
    """Host-resident rasters; one window on ``device`` at a time.

    ``uploads`` counts the host-to-device window transfers."""

    def __init__(self, ds, device, window_rows: int,
                 window_cols: int | None = None, include_target: bool = True):
        self.device = torch.device(device)
        self._dsm_input = ds.dsm_input
        self._dsm_target = (ds.dsm_target
                            if include_target and ds.dsm_target is not None
                            else None)
        self._orthos = ds.orthos
        self._pairs = torch.as_tensor(ds.pairs_array, dtype=torch.int64,
                                      device=self.device)
        self._nodata = float(ds.nodata)
        self.window_rows = int(window_rows)
        self.window_cols = int(ds.dsm_input.shape[1] if window_cols is None
                               else window_cols)
        self._key = None
        self._resident = None
        self.uploads = 0

    def _cut(self, arr, y0, x0, pad_value):
        w = arr[y0:y0 + self.window_rows, x0:x0 + self.window_cols]
        pad_r = self.window_rows - w.shape[0]
        pad_c = self.window_cols - w.shape[1]
        if pad_r or pad_c:
            # One window shape for every band; rebased positions stay inside
            # the band's true window, so the padding is never gathered.
            pad = [(0, pad_r), (0, pad_c)] + [(0, 0)] * (w.ndim - 2)
            w = np.pad(w, pad, constant_values=pad_value)
        return w

    def window(self, y0: int, x0: int = 0) -> DeviceRasters:
        """The rasters of the window at (y0, x0), uploaded unless they are
        the resident window already."""
        if self._key != (y0, x0):
            self.release()  # the previous window goes before the next comes
            self._resident = DeviceRasters(
                dsm_input=to_device(self._cut(self._dsm_input, y0, x0,
                                              self._nodata), self.device),
                dsm_target=(to_device(self._cut(self._dsm_target, y0, x0,
                                                self._nodata), self.device)
                            if self._dsm_target is not None else None),
                orthos=(to_device(self._cut(self._orthos, y0, x0, 0.0)
                                  .transpose(2, 0, 1), self.device)
                        if self._orthos is not None else None),
                pairs=self._pairs,
                nodata=self._nodata)
            self._key = (y0, x0)
            self.uploads += 1
        return self._resident

    def release(self) -> None:
        self._resident = None
        self._key = None


class BandWindow:
    """Loader element 0 for one band; the trainer resolves it per chunk."""

    def __init__(self, source: BandedRasterSource, y0: int, x0: int = 0):
        self.source = source
        self.y0 = y0
        self.x0 = x0

    def resolve(self) -> DeviceRasters:
        return self.source.window(self.y0, self.x0)

    def release(self) -> None:
        self.source.release()


class FullResident:
    """The twin of ``BandWindow``: resolves to the full resident scene."""

    def __init__(self, rasters: DeviceRasters):
        self._rasters = rasters

    def resolve(self) -> DeviceRasters:
        return self._rasters

    def release(self) -> None:
        pass


def make_banded_loaders(ds, batch_size: int, *, max_device_pixels: int,
                        seed: int, device, emit_size: int | None = None,
                        shuffle: bool = True, band_resident: bool = True,
                        include_target: bool = True):
    """Split one region into per-window ``(provider, iterator)`` loaders.

    Each window's iterator is seeded from ``(seed, window)``; window tails
    are zero-weight-padded like any partial batch, so the trainer runs with
    weighted BatchNorm statistics. ``band_resident=False`` builds the twin:
    the same windows, seeds and batch order, every provider resolving to
    the full scene on ``device`` with global positions.
    """
    rows_budget, cols_budget = window_budgets_for(ds, max_device_pixels,
                                                  include_target)
    cols = ds.dsm_input.shape[1]
    bands = list(iter_bands_2d(ds.positions, ds.tile_size, rows_budget,
                               cols_budget, cols))
    window_rows = max(rw.stop - rw.start for rw, _, _, _ in bands)
    window_cols = max(cw.stop - cw.start for _, cw, _, _ in bands)

    if band_resident:
        source = BandedRasterSource(ds, device, window_rows, window_cols,
                                    include_target)
    else:
        full = device_put_dataset(ds, device, include_target=include_target)

    loaders = []
    for j, (row_win, col_win, band_idx, band_positions) in enumerate(bands):
        view = _BandView(
            positions=(band_positions if band_resident
                       else ds.positions[band_idx]),
            pair_indices=ds.pair_indices[band_idx],
            valid_bounds=(ds.valid_bounds[band_idx]
                          if ds.valid_bounds is not None else None))
        iterator = BatchIndexIterator(view, batch_size, shuffle=shuffle,
                                      seed=(seed, j), emit_size=emit_size)
        provider = (BandWindow(source, row_win.start, col_win.start)
                    if band_resident else FullResident(full))
        loaders.append((provider, iterator))
    return loaders
