"""In-memory raster abstraction over the GeoTIFF codec.

Replaces the reference's gdal.Dataset plumbing (the reference's lib/
rasterutils.py:6-97, 194-261) with a lightweight ``Raster`` value type:
array + geotransform + nodata + opaque geo tags. All extent math matches the
reference's conventions (gsdY reported positive, maxX/minY via the
geotransform applied at (cols, rows)).

The port's copy of ``resdepth_tpu/geo/raster.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

from __future__ import annotations

import os as _os
from dataclasses import dataclass

import numpy as np

from resdepth_tpu_torch.geo import tiff


@dataclass
class Raster:
    data: np.ndarray                 # (rows, cols) or (rows, cols, bands)
    geotransform: tuple              # GDAL-style 6-tuple
    nodata: float | None = None
    geo_tags: dict | None = None     # raw GeoKey tags for pass-through
    path: str | None = None

    @property
    def rows(self) -> int:
        return self.data.shape[0]

    @property
    def cols(self) -> int:
        return self.data.shape[1]

    def band(self, index: int = 1) -> np.ndarray:
        """1-based band accessor (gdal convention)."""
        if self.data.ndim == 2:
            return self.data
        return self.data[:, :, index - 1]

    @property
    def extent(self) -> dict:
        """Spatial extent (parity with lib/rasterutils.py:52-85)."""
        gt = self.geotransform
        min_x = gt[0]
        max_y = gt[3]
        max_x = gt[0] + gt[1] * self.cols + gt[2] * self.rows
        min_y = gt[3] + gt[4] * self.cols + gt[5] * self.rows
        return {
            "minX": min_x, "maxX": max_x, "minY": min_y, "maxY": max_y,
            "cols": self.cols, "rows": self.rows,
            "gsdX": gt[1], "gsdY": -gt[5],
        }


_OPEN_CACHE: dict = {}
_OPEN_CACHE_MAX = 16


def open_raster(fn) -> Raster:
    """Load a GeoTIFF file (or pass through an already-open Raster).

    Decoded rasters are cached keyed on (path, mtime, size): inference
    iterates image pairs over the same scene and the reference re-reads every
    raster per pair (lib/DsmOrthoDataset.py:293-314); callers treat the
    returned arrays as read-only (all consumers copy via astype).
    """
    if isinstance(fn, Raster):
        return fn
    try:
        stat = _os.stat(fn)
        key = (fn, stat.st_mtime_ns, stat.st_size)
    except OSError:
        key = None
    if key is not None and key in _OPEN_CACHE:
        return _OPEN_CACHE[key]
    data, info = tiff.read(fn)
    geo_tags = {t: info.tags[t] for t in (tiff.GEO_KEY_DIRECTORY,
                                          tiff.GEO_DOUBLE_PARAMS,
                                          tiff.GEO_ASCII_PARAMS,
                                          tiff.GDAL_METADATA)
                if t in info.tags}
    raster = Raster(data=data, geotransform=info.geotransform, nodata=info.nodata,
                    geo_tags=geo_tags, path=fn if isinstance(fn, str) else None)
    if key is not None:
        if len(_OPEN_CACHE) >= _OPEN_CACHE_MAX:
            _OPEN_CACHE.pop(next(iter(_OPEN_CACHE)))
        _OPEN_CACHE[key] = raster
    return raster


def get_raster_extent(fn) -> dict:
    return open_raster(fn).extent


def load_mask_raster(file):
    """Load a GeoTIFF as a boolean mask.

    Pixels equal to 1 are True; nodata pixels are False. Returns
    ``(mask, nodata_mask)`` (parity with lib/rasterutils.py:23-49).
    """
    raster = open_raster(file)
    data = raster.band(1)
    mask = data == 1
    if raster.nodata is not None:
        nodata_mask = data == raster.nodata
        mask = np.logical_and(mask, ~nodata_mask)
    else:
        nodata_mask = np.zeros_like(mask)
    return mask, nodata_mask


def dilate_mask(mask_in: np.ndarray, iterations: int = 1) -> np.ndarray:
    """Binary dilation with a 3x3 cross structuring element.

    Matches scipy.ndimage.binary_dilation's default connectivity-1 element as
    used at lib/rasterutils.py:88-97 — implemented with pure NumPy shifts so
    the geo layer has no scipy dependency.
    """
    mask = mask_in.astype(bool)
    for _ in range(iterations):
        shifted = mask.copy()
        shifted[1:, :] |= mask[:-1, :]
        shifted[:-1, :] |= mask[1:, :]
        shifted[:, 1:] |= mask[:, :-1]
        shifted[:, :-1] |= mask[:, 1:]
        mask = shifted
    return mask


def write_raster(filepath: str, data: np.ndarray, like, offset_x: int = 0,
                 offset_y: int = 0, nodata=None, compress: bool = True,
                 dtype=None) -> None:
    """Export an array as GeoTIFF, copying georeferencing from ``like``.

    Parity with lib/rasterutils.py:194-261: the geotransform origin is shifted
    by (offset_x, offset_y) pixels, nodata defaults to the source raster's
    value, and output is compressed. The reference writes LZW; this framework
    writes Deflate by default (equally standard, far faster to encode).
    """
    src = open_raster(like)
    gt = src.geotransform
    origin_x = gt[0] + gt[1] * offset_x + gt[2] * offset_y
    origin_y = gt[3] + gt[4] * offset_x + gt[5] * offset_y
    out_gt = (origin_x, gt[1], gt[2], origin_y, gt[4], gt[5])

    if nodata is None:
        nodata = src.nodata
    if dtype is None:
        dtype = src.data.dtype
    if np.ma.isMaskedArray(data):
        # must run BEFORE np.asarray, which strips the mask and would leak
        # the raw under-mask values into the raster
        data = data.filled(nodata if nodata is not None else 0)
    data = np.asarray(data).astype(dtype, copy=False)

    tiff.write(filepath, data, geotransform=out_gt, nodata=nodata,
               geo_tags=src.geo_tags, compress="deflate" if compress else "none")
