"""A seeded synthetic city: terrain, building blocks, a water band and
stereo-like noise, with hillshaded pseudo ortho views.

The port's copy of ``GSD``, ``NODATA``, ``synth_city`` and ``hillshade``
from ``scripts/make_demo_data.py`` (the part of that script the port uses),
so that ``chip_smoke.py`` makes the same seeded scene without importing the
JAX package. Only the arithmetic is copied; the script's configs and golden
scene stay there.
"""

from __future__ import annotations

import numpy as np

GSD = 0.25
NODATA = -9999.0


def synth_city(rows: int, cols: int, seed: int = 0):
    """Ground-truth DSM with terrain + buildings, plus masks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float32)
    terrain = (420.0 + 6.0 * np.sin(yy / 60.0) + 5.0 * np.cos(xx / 45.0)
               + 2.0 * np.sin((xx + yy) / 90.0))
    gt = terrain.copy()
    building_mask = np.zeros((rows, cols), np.uint8)
    for _ in range(rows * cols // 4000):
        h = rng.uniform(6.0, 25.0)
        by = int(rng.integers(0, rows - 24))
        bx = int(rng.integers(0, cols - 24))
        bh = int(rng.integers(8, 24))
        bw = int(rng.integers(8, 24))
        gt[by:by + bh, bx:bx + bw] = terrain[by:by + bh, bx:bx + bw].mean() + h
        building_mask[by:by + bh, bx:bx + bw] = 1

    water_mask = np.zeros((rows, cols), np.uint8)
    cy = rows // 2
    water_mask[cy - 6:cy + 6, :] = 1
    gt[water_mask == 1] = terrain[water_mask == 1].min() - 1.0
    building_mask[water_mask == 1] = 0

    # Initial DSM: ground truth + stereo-matching-like noise, worse at walls.
    noise = rng.normal(0.0, 0.7, (rows, cols)).astype(np.float32)
    from scipy import ndimage
    wall = ndimage.binary_dilation(building_mask.astype(bool), iterations=2) \
        ^ building_mask.astype(bool)
    noise[wall] += rng.normal(0.0, 3.0, int(wall.sum())).astype(np.float32)
    dsm = (gt + noise).astype(np.float32)
    return gt.astype(np.float32), dsm, building_mask, water_mask


def hillshade(dsm: np.ndarray, azimuth_deg: float) -> np.ndarray:
    """Pseudo ortho view: Lambertian hillshade of the surface."""
    gy, gx = np.gradient(dsm.astype(np.float64), GSD)
    azimuth = np.deg2rad(azimuth_deg)
    altitude = np.deg2rad(45.0)
    slope = np.arctan(np.hypot(gx, gy))
    aspect = np.arctan2(-gx, gy)
    shade = (np.sin(altitude) * np.cos(slope)
             + np.cos(altitude) * np.sin(slope) * np.cos(azimuth - aspect))
    radiance = 80.0 + 120.0 * np.clip(shade, 0, 1)
    return radiance.astype(np.float32)
