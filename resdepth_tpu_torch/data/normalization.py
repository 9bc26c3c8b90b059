"""Normalization parameter estimation and (de)normalization transforms.

Host-side parameter estimation (parity with the reference's lib/utils.py:
111-200) plus pure-function transforms (parity with lib/data_normalization.py:
6-53). Estimation runs on the host in extended precision: the reference uses
float128 for the DSM sigma pass (lib/utils.py:134); NumPy's ``longdouble`` is
the same x87 80-bit type on this platform. The transforms themselves are
trivially jittable (used inside the device preprocessing stage).

The port's copy of ``resdepth_tpu/data/normalization.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

from __future__ import annotations

import numpy as np


def normalize(data, mean, std):
    """(data - mean) / std — works on numpy or jax arrays."""
    return (data - mean) / std


def denormalize(data, mean, std):
    """data * std + mean — works on numpy or jax arrays, broadcasting
    per-sample means of shape (N,) against (N, H, W[, C]) data."""
    return data * std + mean


def robust_mean_std(stds) -> float:
    """Trim sigmas outside the [5th, 95th] percentile band and average."""
    stds = np.asarray(stds, dtype=np.float64)
    hi = np.percentile(stds, 95)
    lo = np.percentile(stds, 5)
    keep = stds[(stds >= lo) & (stds <= hi)]
    return float(keep.mean())


def compute_local_dsm_std_per_centered_patch(patches, nodata) -> float:
    """Single robust sigma across mean-centred DSM training patches.

    Parity with lib/utils.py:111-158: each patch is centred on its own masked
    mean; the per-patch standard deviation (ddof=1 over valid pixels) is
    computed in extended precision; sigmas outside the [5th, 95th] percentile
    band are discarded; the remainder is averaged.

    ``patches``: iterable of (T, T) float arrays (or an (N, T, T) array).
    """
    stds = []
    for patch in patches:
        x = np.ma.masked_where(patch == nodata, patch.astype(np.longdouble))
        mean = x.mean()
        count = x.count()
        stds.append(float(np.sqrt(((x - mean) ** 2).sum() / max(count - 1, 1))))
    return robust_mean_std(stds)


def patch_stds_from_positions(dsm, nodata, positions, tile_size: int) -> np.ndarray:
    """Vectorised per-patch masked standard deviations at (y, x) ``positions``.

    Same per-patch statistic as ``compute_local_dsm_std_per_centered_patch``
    but O(HW+N) via summed-area tables of (valid, x, x^2) instead of a Python
    loop over patches — the reference's float128 loop over 20k patches
    (lib/utils.py:129-150) becomes three f64 cumsums after global centring
    (centring keeps the x^2 table well-conditioned).
    """
    positions = np.asarray(positions).reshape(-1, 2)
    data = dsm.astype(np.float64)
    valid = (data != nodata)
    centred = np.where(valid, data - data[valid].mean() if valid.any() else data, 0.0)

    def sat(a):
        table = np.zeros((a.shape[0] + 1, a.shape[1] + 1), np.float64)
        np.cumsum(np.cumsum(a, axis=0), axis=1, out=table[1:, 1:])
        return table

    t_n = sat(valid.astype(np.float64))
    t_s = sat(centred)
    t_q = sat(centred * centred)

    ys, xs = positions[:, 0], positions[:, 1]
    t = tile_size

    def window(table):
        return (table[ys + t, xs + t] - table[ys, xs + t]
                - table[ys + t, xs] + table[ys, xs])

    n = window(t_n)
    s1 = window(t_s)
    s2 = window(t_q)
    n_safe = np.maximum(n, 1.0)
    var = (s2 - s1 * s1 / n_safe) / np.maximum(n - 1.0, 1.0)
    return np.sqrt(np.maximum(var, 0.0))


def sigma_from_positions(dsm, nodata, positions, tile_size: int,
                         exact: bool = False) -> float:
    """Robust sigma over patches at ``positions`` (trimmed mean of patch stds)."""
    if exact:
        positions = np.asarray(positions).reshape(-1, 2)
        patches = (dsm[y:y + tile_size, x:x + tile_size] for y, x in positions)
        return compute_local_dsm_std_per_centered_patch(patches, nodata)
    return robust_mean_std(patch_stds_from_positions(dsm, nodata, positions, tile_size))


def compute_satellite_image_normalization(cfg_data, open_band=None):
    """Mean/std of raw radiance over the training regions of all training images.

    Parity with lib/utils.py:161-200: for each dataset, the union of images
    referenced by its training pairs is cropped to the training regions; mean
    and std are taken over the concatenation (computed here with a streaming
    f64 two-pass-free accumulation instead of materialising the concat).
    """
    if open_band is None:
        from resdepth_tpu_torch.geo.raster import open_raster

        def open_band(path):
            return open_raster(path).band(1).astype(np.float32)

    total = 0.0
    total_sq = 0.0
    count = 0
    for dataset in cfg_data:
        image_ids = sorted({idx for pair in dataset["image_pairs"] for idx in pair})
        for index in image_ids:
            img = open_band(dataset["image_list"][index])
            area_defn = dataset["area_defn"]
            for x_ext, y_ext in zip(area_defn["x_extent"], area_defn["y_extent"]):
                crop = img[y_ext[0]:y_ext[1] + 1, x_ext[0]:x_ext[1] + 1].astype(np.float64)
                total += crop.sum()
                total_sq += np.square(crop).sum()
                count += crop.size
    mean = total / count
    var = max(total_sq / count - mean * mean, 0.0)
    return float(mean), float(np.sqrt(var))
