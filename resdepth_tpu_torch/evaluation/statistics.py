"""Masked residual statistics: MAE, RMSE, MedAE, median, NMAD, min/max, count.

Parity with the reference's lib/evaluation.py:11-160. Statistics run on the
host in float64 (the TPU has no f64; exact medians over ~1e8 masked pixels are
a sort problem, not a matmul problem — SURVEY.md §7 risk list), while
training-loop metrics use the device-side path in ``train.metrics``.

Quirk register (SURVEY.md): the reference's NMAD centres the absolute
deviations on the MEDIAN ABSOLUTE error (MedAE), not on the median error
(lib/evaluation.py:120-121) — textbook NMAD uses the median. Both behaviours
are implemented; ``nmad_center='medae'`` (the default) reproduces the
reference bit-for-bit, ``'median'`` gives the textbook statistic.

The port's copy of ``resdepth_tpu/evaluation/statistics.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

from __future__ import annotations

import numpy as np

from resdepth_tpu_torch.utils.attrdict import AttrDict


def compute_residuals(raster, raster_gt, nodata, mask_gt=None) -> np.ma.MaskedArray:
    """Masked residual map ``raster - raster_gt``.

    Positive = predicted height above reference. Invalid ground-truth pixels
    (== nodata or excluded by ``mask_gt``) and invalid input pixels are masked
    (parity: lib/evaluation.py:11-36).
    """
    if mask_gt is not None:
        gt_mask = np.ma.mask_or(raster_gt == nodata, ~np.asarray(mask_gt, bool))
    else:
        gt_mask = raster_gt == nodata
    gt_masked = np.ma.masked_array(raster_gt, mask=gt_mask)
    raster_masked = np.ma.masked_where(raster == nodata, raster)
    return raster_masked - gt_masked


def truncate_residuals(residuals, threshold) -> np.ma.MaskedArray:
    """Mask residuals outside [-threshold, threshold] (lib/evaluation.py:39-48)."""
    return np.ma.masked_outside(residuals, -threshold, threshold)


def _core_stats(residuals, nmad_center: str) -> AttrDict:
    abs_residuals = np.ma.abs(residuals)
    stats = AttrDict()
    stats.count_total = float(np.ma.count(residuals))
    stats.MAE = np.ma.mean(abs_residuals)
    stats.RMSE = np.ma.sqrt(np.ma.mean(abs_residuals ** 2))
    stats.absolute_median = np.ma.median(abs_residuals)
    stats.median = np.ma.median(residuals)
    center = stats.absolute_median if nmad_center == "medae" else stats.median
    stats.NMAD = 1.4826 * np.ma.median(np.ma.abs(residuals - center))
    return stats


def get_statistics(residuals_masked, residual_threshold=None,
                   nmad_center: str = "medae") -> AttrDict:
    """Evaluation metrics over masked residuals, optionally also truncated.

    Returns the reference's stats dict shape (lib/evaluation.py:51-131):
    {truncation, count_total, diff_max, diff_min, MAE, RMSE, absolute_median,
    median, NMAD[, truncated: {...}]}.
    """
    residuals_masked = np.ma.masked_array(residuals_masked)
    stats = _core_stats(residuals_masked, nmad_center)
    stats.truncation = bool(residual_threshold)
    stats.diff_max = np.ma.MaskedArray.max(residuals_masked)
    stats.diff_min = np.ma.MaskedArray.min(residuals_masked)

    if residual_threshold:
        truncated = truncate_residuals(residuals_masked, residual_threshold)
        stats.truncated = _core_stats(truncated, nmad_center)
        stats.truncated.threshold = residual_threshold
    return stats


def print_statistics(stats, logger, print_min_max: bool = True) -> None:
    """Log the metrics in the reference's report format (lib/evaluation.py:134-160)."""
    if print_min_max:
        logger.info("Maximum residual error [m]:\t\t\t\t\t\t{:10.3f} m".format(stats.diff_max))
        logger.info("Minimum residual error [m]:\t\t\t\t\t\t{:10.3f} m".format(stats.diff_min))

    logger.info("Mean absolute residual error (MAE) [m]:\t\t\t\t\t{:10.3f} m".format(stats.MAE))
    logger.info("RMSE residual error [m]:\t\t\t\t\t\t{:10.3f} m".format(stats.RMSE))
    logger.info("Absolute median residual error [m]:\t\t\t\t\t{:10.3f} m".format(stats.absolute_median))
    logger.info("Median residual error [m]:\t\t\t\t\t\t{:10.3f} m".format(stats.median))
    logger.info("Normalized median absolute deviation (NMAD) [m]:\t\t\t{:10.3f} m\n".format(stats.NMAD))

    if stats.truncation:
        t = stats.truncated
        logger.info("Truncated mean absolute residual error (MAE) [m]:\t\t\t{:10.3f} m".format(t.MAE))
        logger.info("Truncated RMSE residual error [m]:\t\t\t\t\t{:10.3f} m".format(t.RMSE))
        logger.info("Truncated absolute median residual error [m]:\t\t\t\t{:10.3f} m".format(t.absolute_median))
        logger.info("Truncated median residual error [m]:\t\t\t\t\t{:10.3f} m".format(t.median))
        logger.info("Truncated normalized median absolute deviation (NMAD) [m]:\t\t{:10.3f} m\n".format(t.NMAD))
