"""Masked residual statistics: MAE, RMSE, MedAE, median, NMAD, min/max, count.

Parity with the reference's lib/evaluation.py:11-160. Statistics run on the
host in float64, while training-loop metrics use the device-side path in
``train.metrics``.

Each set of pixels (a class, and its truncated part) is compacted once into a
vector of its valid residuals. The medians are exact selections on that vector
(``np.partition``), not the full masked sorts of ``np.ma.median``: the middle
pair of an even count is summed and halved as ``np.ma.median`` does, and an
unmasked NaN makes the median NaN. MAE and RMSE are not summed over the
compacted vector but over the full, zero-filled array, as ``np.ma.mean`` sums
them: a sum of the same values in another order rounds differently. The
truncated part takes the class's ``|r|`` and squares with those past the
threshold set to zero, and compacts its vector from the class's.

So every statistic is bitwise what ``np.ma`` gives for finite or NaN
residuals; where ``np.ma.median`` raises instead (valid values mostly NaN, with
masked pixels besides), the median is NaN. Infinite residuals meet quirks of
``np.ma`` that this does not copy (a mean masked where there is no mask, ties
with the sort's fill for masked pixels). A set with no valid pixel takes the
``np.ma`` path, which gives ``np.ma.masked``.

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
    """The statistics by ``np.ma``, taken for a set with no valid pixel."""
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


def _median(values: np.ndarray, has_nan: bool) -> np.float64:
    """``np.ma.median`` of a vector of valid values, by selection; reorders ``values``."""
    if has_nan:
        return np.float64(np.nan)
    k, odd = divmod(values.size, 2)
    # One kth a call: np.partition is several times faster with a single kth.
    values.partition(k)
    if not odd:
        values[:k].partition(k - 1)
    middle = values[k + odd - 1:k + 1].sum()
    return middle if odd else np.true_divide(middle, 2.)


def _selected_stats(values, abs_filled, squares, nmad_center: str) -> AttrDict:
    """``_core_stats`` of a set with valid pixels.

    ``values`` holds its valid residuals, compacted, and is reordered here.
    ``abs_filled`` and ``squares`` hold ``|r|`` and ``np.power(|r|, 2)`` at
    them and 0 elsewhere, at the full array's size, as ``np.ma.mean`` sums.
    """
    count = values.size
    abs_sum = abs_filled.sum()
    # |r| sums to NaN exactly when some valid r is NaN.
    has_nan = bool(np.isnan(abs_sum))
    square_sum, square_count = squares.sum(), count
    if not np.isfinite(square_sum):
        # np.ma.power masks the squares that are not finite.
        finite = np.isfinite(squares)
        square_sum = np.where(finite, squares, 0.).sum()
        square_count -= finite.size - int(np.count_nonzero(finite))
    mean_square = square_sum * 1. / square_count if square_count else np.ma.masked

    stats = AttrDict()
    stats.count_total = float(count)
    stats.MAE = abs_sum * 1. / count
    stats.RMSE = np.ma.sqrt(mean_square)
    stats.absolute_median = _median(np.abs(values), has_nan)
    stats.median = _median(values, has_nan)
    center = stats.absolute_median if nmad_center == "medae" else stats.median
    stats.NMAD = 1.4826 * _median(np.abs(values - center), has_nan)
    return stats


def get_statistics(residuals_masked, residual_threshold=None,
                   nmad_center: str = "medae") -> AttrDict:
    """Evaluation metrics over masked residuals, optionally also truncated.

    Returns the reference's stats dict shape (lib/evaluation.py:51-131):
    {truncation, count_total, diff_max, diff_min, MAE, RMSE, absolute_median,
    median, NMAD[, truncated: {...}]}.
    """
    residuals_masked = np.ma.masked_array(residuals_masked)
    data = np.ma.getdata(residuals_masked)
    mask = np.ma.getmaskarray(residuals_masked)
    values = data[~mask]
    if values.size:
        abs_filled = np.abs(data)
        abs_filled[mask] = 0.
        squares = np.power(abs_filled, 2)
        stats = _selected_stats(values, abs_filled, squares, nmad_center)
        diff_max, diff_min = values.max(), values.min()
    else:
        stats = _core_stats(residuals_masked, nmad_center)
        diff_max = np.ma.MaskedArray.max(residuals_masked)
        diff_min = np.ma.MaskedArray.min(residuals_masked)
    stats.truncation = bool(residual_threshold)
    stats.diff_max, stats.diff_min = diff_max, diff_min

    if residual_threshold:
        # truncate_residuals' test, which keeps NaN: |r| past the threshold.
        limit = abs(residual_threshold)
        kept = values[~(np.abs(values) > limit)]
        if kept.size:
            outside = abs_filled > limit
            stats.truncated = _selected_stats(
                kept, np.where(outside, 0., abs_filled), np.where(outside, 0., squares),
                nmad_center)
        else:
            stats.truncated = _core_stats(
                truncate_residuals(residuals_masked, residual_threshold), nmad_center)
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
