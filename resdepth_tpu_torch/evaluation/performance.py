"""Full-scene evaluation over pixel classes, before vs. after refinement.

Parity with the reference's lib/evaluation.py:163-457. Metrics are computed
over: all pixels; building pixels (mask dilated by 2 px against wall
aliasing); terrain (non-building); terrain excluding water; terrain excluding
water and forest — each both for the initial DSM ("before") and the refined
DSM ("after"). All raster data is promoted to float64 on the host (parity
with the reference's f64 eval path; the TPU carries no f64).

The port's copy of ``resdepth_tpu/evaluation/performance.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

from __future__ import annotations

import logging

import numpy as np

from resdepth_tpu_torch.evaluation.statistics import compute_residuals, get_statistics, print_statistics
from resdepth_tpu_torch.geo import raster as rasterio_mod
from resdepth_tpu_torch.utils import fs
from resdepth_tpu_torch.utils.attrdict import AttrDict
from resdepth_tpu_torch.utils.logging import setup_logger

#: Report headings per pixel class (reference report format,
#: lib/evaluation.py:347-394); shared with the eval CLI's aggregate report.
CLASS_TITLES = {
    "all": "OVERALL",
    "building": "BUILDING PIXELS",
    "terrain": "TERRAIN PIXELS",
    "terrain_nowater": "TERRAIN PIXELS WITHOUT WATER",
    "terrain_nowater_noforest": "TERRAIN PIXELS WITHOUT WATER/FOREST",
}


def _load_band_f64(source) -> tuple[np.ndarray, float | None, float]:
    r = rasterio_mod.open_raster(source)
    return r.band(1).astype(np.float64), r.nodata, r.geotransform[1]


def _load_optional_mask(path, name, logger):
    if not path:
        return None
    if not fs.file_exists(path):
        logger.info(f"Cannot find the {name} mask: {path}")
        return None
    logger.info(f"\tLoad the {name} mask...")
    mask, nodata_mask = rasterio_mod.load_mask_raster(path)
    return mask, nodata_mask


def evaluate_performance(raster_prediction, ds_raster_input, ds_raster_gt,
                         logger_root=None, area_defn=None, path_gt_mask=None,
                         path_building_mask=None, path_water_mask=None,
                         path_forest_mask=None, logger_stats=None,
                         residual_threshold=None, nmad_center="medae") -> AttrDict:
    """Evaluate a refined DSM against ground truth over pixel classes.

    Returns the residual maps of the refined DSM per class
    ({all[, building, terrain, terrain_nowater, terrain_nowater_noforest]}),
    mirroring the reference's return contract (lib/evaluation.py:211-222).
    """
    if logger_root is None:
        logger_root = setup_logger("eval_logger", level=logging.INFO,
                                   log_to_console=True, log_file=None)
    if logger_stats is None:
        logger_stats = logger_root

    if isinstance(raster_prediction, np.ndarray):
        prediction = np.array(raster_prediction, dtype=np.float64)
    else:
        prediction, _, _ = _load_band_f64(raster_prediction)
    ground_truth, nodata, _ = _load_band_f64(ds_raster_gt)
    initial, _, gsd = _load_band_f64(ds_raster_input)
    nodata = np.float64(nodata)

    masks = AttrDict()
    gt_loaded = _load_optional_mask(path_gt_mask, "ground truth", logger_root)
    masks.ground_truth = gt_loaded[0] if gt_loaded else np.ones(ground_truth.shape, bool)

    building_loaded = _load_optional_mask(path_building_mask, "building", logger_root)
    if building_loaded:
        mask_building, mask_nodata = building_loaded
        # Dilate by 2 px to avoid aliasing at vertical walls (reference :289)
        masks.building = rasterio_mod.dilate_mask(mask_building, iterations=2)
        masks.terrain = ~masks.building
        masks.terrain[mask_nodata] = False

        water_loaded = _load_optional_mask(path_water_mask, "water", logger_root)
        if water_loaded:
            masks.water = water_loaded[0]
            masks.terrain_nowater = masks.terrain & ~masks.water

        forest_loaded = _load_optional_mask(path_forest_mask, "forest", logger_root)
        if forest_loaded:
            masks.forest = forest_loaded[0]
            base = masks.terrain_nowater if "water" in masks else masks.terrain
            masks.terrain_nowater_noforest = base & ~masks.forest

    if area_defn is not None:
        area = np.zeros(ground_truth.shape, bool)
        for x_ext, y_ext in zip(area_defn["x_extent"], area_defn["y_extent"]):
            area[y_ext[0]:y_ext[1] + 1, x_ext[0]:x_ext[1] + 1] = True
        for key in list(masks.keys()):
            masks[key] = np.logical_and(masks[key], area)
        masks.area = area
        ground_truth = ground_truth.copy()
        ground_truth[~area] = nodata

    residuals = AttrDict(before=AttrDict(), after=AttrDict())
    stats = AttrDict(before=AttrDict(), after=AttrDict())

    logger_root.info("\tCompute overall residual errors before and after the refinement...")
    residuals.before.all = compute_residuals(initial, ground_truth, nodata, masks.ground_truth)
    residuals.after.all = compute_residuals(prediction, ground_truth, nodata, masks.ground_truth)
    stats.before.all = get_statistics(residuals.before.all, residual_threshold, nmad_center)
    stats.after.all = get_statistics(residuals.after.all, residual_threshold, nmad_center)

    class_order = []
    if "building" in masks:
        class_order += [("building", masks.building), ("terrain", masks.terrain)]
        if "terrain_nowater" in masks:
            class_order.append(("terrain_nowater", masks.terrain_nowater))
        if "terrain_nowater_noforest" in masks:
            class_order.append(("terrain_nowater_noforest", masks.terrain_nowater_noforest))

    for name, class_mask in class_order:
        logger_root.info(f"\tCompute {name} residual errors before and after the refinement...")
        residuals.after[name] = np.ma.masked_array(residuals.after.all, mask=~class_mask)
        stats.before[name] = get_statistics(
            np.ma.masked_array(residuals.before.all, mask=~class_mask),
            residual_threshold, nmad_center)
        stats.after[name] = get_statistics(residuals.after[name],
                                           residual_threshold, nmad_center)

    # ------------------------------ report ------------------------------ #
    area_km2 = float(stats.before.all.count_total * gsd * gsd) / 1e6
    logger_stats.info("\n\nPerformance Evaluation\n----------------------\n")
    logger_stats.info("Number of pixels:\t\t\t{}".format(int(stats.before.all.count_total)))
    logger_stats.info("Area [km^2]:\t\t\t\t{:.2f}\n".format(area_km2))
    if residual_threshold:
        logger_stats.info("Truncation threshold:\t\t\t{:.2f} m\n".format(residual_threshold))

    for name in ["all"] + [n for n, _ in class_order]:
        for phase, label in (("before", "INITIAL DSM"), ("after", "REFINED DSM")):
            header = f"STATISTICS, {CLASS_TITLES[name]}: {label}"
            logger_stats.info("\n{}\n{}\n".format(header, "-" * len(header)))
            print_statistics(stats[phase][name], logger_stats)

    return residuals.after
