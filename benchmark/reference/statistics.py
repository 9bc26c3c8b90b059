"""ResDepth's evaluation of a refined DSM (prs-eth/ResDepth
``lib/evaluation.py``) in plain NumPy, float64: the residuals of a DSM
against the ground truth where neither is nodata, over pixel classes (all
pixels; buildings, the building mask dilated twice by the 3x3 cross
against aliasing at walls; terrain, the rest less the building mask's
nodata; terrain without water), and for each class the largest and
smallest residual, the mean absolute residual (MAE), the RMSE, the median
absolute residual, the median residual and the NMAD: 1.4826 times the
median absolute deviation from the median absolute residual, where
ResDepth centres it.

``read_report`` reads the statistics file of the predict CLI back in the
report's format: a heading per class and DSM, one line per statistic."""

from __future__ import annotations

import re

import numpy as np

CLASSES = ("all", "building", "terrain", "terrain_nowater")
STATISTICS = ("diff_max", "diff_min", "MAE", "RMSE", "absolute_median", "median", "NMAD")
PHASES = {"INITIAL DSM": "before", "REFINED DSM": "after"}
TITLES = {"OVERALL": "all", "BUILDING PIXELS": "building", "TERRAIN PIXELS": "terrain",
          "TERRAIN PIXELS WITHOUT WATER": "terrain_nowater"}
LINES = {"Maximum residual error": "diff_max", "Minimum residual error": "diff_min",
         "Mean absolute residual error (MAE)": "MAE", "RMSE residual error": "RMSE",
         "Absolute median residual error": "absolute_median",
         "Median residual error": "median",
         "Normalized median absolute deviation (NMAD)": "NMAD"}
#: Half the step of the report's three decimals.
PRINTED_HALF_STEP = 5e-4


def dilate(mask: np.ndarray, iterations: int) -> np.ndarray:
    """Binary dilation by the 3x3 cross, ``iterations`` times."""
    mask = mask.copy()
    for _ in range(iterations):
        grown = mask.copy()
        grown[1:] |= mask[:-1]
        grown[:-1] |= mask[1:]
        grown[:, 1:] |= mask[:, :-1]
        grown[:, :-1] |= mask[:, 1:]
        mask = grown
    return mask


def class_masks(building: np.ndarray, water: np.ndarray, mask_nodata: int) -> dict:
    """Each class's pixels, from the building and water masks (1 marks the
    class, ``mask_nodata`` no data)."""
    is_building = building == 1
    terrain = ~dilate(is_building, 2) & (building != mask_nodata)
    return {"all": np.ones(building.shape, bool), "building": dilate(is_building, 2),
            "terrain": terrain, "terrain_nowater": terrain & ~(water == 1)}


def statistics(dsm: np.ndarray, gt: np.ndarray, nodata: float, classes: dict) -> dict:
    """``{class: {statistic: value}}`` of ``dsm`` against ``gt``."""
    dsm, gt = dsm.astype(np.float64), gt.astype(np.float64)
    valid = (gt != nodata) & (dsm != nodata)
    residual = dsm - gt
    out = {}
    for name in CLASSES:
        r = residual[valid & classes[name]]
        a = np.abs(r)
        medae = np.median(a)
        out[name] = {"diff_max": r.max(), "diff_min": r.min(), "MAE": a.mean(),
                     "RMSE": np.sqrt(np.mean(a ** 2)), "absolute_median": medae,
                     "median": np.median(r), "NMAD": 1.4826 * np.median(np.abs(r - medae))}
    return out


def read_report(path: str) -> list[tuple[str, str, dict]]:
    """``(class, phase, {statistic: printed value})`` of each heading of a
    statistics file, in its order; a heading of another class is skipped."""
    heading = re.compile(r"STATISTICS, (.+): (INITIAL DSM|REFINED DSM)")
    line = re.compile(r"^(.+?) \[m\]:\s*(\S+) m")
    out, current = [], None
    with open(path) as f:
        for text in f:
            found = heading.search(text)
            if found:
                current = None
                if found.group(1) in TITLES:
                    current = {}
                    out.append((TITLES[found.group(1)], PHASES[found.group(2)], current))
                continue
            found = line.search(text.strip())
            if current is not None and found and found.group(1) in LINES:
                current[LINES[found.group(1)]] = float(found.group(2))
    return out


def widest_gap(report: list, reference: dict, recorded: list | None = None) -> float:
    """The widest gap of a scene's statistics from the reference's
    (``{phase: {class: {statistic: value}}}``): of each value printed in
    the report, less the report's rounding, and of each value handed to the
    report at full precision (``recorded``, in the report's order). A class,
    phase or statistic missing from the report reads as infinite."""
    seen = {(c, p) for c, p, _ in report}
    if seen != {(c, p) for c in CLASSES for p in PHASES.values()}:
        return float("inf")
    if recorded is not None and len(recorded) != len(report):
        return float("inf")
    widest = 0.0
    for i, (name, phase, printed) in enumerate(report):
        want = reference[phase][name]
        for stat in STATISTICS:
            if stat not in printed:
                return float("inf")
            widest = max(widest, abs(printed[stat] - want[stat]) - PRINTED_HALF_STEP)
            if recorded is not None:
                widest = max(widest, abs(recorded[i][stat] - want[stat]))
    return widest
