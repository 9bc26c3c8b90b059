"""Geographic data allocation: 5-stripe train/val/test splits.

Parity with the reference's lib/data_allocation.py:44-329, implemented
generically instead of the reference's 20 hand-unrolled cases:

  * the raster extent is cut into five stripes (vertical = north-south
    oriented, horizontal = west-east); stripes 0-3 have width
    ``round(0.2 * size)``, stripe 4 takes the remainder;
  * the test stripe is ``test_stripe``; the validation stripe sits cyclically
    to its east/south ((test_stripe + 1) % 5); remaining stripes are training,
    with geographically adjacent training stripes merged into single regions;
  * with ``crossval_training=True`` the chosen stripe is validation, the other
    four are training, and no test region is produced.

Outputs are ``{'x_extent': [(lo, hi), ...], 'y_extent': [(lo, hi), ...]}``
dicts of inclusive pixel bounds, identical to the reference's tables
(unit-tested over all 20 configurations).

The port's copy of ``resdepth_tpu/geo/allocation.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

from __future__ import annotations

from resdepth_tpu_torch.geo.raster import get_raster_extent

STRATEGIES = ["5-crossval_vertical", "5-crossval_horizontal"]


def _stripe_bounds(size: int):
    """Inclusive (start, end) bounds of the five stripes along one axis."""
    width = int(round(float(size) * 0.2))
    bounds = []
    start = 0
    for i in range(5):
        end = start + width - 1 if i < 4 else size - 1
        bounds.append((start, end))
        start = end + 1
    return bounds


def _merge_adjacent(stripe_indices, bounds):
    """Merge runs of consecutive stripe indices into single extents."""
    merged = []
    run_start = None
    prev = None
    for idx in stripe_indices:
        if run_start is None:
            run_start = prev = idx
            continue
        if idx == prev + 1:
            prev = idx
        else:
            merged.append((bounds[run_start][0], bounds[prev][1]))
            run_start = prev = idx
    if run_start is not None:
        merged.append((bounds[run_start][0], bounds[prev][1]))
    return merged


def allocate_data(fn_raster_in, allocation_strategy: str, test_stripe: int = 0,
                  crossval_training: bool = False):
    """Split a raster into train/val/test regions.

    Returns three area-definition dicts (train, val, test); ``test`` is empty
    when ``crossval_training`` is True.
    """
    if allocation_strategy not in STRATEGIES:
        raise ValueError(f"'{allocation_strategy}' is not a valid allocation strategy. "
                         f"Choose among: {STRATEGIES}.")
    if not isinstance(test_stripe, int) or not (0 <= test_stripe <= 4):
        raise ValueError("'test_stripe' must be an integer in the range [0,4].")
    if not isinstance(crossval_training, bool):
        raise ValueError("'crossval_training' must be boolean.")

    extent = get_raster_extent(fn_raster_in)
    cols, rows = extent["cols"], extent["rows"]

    vertical = allocation_strategy == "5-crossval_vertical"
    along = _stripe_bounds(cols if vertical else rows)
    full_other = (0, (rows if vertical else cols) - 1)

    if crossval_training:
        val_stripe = test_stripe
        test_stripe_idx = None
    else:
        val_stripe = (test_stripe + 1) % 5
        test_stripe_idx = test_stripe

    train_indices = [i for i in range(5) if i != val_stripe and i != test_stripe_idx]
    train_extents = _merge_adjacent(train_indices, along)

    def region(extents_along):
        if vertical:
            return {"x_extent": list(extents_along),
                    "y_extent": [full_other] * len(extents_along)}
        return {"x_extent": [full_other] * len(extents_along),
                "y_extent": list(extents_along)}

    train = region(train_extents)
    val = region([along[val_stripe]])
    test = {} if crossval_training else region([along[test_stripe_idx]])
    return train, val, test


def entire_area_defn(fn_raster_in):
    """Area definition covering the whole raster ('entire' strategy,
    reference: lib/utils.py:91-94)."""
    extent = get_raster_extent(fn_raster_in)
    return {"x_extent": [(0, extent["cols"] - 1)],
            "y_extent": [(0, extent["rows"] - 1)]}
