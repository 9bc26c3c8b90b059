"""The port's copy of ``resdepth_tpu/geo/__init__.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""
from resdepth_tpu_torch.geo.raster import (
    Raster, dilate_mask, get_raster_extent, load_mask_raster, open_raster,
    write_raster,
)
from resdepth_tpu_torch.geo.grid import create_regular_grid, indices_from_area_defn
from resdepth_tpu_torch.geo.allocation import allocate_data
