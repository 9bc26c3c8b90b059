"""What the drivers share: the configuration's input planes, the K3 call
as its bound needs it, and the program's ``TileDataset`` over rasters the
benchmark made in memory."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.inputs import city


def n_input_channels(model: dict) -> int:
    return {"geom": 1, "geom-stereo": 3}[model["input_channels"]]


def k3_entry(x, kernel, *args, passes=None, **kwargs):
    """A K3 call as its bound needs it: x's shape, Cout, bf16 passes and
    x's element size (``ops/conv.py::pass_count``: float32 defaults to 3,
    bfloat16 runs 1)."""
    n_passes = 1 if x.dtype == torch.bfloat16 else (passes or 3)
    return (tuple(x.shape), kernel.shape[3], n_passes, x.element_size())


def memory_dataset(dsm: np.ndarray, gt: np.ndarray | None, orthos: np.ndarray | None,
                   **kwargs):
    """The program's ``TileDataset`` (its grid or its draw of tile origins,
    pair table and normalisation; ``kwargs`` are its own) over host rasters
    already in memory, without reading GeoTIFFs: the files are the CLI
    cell's layer, not the serving or training cells'."""
    from resdepth_tpu_torch.data.dataset import TileDataset

    class MemoryDataset(TileDataset):
        def _load_and_verify(self, dataset):
            self.dsm_input, self.dsm_target, self.orthos = dsm, gt, orthos
            self.raster_in = self.raster_gt = None
            self.nodata = np.float32(city.NODATA)
            self.gsd = city.GSD
            if orthos is None:
                self.image_pairs, self.image_list = [()], []
            else:
                self.image_pairs = [(0, 1)]
                self.image_list = ["ortho_0", "ortho_1"]
                self._verify_pairs()

    rows, cols = dsm.shape
    area = {"x_extent": [(0, cols - 1)], "y_extent": [(0, rows - 1)]}
    channels = "geom" if orthos is None else "geom-stereo"
    return MemoryDataset({"name": "city", "area_defn": area,
                          "n_samples": kwargs.pop("n_samples", None)},
                         input_channels=channels, **kwargs)
