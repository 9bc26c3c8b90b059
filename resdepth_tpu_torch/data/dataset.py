"""Tile dataset: in-RAM rasters + patch sampling strategies.

Array-oriented redesign of the reference's ``DsmOrthoDataset``
(the reference's lib/DsmOrthoDataset.py:14-674). The reference is a torch
map-style Dataset whose ``__getitem__`` slices, masks, normalises and
augments one patch at a time in Python worker processes. The TPU design
splits this differently:

  * this class owns the HOST side: raster loading (all rasters to float32
    RAM, as the reference does — README.md:268), input validation
    (co-registration, resolutions, pair arity), and *patch-index* generation
    for the three sampling strategies (train/val/test);
  * all per-pixel work (patch gather, nodata masking, normalisation, in-pair
    permutation, rot90/flip augmentation) happens ON DEVICE inside the jitted
    preprocessing stage (``data.pipeline``) — the host ships only (y, x)
    positions and pair indices per batch, a few bytes per sample instead of
    megabytes.

Sampling strategy parity (lib/DsmOrthoDataset.py:316-431):
  * 'train': uniform sample WITHOUT replacement of ``n_samples`` tile origins
    from all valid in-region positions; for 'geom-stereo' with multiple
    pairs, either the full position x pair cross-product
    (``use_all_stereo_pairs``) or one random pair per patch;
  * 'val': regular non-overlapping grid (stride = tile), each position
    combined with EVERY image pair for image-guided modes;
  * 'test': regular overlapping grid (stride = tile/2 by default), single
    image pair.

Loss-mask quirk preserved (lib/DsmOrthoDataset.py:462, SURVEY.md quirk
register): ground-truth pixels exactly equal to 0.0 are treated as invalid in
the loss mask (``valid != 0``), in addition to nodata; toggled by
``strict_zero_mask``.

The port's copy of ``resdepth_tpu/data/dataset.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""

from __future__ import annotations

import numpy as np

from resdepth_tpu_torch.geo import grid as grid_mod
from resdepth_tpu_torch.geo import raster as raster_mod

SAMPLING_STRATEGIES = ("train", "val", "test")
INPUT_CHANNEL_MODES = ("geom-multiview", "geom-stereo", "geom-mono", "stereo", "geom")


class TileDataset:
    def __init__(self, dataset, input_channels, tile_size, sampling_strategy,
                 stride=None, dsm_mean=None, dsm_std=1.0, ortho_mean=None,
                 ortho_std=1.0, use_all_stereo_pairs=False,
                 permute_images_within_pair=False, augment=False, seed=0,
                 strict_zero_mask=True):
        if input_channels not in INPUT_CHANNEL_MODES:
            raise ValueError(f"Unknown input channel configuration: {input_channels!r}. "
                             f"Choose among {INPUT_CHANNEL_MODES}.")
        if sampling_strategy not in SAMPLING_STRATEGIES:
            raise ValueError(f"Unknown sampling strategy: {sampling_strategy!r}. "
                             f"Choose among {SAMPLING_STRATEGIES}.")

        self.input_channels = input_channels
        self.tile_size = int(tile_size)
        self.sampling_strategy = sampling_strategy
        if stride is None:
            stride = self.tile_size // 2 if sampling_strategy == "test" else self.tile_size
        self.stride = int(stride)
        self.augment = bool(augment)
        self.use_all_stereo_pairs = bool(use_all_stereo_pairs)
        self.permute_images_within_pair = bool(permute_images_within_pair)
        self.strict_zero_mask = bool(strict_zero_mask)
        self.rng = np.random.default_rng(seed)

        self.name = dataset.get("name")
        self.area_defn = dataset["area_defn"]
        self.n_samples = dataset.get("n_samples")

        # Normalization parameters: mean None => per-patch centring on device.
        self.dsm_mean = None if dsm_mean is None else float(dsm_mean)
        self.dsm_std = float(dsm_std)
        self.ortho_mean = None if ortho_mean is None else float(ortho_mean)
        self.ortho_std = 1.0 if ortho_std is None else float(ortho_std)

        self._load_and_verify(dataset)
        self._determine_patches()

    # ------------------------------- loading ------------------------------ #

    @staticmethod
    def _nodata_of(raster, path) -> np.float32:
        """The DSM nodata value drives every validity mask; a GeoTIFF without
        a NODATA tag must fail with a clear message (the reference crashes in
        np.array(None).astype on this case, lib/DsmOrthoDataset.py:303-305)."""
        if raster.nodata is None:
            raise ValueError(f"Raster {path!r} carries no NODATA tag; the DSM "
                             "nodata value is required to mask invalid pixels.")
        return np.float32(raster.nodata)

    def _load_and_verify(self, dataset):
        self.raster_in = raster_mod.open_raster(dataset["raster_in"])
        self.dsm_input = self.raster_in.band(1).astype(np.float32)

        if dataset.get("raster_gt") is not None:
            self.raster_gt = raster_mod.open_raster(dataset["raster_gt"])
            self.dsm_target = self.raster_gt.band(1).astype(np.float32)
            self.nodata = self._nodata_of(self.raster_gt, dataset["raster_gt"])
            if self.raster_gt.data.shape[:2] != self.dsm_input.shape:
                raise ValueError("Initial DSM and ground truth DSM have different "
                                 "spatial dimensions.")
            if self.raster_gt.geotransform[1] != self.raster_in.geotransform[1] or \
                    self.raster_gt.geotransform[5] != self.raster_in.geotransform[5]:
                raise ValueError("Initial DSM and ground truth DSM have different "
                                 "spatial resolutions.")
        elif self.sampling_strategy in ("train", "val"):
            raise ValueError("Missing 'raster_gt': required for training/validation.")
        else:
            self.raster_gt = None
            self.dsm_target = None
            self.nodata = self._nodata_of(self.raster_in, dataset["raster_in"])
        self.gsd = self.raster_in.geotransform[1]

        rows, cols = self.dsm_input.shape
        for x_ext, y_ext in zip(self.area_defn["x_extent"], self.area_defn["y_extent"]):
            if x_ext[0] < 0 or x_ext[1] >= cols:
                raise ValueError(f"'x_extent' {x_ext} outside raster [0, {cols - 1}].")
            if y_ext[0] < 0 or y_ext[1] >= rows:
                raise ValueError(f"'y_extent' {y_ext} outside raster [0, {rows - 1}].")

        if self.input_channels != "geom":
            image_list = dataset["image_list"]
            self.image_pairs = [tuple(p) for p in dataset["image_pairs"]]
            self._verify_pairs()
            self.orthos = np.zeros((rows, cols, len(image_list)), dtype=np.float32)
            for j, img_path in enumerate(image_list):
                img = raster_mod.open_raster(img_path)
                if img.geotransform[1] != self.gsd:
                    raise ValueError("DSMs and ortho-images must share one spatial "
                                     "resolution.")
                self.orthos[..., j] = img.band(1).astype(np.float32)
            self.image_list = image_list
        else:
            self.orthos = None
            self.image_pairs = [()]
            self.image_list = []

        if self.sampling_strategy == "train" and not self.n_samples:
            raise ValueError("Missing 'n_samples': required for training datasets.")

    def _verify_pairs(self):
        arities = {len(p) for p in self.image_pairs}
        if len(arities) > 1:
            raise ValueError("All image pairs must have the same number of images.")
        arity = arities.pop()
        if self.input_channels in ("stereo", "geom-stereo") and arity != 2:
            raise ValueError(f"'{self.input_channels}' requires image pairs of 2 images.")
        if self.input_channels == "geom-mono" and arity != 1:
            raise ValueError("'geom-mono' requires single-image pairs.")
        if self.input_channels == "geom-multiview" and arity < 2:
            raise ValueError("'geom-multiview' requires pairs of n >= 2 images.")
        if self.sampling_strategy == "test" and len(self.image_pairs) > 1:
            raise ValueError("Testing refines the scene with a single image pair; "
                             "pass one pair per run.")

    # ------------------------------ sampling ------------------------------ #

    def _determine_patches(self):
        n_pairs = len(self.image_pairs)

        # Clear errors instead of raw sampling/gather failures downstream.
        for (y0, y1), (x0, x1) in zip(self.area_defn["y_extent"],
                                      self.area_defn["x_extent"]):
            region = (y1 - y0 + 1, x1 - x0 + 1)
            if self.sampling_strategy == "train":
                # Training samples tiles fully INSIDE the region; none exist
                # (the reference crashes in np.linspace here,
                # lib/data_allocation.py:367-373).
                if self.tile_size > min(region):
                    raise ValueError(
                        f"tile_size {self.tile_size} exceeds a training "
                        f"region of {region[0]}x{region[1]} px (area_defn "
                        f"{self.area_defn}); no valid patch positions exist. "
                        "Reduce training_settings.tile_size.")
            # Val/test grids clamp edge tiles inward so their trailing edge
            # lands on the region border (lib/rasterutils.py:161-177) — a
            # region narrower than the tile is fine as long as the clamped
            # origin (trailing_edge - tile + 1) stays inside the raster.
            elif self.tile_size > min(y1 + 1, x1 + 1):
                raise ValueError(
                    f"tile_size {self.tile_size} cannot fit between the "
                    f"raster origin and the region's trailing edge "
                    f"(y1={y1}, x1={x1}; area_defn {self.area_defn}). "
                    "Reduce tile_size (inference: general.tile_size).")

        if self.sampling_strategy == "train":
            valid = grid_mod.indices_from_area_defn(self.area_defn, self.tile_size)
            if self.n_samples > len(valid):
                raise ValueError(f"n_samples={self.n_samples} exceeds the "
                                 f"{len(valid)} valid patch positions.")
            chosen = self.rng.choice(len(valid), self.n_samples, replace=False)
            sampled = grid_mod.positions_as_array(valid)[chosen]

            cross_product = (self.input_channels == "geom-stereo" and n_pairs > 1
                             and self.use_all_stereo_pairs)
            if cross_product:
                self.positions = np.repeat(sampled, n_pairs, axis=0)
                self.pair_indices = np.tile(np.arange(n_pairs, dtype=np.int32),
                                            self.n_samples)
            elif self.input_channels == "geom-stereo" and n_pairs > 1:
                self.positions = sampled
                self.pair_indices = self.rng.integers(
                    0, n_pairs, self.n_samples, dtype=np.int32)
            else:
                self.positions = sampled
                self.pair_indices = np.zeros(self.n_samples, np.int32)
            self.valid_bounds = None

        else:
            positions, borders = grid_mod.create_regular_grid(
                self.area_defn, tile_size=self.tile_size, stride=self.stride)
            positions = grid_mod.positions_as_array(positions)
            borders = np.asarray(borders, np.int32).reshape(-1, 4)

            if self.sampling_strategy == "val" and self.input_channels != "geom":
                # Evaluate every position with every image pair.
                self.positions = np.tile(positions, (n_pairs, 1))
                self.valid_bounds = np.tile(borders, (n_pairs, 1))
                self.pair_indices = np.repeat(np.arange(n_pairs, dtype=np.int32),
                                              len(positions))
            else:
                self.positions = positions
                self.valid_bounds = borders
                self.pair_indices = np.zeros(len(positions), np.int32)

        self.positions = self.positions.astype(np.int32)

    def __len__(self) -> int:
        return len(self.positions)

    @property
    def pairs_array(self) -> np.ndarray:
        """(P, V) int32 image-pair index table (empty (1, 0) for 'geom')."""
        if self.input_channels == "geom":
            return np.zeros((1, 0), np.int32)
        return np.asarray(self.image_pairs, np.int32).reshape(len(self.image_pairs), -1)

    @property
    def n_views(self) -> int:
        return self.pairs_array.shape[1]

    # --------------------------- host patch access ------------------------ #

    def gather_input_patches(self, indices=None) -> np.ndarray:
        """(N, T, T) initial-DSM patches on the host (sigma pass, tests)."""
        if indices is None:
            indices = range(len(self))
        t = self.tile_size
        return np.stack([
            self.dsm_input[self.positions[i, 0]:self.positions[i, 0] + t,
                           self.positions[i, 1]:self.positions[i, 1] + t]
            for i in indices])

    def loss_mask_host(self, index: int) -> np.ndarray:
        """Host-side loss mask for one sample (test oracle for the device path)."""
        t = self.tile_size
        y, x = self.positions[index]
        target = self.dsm_target[y:y + t, x:x + t]
        if self.strict_zero_mask:
            valid = target != 0
        else:
            valid = np.ones_like(target, bool)
        if self.valid_bounds is not None:
            uly, ulx, lry, lrx = self.valid_bounds[index]
            inside = np.zeros_like(valid)
            inside[uly:lry + 1, ulx:lrx + 1] = True
            valid = valid & inside
        return valid & (target != self.nodata)
