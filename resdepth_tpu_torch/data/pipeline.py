"""Device-resident inference batch assembly: gather -> mask -> normalise.

Port of the inference subset of ``resdepth_tpu/data/pipeline.py``. The
scene rasters are copied to the device once (``device_put_dataset``); per
batch the host sends only (B, 2) tile positions and (B,) pair indices, and
``build_batch`` gathers the tiles, takes each tile's masked mean height,
normalises the DSM and gathers and normalises the ortho views on the
device.

The training branches of the JAX ``build_batch`` (ground-truth target and
loss mask, exclusive-bounds mask, in-pair view permutation, dihedral
augmentation) are not part of this slice and raise.
"""

from __future__ import annotations

import dataclasses

import torch

from resdepth_tpu.data.dataset import TileDataset

_TRAINING_ITEM = "ROADMAP.md section 1 item 8 (single-GPU training step)"


@dataclasses.dataclass
class DeviceRasters:
    """Scene rasters and pair table in device memory.

    Orthos are stored image-major, (n_images, rows, cols), as in the JAX
    package: one image's rows are contiguous, so a tile gather reads whole
    rows of one view.
    """
    dsm_input: torch.Tensor            # (rows, cols) f32
    dsm_target: torch.Tensor | None    # (rows, cols) f32 or None
    orthos: torch.Tensor | None        # (n_images, rows, cols) f32 or None
    pairs: torch.Tensor                # (P, V) int64
    nodata: float


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """Static preprocessing configuration (same fields as the JAX spec)."""
    input_channels: str
    tile_size: int
    dsm_std: float
    dsm_mean: float | None = None          # None => per-patch masked mean
    ortho_std: float = 1.0
    ortho_mean: float | None = None        # None => per-sample mean over views
    permute_images_within_pair: bool = False
    augment: bool = False
    strict_zero_mask: bool = True
    transform_dsm: bool = True
    transform_orthos: bool = True
    has_target: bool = True
    use_bounds: bool = False


def device_put_dataset(ds: TileDataset, device,
                       include_target: bool = False) -> DeviceRasters:
    """Copy a TileDataset's rasters to ``device``. Inference never reads the
    ground truth, so it stays on the host unless ``include_target``."""
    include_target = include_target and ds.dsm_target is not None
    return DeviceRasters(
        dsm_input=torch.as_tensor(ds.dsm_input).to(device),
        dsm_target=(torch.as_tensor(ds.dsm_target).to(device)
                    if include_target else None),
        orthos=(torch.from_numpy(ds.orthos.transpose(2, 0, 1).copy()).to(device)
                if ds.orthos is not None else None),
        pairs=torch.as_tensor(ds.pairs_array, dtype=torch.int64).to(device),
        nodata=float(ds.nodata),
    )


def batch_spec_for(ds: TileDataset, transform_dsm=True, transform_orthos=True,
                   augment=None) -> BatchSpec:
    return BatchSpec(
        input_channels=ds.input_channels,
        tile_size=ds.tile_size,
        dsm_std=ds.dsm_std if transform_dsm else 1.0,
        dsm_mean=ds.dsm_mean if transform_dsm else 0.0,
        ortho_std=ds.ortho_std if transform_orthos else 1.0,
        ortho_mean=ds.ortho_mean if transform_orthos else 0.0,
        permute_images_within_pair=ds.permute_images_within_pair,
        augment=ds.augment if augment is None else augment,
        strict_zero_mask=ds.strict_zero_mask,
        transform_dsm=transform_dsm,
        transform_orthos=transform_orthos,
        has_target=ds.dsm_target is not None,
        use_bounds=ds.valid_bounds is not None,
    )


def _tile_index(positions: torch.Tensor, tile: int):
    """(B, T) row and column indices of each tile."""
    offsets = torch.arange(tile, device=positions.device)
    return positions[:, 0, None] + offsets, positions[:, 1, None] + offsets


def _masked_patch_mean(patches: torch.Tensor, nodata: float) -> torch.Tensor:
    """(B,) masked mean height per patch (invalid = nodata)."""
    valid = (patches != nodata).to(torch.float32)
    count = torch.clamp(valid.sum(dim=(1, 2)), min=1.0)
    return (patches * valid).sum(dim=(1, 2)) / count


def build_batch(rasters: DeviceRasters, positions: torch.Tensor,
                pair_indices: torch.Tensor, spec: BatchSpec) -> dict:
    """Assemble one inference batch on the rasters' device.

    ``positions``: (B, 2) integer (y, x) tile origins; ``pair_indices``:
    (B,). Returns ``input`` (B, T, T, C) in the JAX package's NHWC layout
    (a view of a contiguous NCHW tensor, so ``apply_unet`` reads it without
    a copy) and ``dsm_mean`` (B,), the per-tile normalisation mean.
    """
    if spec.has_target or spec.use_bounds:
        raise NotImplementedError(
            f"build_batch with a target or loss bounds is training-only: {_TRAINING_ITEM}")
    if spec.augment or spec.permute_images_within_pair:
        raise NotImplementedError(
            f"augmentation and view permutation are training-only: {_TRAINING_ITEM}")
    tile = spec.tile_size
    positions = positions.long()
    rows, cols = _tile_index(positions, tile)
    dsm_in = rasters.dsm_input[rows[:, :, None], cols[:, None, :]]   # (B, T, T)

    if spec.transform_dsm:
        if spec.dsm_mean is None:
            dsm_mean = _masked_patch_mean(dsm_in, rasters.nodata)
        else:
            dsm_mean = torch.full((dsm_in.shape[0],), spec.dsm_mean,
                                  dtype=torch.float32, device=dsm_in.device)
        dsm_in = (dsm_in - dsm_mean[:, None, None]) / spec.dsm_std
    else:
        dsm_mean = torch.zeros(dsm_in.shape[0], dtype=torch.float32,
                               device=dsm_in.device)

    if spec.input_channels != "geom":
        view_ids = rasters.pairs[pair_indices.long()]                 # (B, V)
        orthos = rasters.orthos[view_ids[:, :, None, None],
                                rows[:, None, :, None],
                                cols[:, None, None, :]]               # (B, V, T, T)
        if spec.transform_orthos:
            if spec.ortho_mean is None:
                ortho_mean = orthos.mean(dim=(1, 2, 3), keepdim=True)
            else:
                ortho_mean = spec.ortho_mean
            orthos = (orthos - ortho_mean) / spec.ortho_std
        if spec.input_channels == "stereo":
            inputs = orthos
        else:
            inputs = torch.cat([dsm_in[:, None], orthos], dim=1)
    else:
        inputs = dsm_in[:, None]

    return {"input": inputs.permute(0, 2, 3, 1), "dsm_mean": dsm_mean}
