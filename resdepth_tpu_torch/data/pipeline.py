"""Device-resident batch assembly: gather -> mask -> normalise -> augment.

Port of ``resdepth_tpu/data/pipeline.py``. The scene rasters are copied to
the device once (``device_put_dataset``); per batch the host sends only
(B, 2) tile positions, (B,) pair indices and, for training, (B, 4) loss
bounds, and ``build_batch`` does the rest on the device: tile gather, loss
mask from the raw ground truth (nodata, the reference's ``!= 0`` quirk, the
inclusive exclusive-area bounds), per-tile masked-mean normalisation of the
DSM and the target, ortho views (optionally permuted within the pair), and
a uniform dihedral augmentation applied alike to mask, target and input.
The random draws come from a draw source (``GeneratorDraws``: a
``torch.Generator`` on the rasters' device, unless the caller hands
another source with the same calls).

``BatchIndexIterator`` is the JAX module's host-side epoch iterator, ported
verbatim (it is numpy; the JAX module imports jax).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from resdepth_tpu_torch.data.dataset import TileDataset


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
    ground truth, so it stays on the host unless ``include_target`` (the
    training and validation batches need it)."""
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


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """``array`` on ``device``. To CUDA through pinned memory, without
    waiting: the copy queues behind the work already on the stream, and the
    host goes on."""
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type == "cuda":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor.to(device)


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


def _bounds_mask(bounds: torch.Tensor, tile: int) -> torch.Tensor:
    """(B, T, T) bool: True inside each sample's inclusive (uly, ulx, lry,
    lrx) box."""
    offsets = torch.arange(tile, device=bounds.device)
    rows = offsets[None, :, None]
    cols = offsets[None, None, :]
    b = bounds.long()[:, :, None, None]
    return ((rows >= b[:, 0]) & (rows <= b[:, 2])
            & (cols >= b[:, 1]) & (cols <= b[:, 3]))


class GeneratorDraws:
    """The default draw source: a ``torch.Generator`` on the rasters'
    device.

    A draw source makes the two random draws of a training batch:
    ``view_permutations`` (the ortho views' order, drawn first) and
    ``dihedral_bits`` (the augmentation). ``at_step(step)`` gives the
    source for the train step of that index; this one draws on from the
    generator whatever the step. Another source (for example one that
    replays another package's draws) needs only these three calls."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def at_step(self, step: int) -> "GeneratorDraws":
        return self

    def view_permutations(self, batch: int, n_views: int, device) -> torch.Tensor:
        """(B, V) int64: a uniform random permutation of the views a sample."""
        keys = torch.rand((batch, n_views), generator=self.generator, device=device)
        return torch.argsort(keys, dim=1)

    def dihedral_bits(self, batch: int, device) -> torch.Tensor:
        """(3, B) bool: transpose, flip rows, flip columns, fair and
        independent."""
        return torch.rand((3, batch), generator=self.generator, device=device) < 0.5


def _augment(stacked: torch.Tensor, draws) -> torch.Tensor:
    """Uniform random dihedral transform per sample of ``stacked`` (B, C,
    T, T), the same for every channel.

    Three independent fair bits, applied in this order: transpose, flip
    rows, flip columns. Together they hit each of the square's 8 symmetries
    with probability 1/8, the distribution of the reference's rot90^k with
    independent flips (``resdepth_tpu/data/pipeline.py::_augment``)."""
    bits = draws.dihedral_bits(stacked.shape[0], stacked.device)
    transpose, flip_rows, flip_cols = (b[:, None, None, None] for b in bits)
    stacked = torch.where(transpose, stacked.transpose(2, 3), stacked)
    stacked = torch.where(flip_rows, stacked.flip(2), stacked)
    return torch.where(flip_cols, stacked.flip(3), stacked)


def build_batch(rasters: DeviceRasters, positions: torch.Tensor,
                pair_indices: torch.Tensor, spec: BatchSpec, *, bounds=None,
                draws: GeneratorDraws | None = None) -> dict:
    """Assemble one batch on the rasters' device.

    ``positions``: (B, 2) integer (y, x) tile origins; ``pair_indices``:
    (B,); ``bounds``: (B, 4) inclusive loss boxes, read when
    ``spec.use_bounds``; ``draws``: a draw source (``GeneratorDraws`` over
    a ``torch.Generator`` on the rasters' device), needed for
    ``spec.augment`` and ``spec.permute_images_within_pair``; the view
    permutations are drawn before the dihedral bits.

    Returns ``input`` (B, T, T, C) in the JAX package's NHWC layout (a view
    of a contiguous NCHW tensor, so ``apply_unet`` reads it without a copy)
    and ``dsm_mean`` (B,), the per-tile normalisation mean; with
    ``spec.has_target`` also ``target`` and ``loss_mask`` (B, T, T, 1),
    the target normalised by the same mean and the mask in float32.
    """
    if (spec.augment or spec.permute_images_within_pair) and draws is None:
        raise ValueError("augmentation and view permutation need a draw source: "
                         "pass draws=GeneratorDraws(generator)")
    tile = spec.tile_size
    device = rasters.dsm_input.device
    positions = positions.long()
    rows, cols = _tile_index(positions, tile)
    dsm_in = rasters.dsm_input[rows[:, :, None], cols[:, None, :]]   # (B, T, T)

    if spec.has_target:
        target = rasters.dsm_target[rows[:, :, None], cols[:, None, :]]
        # Loss mask from the RAW ground truth, before normalisation.
        mask = target != rasters.nodata
        if spec.strict_zero_mask:
            mask = mask & (target != 0)
        if spec.use_bounds:
            mask = mask & _bounds_mask(bounds.to(device), tile)

    if spec.transform_dsm:
        if spec.dsm_mean is None:
            dsm_mean = _masked_patch_mean(dsm_in, rasters.nodata)
        else:
            dsm_mean = torch.full((dsm_in.shape[0],), spec.dsm_mean,
                                  dtype=torch.float32, device=device)
        dsm_in = (dsm_in - dsm_mean[:, None, None]) / spec.dsm_std
        if spec.has_target:
            target = (target - dsm_mean[:, None, None]) / spec.dsm_std
    else:
        dsm_mean = torch.zeros(dsm_in.shape[0], dtype=torch.float32,
                               device=device)

    if spec.input_channels != "geom":
        view_ids = rasters.pairs[pair_indices.long()]                 # (B, V)
        if spec.permute_images_within_pair:
            perm = draws.view_permutations(*view_ids.shape, device)
            view_ids = torch.gather(view_ids, 1, perm)
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

    if not spec.has_target:
        if spec.augment:
            inputs = _augment(inputs, draws)
        return {"input": inputs.permute(0, 2, 3, 1), "dsm_mean": dsm_mean}

    stacked = torch.cat([mask[:, None].to(torch.float32), target[:, None],
                         inputs], dim=1)
    if spec.augment:
        stacked = _augment(stacked, draws)
    nhwc = stacked.permute(0, 2, 3, 1)
    return {"input": nhwc[..., 2:], "target": nhwc[..., 1:2],
            "loss_mask": nhwc[..., 0:1], "dsm_mean": dsm_mean}


class BatchIndexIterator:
    """Host-side epoch iterator over sample indices with static batch shapes.

    Yields ``(positions, pair_indices, bounds, weights)`` numpy arrays of a
    fixed emitted batch size: the final partial batch (and, when
    ``emit_size > batch_size``, every batch) is padded with wrap-around
    samples at weight 0, which add nothing to the loss, the gradients, the
    metrics or the training-mode BatchNorm statistics. Port of the JAX
    package's iterator, draw for draw: the same seed gives the same arrays.
    """

    def __init__(self, ds: TileDataset, batch_size: int, shuffle: bool,
                 seed: int = 0, drop_last: bool = False,
                 emit_size: int | None = None):
        self.ds = ds
        self.batch_size = batch_size
        self.emit_size = batch_size if emit_size is None else int(emit_size)
        if self.emit_size < batch_size:
            raise ValueError(f"emit_size {self.emit_size} < batch_size {batch_size}")
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.ds)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.ds)
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        bs = self.batch_size
        emit = self.emit_size
        bounds_all = self.ds.valid_bounds
        for start in range(0, n, bs):
            idx = order[start:start + bs]
            if len(idx) < bs and self.drop_last:
                return
            if len(idx) < emit:
                n_pad = emit - len(idx)
                # wrap-around padding at weight 0 (its values are irrelevant)
                pad = np.resize(order[:max(start, 1)] if start else idx, n_pad)
                weights = np.concatenate([np.ones(len(idx), np.float32),
                                          np.zeros(n_pad, np.float32)])
                idx = np.concatenate([idx, pad])
            else:
                weights = np.ones(emit, np.float32)
            positions = self.ds.positions[idx]
            pair_indices = self.ds.pair_indices[idx]
            bounds = (bounds_all[idx] if bounds_all is not None
                      else np.zeros((emit, 4), np.int32))
            yield positions, pair_indices, bounds, weights
