"""Full-scene tiled inference with on-device linear-blend stitching.

Port of the device-resident path of ``resdepth_tpu/infer/tiled.py``. The
scene rasters and one f32 canvas live on the device; a Python loop over tile
batches takes the place of the JAX ``lax.scan``. Each step gathers and
normalises a batch of tiles (``data.pipeline.build_batch``), runs the UNet
in eval mode, and stitches the batch into the canvas in place
(``ops.stitch``: denormalisation, separable blend weights and overlap-add
in one kernel). CUDA work is asynchronous, so the loop only enqueues; the
canvas comes back to the host once.

Blend semantics are the reference's (``resdepth_tpu/ops/blend.py``):
partition of unity over the region, weight 1 in each tile's exclusive area
and linear ramps over the overlap bands.

``compute_dtype`` is a torch dtype (float32 or bfloat16) or one of the
string serving modes (``models.unet.SERVING_PRECISION_MODES``), which keep
f32 weights and run the UNet on the f32 batch at the mode's precisions.

Not in this slice: the row-band streaming and scene-sharded paths
(``predict_linear_blend_streaming``, ``predict_linear_blend_scene_sharded``,
ROADMAP.md section 1 item 7).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from resdepth_tpu_torch.data.dataset import TileDataset
from resdepth_tpu_torch.data.pipeline import (BatchSpec, DeviceRasters,
                                              batch_spec_for, build_batch,
                                              device_put_dataset)
from resdepth_tpu_torch.models.unet import (SERVING_PRECISION_MODES, UNet,
                                            apply_unet, fold_serving,
                                            serving_precision)
from resdepth_tpu_torch.ops import blend, stitch

# Dihedral-group subsets for test-time augmentation (general.tta). Element
# g is rot90 by (g % 4) quarter turns, after a horizontal flip when g >= 4.
# Each count is a subgroup of D4: 2 -> {identity, flip}; 4 -> rotations;
# 8 -> D4.
TTA_SUBGROUPS = {1: (0,), 2: (0, 4), 4: (0, 1, 2, 3), 8: tuple(range(8))}

# How the tta predictions of one tile are merged (general.tta_merge).
TTA_MERGES = ("mean", "median")


def _dihedral_apply(x: torch.Tensor, g: int) -> torch.Tensor:
    """Apply dihedral element ``g`` to the spatial dims (1, 2) of a batched
    square tile tensor, (B, H, W) or (B, H, W, C)."""
    if g >= 4:
        x = torch.flip(x, dims=(2,))
    return torch.rot90(x, k=g % 4, dims=(1, 2))


def _dihedral_invert(y: torch.Tensor, g: int) -> torch.Tensor:
    """Inverse of :func:`_dihedral_apply`: (rot_k ∘ flip)⁻¹ = flip ∘ rot_-k."""
    y = torch.rot90(y, k=-(g % 4), dims=(1, 2))
    if g >= 4:
        y = torch.flip(y, dims=(2,))
    return y


def _median(stack: torch.Tensor) -> torch.Tensor:
    """Median over dim 0 that averages the two middle values of an even
    count, as ``jnp.median`` does (``torch.median`` returns the lower)."""
    ordered = torch.sort(stack, dim=0).values
    n = stack.shape[0]
    if n % 2:
        return ordered[n // 2]
    return (ordered[n // 2 - 1] + ordered[n // 2]) / 2


def _pad_round_up(array, n, pad_value=0):
    pad = n - array.shape[0]
    if pad == 0:
        return array
    pad_block = np.full((pad,) + array.shape[1:], pad_value, array.dtype)
    return np.concatenate([array, pad_block], axis=0)


def _pad_positions(positions, n, batch_size):
    """Pad (n_tiles, 2) tile origins to ``n`` rows, a multiple of
    ``batch_size``, with the origins of the last batch's real tiles in
    turn.

    The padding tiles carry zero blend weights. The canvas starts at +0.0
    and never holds -0.0 (+0 + -0 = +0), so adding a zero-weight tile
    anywhere leaves it bitwise unchanged for finite predictions: where the
    padding sits does not change the scene. On the last batch's real tiles
    it keeps that batch's box (``stitch.batch_bounds``), and so K2's
    launch, to the real tiles; taken in turn, no tile gets more than
    ceil(pad / real) of them, so no canvas block's list of covering tiles
    in K2 grows by more than that. The JAX package pads at (0, 0)
    (``resdepth_tpu/infer/tiled.py::_predict_tiles``), which stretches that
    box to the canvas's origin.
    """
    pad = n - len(positions)
    if pad == 0:
        return positions
    last = positions[len(positions) // batch_size * batch_size:]
    return np.concatenate([positions, np.resize(last, (pad, 2))])


def _storage(compute_dtype) -> tuple:
    """``compute_dtype`` as ``(dtype of the weights and input, apply_unet
    keyword arguments)``: a serving mode keeps float32 and runs at its
    precisions (``serving_precision``)."""
    if isinstance(compute_dtype, str):
        if compute_dtype not in SERVING_PRECISION_MODES:
            raise ValueError(f"unknown serving mode {compute_dtype!r}: one of "
                             f"{SERVING_PRECISION_MODES} or a torch dtype")
        return torch.float32, serving_precision(compute_dtype).apply_kwargs()
    return compute_dtype, {}


def _inference_spec(ds: TileDataset) -> BatchSpec:
    """Prediction needs no loss mask or target gather: strip them (the
    stitch uses blend weights, not exclusive bounds)."""
    spec = batch_spec_for(ds, transform_dsm=True,
                          transform_orthos=ds.input_channels != "geom",
                          augment=False)
    return dataclasses.replace(spec, use_bounds=False, has_target=False)


def _predict_tiles(model: UNet, rasters: DeviceRasters, positions, pair_idx,
                   wy, wx, shape, spec: BatchSpec, dsm_std, batch_size,
                   compute_dtype, use_pallas, tta=1, tta_merge="mean"):
    """Run the batch loop over one set of tiles into a (rows, cols) canvas.

    Returns the device canvas; on CUDA the work is still queued when this
    returns, so the caller can overlap the fetch with other work."""
    if tta not in TTA_SUBGROUPS:
        raise ValueError(f"tta must be one of {sorted(TTA_SUBGROUPS)}, "
                         f"got {tta!r}")
    if tta_merge not in TTA_MERGES:
        raise ValueError(f"tta_merge must be one of {TTA_MERGES}, "
                         f"got {tta_merge!r}")
    device = rasters.dsm_input.device
    stitch.validate_use_pallas(use_pallas, device)
    tile = spec.tile_size
    stitch.check_positions(positions, tile, shape)
    n = len(positions)
    # One device: cap the batch at the tile count (zero-weight padding is
    # correct but wasted forward compute).
    batch_size = max(1, min(batch_size, n))
    n_padded = -(-n // batch_size) * batch_size
    positions = _pad_positions(positions, n_padded, batch_size)
    pair_idx = _pad_round_up(pair_idx, n_padded)
    wy = _pad_round_up(wy, n_padded, 0.0)   # zero weights: padding adds nothing
    wx = _pad_round_up(wx, n_padded, 0.0)

    pos_d = torch.from_numpy(positions.astype(np.int32)).to(device)
    pair_d = torch.from_numpy(pair_idx.astype(np.int64)).to(device)
    wy_d = torch.from_numpy(wy).to(device)
    wx_d = torch.from_numpy(wx).to(device)

    dtype, kwargs = _storage(compute_dtype)

    def run_model(x):
        return apply_unet(model, x.to(dtype), **kwargs)[..., 0].to(torch.float32)

    canvas = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    with torch.inference_mode():
        for start in range(0, n_padded, batch_size):
            sl = slice(start, start + batch_size)
            batch = build_batch(rasters, pos_d[sl], pair_d[sl], spec)
            if tta == 1:
                pred = run_model(batch["input"])
            elif tta_merge == "median":
                # The per-tile denormalisation is a monotone affine map
                # shared by a tile's replicas, so the median commutes with it.
                pred = _median(torch.stack([
                    _dihedral_invert(run_model(_dihedral_apply(batch["input"], g)), g)
                    for g in TTA_SUBGROUPS[tta]]))
            else:
                # Averaging normalised predictions equals averaging the
                # denormalised ones (the stitch's denormalisation is affine).
                acc = 0.0
                for g in TTA_SUBGROUPS[tta]:
                    acc = acc + _dihedral_invert(
                        run_model(_dihedral_apply(batch["input"], g)), g)
                pred = acc / tta
            stitch.stitch_tiles(canvas, pred.contiguous(), pos_d[sl], wy_d[sl],
                                wx_d[sl], batch["dsm_mean"], dsm_std,
                                use_pallas=use_pallas,
                                bounds=stitch.batch_bounds(positions[sl], tile))
    return canvas


def serving_model(model: UNet, device,
                  compute_dtype: torch.dtype | str = torch.float32) -> UNet:
    """A new module for the scene loop: ``fold_serving`` applied (BatchNorm
    folded into the convs, top upconv composed into the final conv), on
    ``device`` in ``compute_dtype`` (float32 for a serving mode). ``model``
    is left as it is."""
    served = fold_serving(model)
    if served is model:   # nothing to fold: still hand back a new module
        served = copy.deepcopy(model)
    return served.to(device=device, dtype=_storage(compute_dtype)[0])


def predict_linear_blend(model: UNet, ds: TileDataset, *, device,
                         batch_size: int = 64,
                         compute_dtype: torch.dtype | str = torch.float32,
                         rasters: DeviceRasters | None = None,
                         use_pallas: bool | str | None = None,
                         fold_bn: bool = True, as_numpy: bool = True,
                         tta: int = 1, tta_merge: str = "mean"):
    """Refine a whole scene; returns the blended refined DSM (rows, cols).

    ``ds`` is a 'test'-strategy TileDataset (overlapping grid); pixels
    outside the covered region stay 0. ``fold_bn`` runs ``serving_model``
    on ``model`` first. With ``fold_bn=False`` the model runs as given and
    must already be on ``device`` in ``compute_dtype`` (a module from
    ``serving_model`` can so serve many calls).

    ``use_pallas``: on CUDA, None or True = stitch kernel K1, "fused" = K2,
    False raises (the plain stitch is the CPU reference only); on the CPU
    the plain stitch runs whatever the value.

    ``compute_dtype``: torch.float32 (parity path; the caller turns TF32
    off), torch.bfloat16 (the whole network in bf16, the outer skip
    included, as the JAX ``bfloat16`` mode) or a string serving mode
    (``mixed``, ``fast32``, ``act2pass``, ``balanced``, ``balanced16``: f32
    weights, the UNet at the mode's bf16 passes, its 3x3 convs with a pass
    count on kernel K3; the caller turns TF32 off). The stitch and canvas
    are f32.

    ``as_numpy``: True returns a host numpy array (waits for the device).
    False returns the device canvas as soon as the work is queued; fetch it
    with ``.cpu().numpy()`` (``np.asarray`` raises on a CUDA tensor).

    ``tta`` in {1, 2, 4, 8}: predict each tile under that dihedral subgroup
    and merge the inverse-transformed predictions by ``tta_merge``
    ("mean" or "median").
    """
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if fold_bn:
        model = serving_model(model, device, compute_dtype)
    elif (model.device != device
          or model.last_layer.weight.dtype != _storage(compute_dtype)[0]):
        raise ValueError(f"with fold_bn=False the model must already be on "
                         f"{device} in {_storage(compute_dtype)[0]} for "
                         f"{compute_dtype} (see serving_model)")
    if rasters is None:
        rasters = device_put_dataset(ds, device)
    rasters = dataclasses.replace(rasters, dsm_target=None)

    wy, wx = blend.weight_table(ds.tile_size, ds.stride, ds.valid_bounds)
    out = _predict_tiles(model, rasters, ds.positions, ds.pair_indices, wy, wx,
                         ds.dsm_input.shape, _inference_spec(ds), ds.dsm_std,
                         batch_size, compute_dtype, use_pallas, tta, tta_merge)
    return out.cpu().numpy() if as_numpy else out
