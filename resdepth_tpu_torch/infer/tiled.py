"""Full-scene tiled inference with on-device linear-blend stitching.

Port of the device-resident path of ``resdepth_tpu/infer/tiled.py``. The
scene rasters and one f32 canvas live on the device; a Python loop over tile
batches takes the place of the JAX ``lax.scan``. Each step gathers and
normalises a batch of tiles (``data.pipeline.build_batch``), runs the UNet
in eval mode, and stitches the batch into the canvas in place
(``ops.stitch``: denormalisation, separable blend weights and overlap-add
in one kernel). CUDA work is asynchronous, so the loop only enqueues; the
canvas comes back to the host once, through pinned memory on CUDA
(``_fetch``). Whenever a ``torch.profiler`` profile is on,
``predict_linear_blend`` records a ``scene`` span with
``scene.weight_table``, each batch's ``scene.gather`` and
``scene.forward`` (timed on the device too) and ``scene.fetch`` under it
(``utils/profiler.py``).

Blend semantics are the reference's (``resdepth_tpu/ops/blend.py``):
partition of unity over the region, weight 1 in each tile's exclusive area
and linear ramps over the overlap bands.

``compute_dtype`` is a torch dtype (float32 or bfloat16) or one of the
string serving modes (``models.unet.SERVING_PRECISION_MODES``), which keep
f32 weights and run the UNet on the f32 batch at the mode's precisions.

``predict_linear_blend_streaming`` refines a scene whose rasters exceed a
device budget by full-width row bands, one band window on the device at a
time (``data/banded.py::iter_bands``); ``predict_linear_blend_scene_sharded``
refines those bands on every rank of a process group at once.

Across processes (one per GPU, ``parallel/``): ``group`` shards every batch
step's tiles over the ranks, each rank stitches its share into its own
canvas, and one all-reduce sums the canvases, as the JAX scene program
``psum``s its devices' canvases (``predict_linear_blend``, and each band of
``predict_linear_blend_streaming``); ``predict_linear_blend_scene_sharded``
gives each rank whole row bands instead, all ranks at once, and the chief
adds them into the scene.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from resdepth_tpu_torch.data.banded import iter_bands, resident_pixels
from resdepth_tpu_torch.data.dataset import TileDataset
from resdepth_tpu_torch.data.pipeline import (BatchSpec, DeviceRasters,
                                              batch_spec_for, build_batch,
                                              device_put_dataset, to_device)
from resdepth_tpu_torch.models.unet import (SERVING_PRECISION_MODES, UNet,
                                            apply_unet, fold_serving,
                                            serving_precision)
from resdepth_tpu_torch.ops import blend, stitch
from resdepth_tpu_torch.parallel import mesh
from resdepth_tpu_torch.utils import profiler

# Dihedral-group subsets for test-time augmentation (general.tta). Element
# g is rot90 by (g % 4) quarter turns, after a horizontal flip when g >= 4.
# Each count is a subgroup of D4: 2 -> {identity, flip}; 4 -> rotations;
# 8 -> D4.
TTA_SUBGROUPS = {1: (0,), 2: (0, 4), 4: (0, 1, 2, 3), 8: tuple(range(8))}

# How the tta predictions of one tile are merged (general.tta_merge).
TTA_MERGES = ("mean", "median")

# The largest resident canvas (an 8192^2 f32 scene) that predict_linear_blend
# fetches through pinned memory. Past it, pinned blocks (power-of-two sized,
# never returned to the system) would lock GiBs of host memory. The CLI
# fetches whole with as_numpy=True only a scene whose rasters and two
# canvases outgrow predict.MAX_DEVICE_PIXELS: a canvas over 2**32 / (planes
# + 2) bytes, above this bound up to 14 raster planes, so it never pins.
PINNED_SCENE_BYTES = 1 << 28


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
    start = len(positions) // batch_size * batch_size
    if start == len(positions):
        # whole batches of padding (a band padded to the bands' tile count,
        # ``predict_linear_blend_scene_sharded``): the last full batch's
        start -= batch_size
    return np.concatenate([positions, np.resize(positions[start:], (pad, 2))])


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
                   compute_dtype, use_pallas, tta=1, tta_merge="mean",
                   canvas: torch.Tensor | None = None, group=None):
    """Run the batch loop over one set of tiles into a (rows, cols) canvas,
    a new zero one or ``canvas`` (on the rasters' device, added into in
    place), in batches of ``batch_size`` tiles, the last padded
    (``_pad_positions``).

    Under ``group`` a step holds ``batch_size`` tiles of each of the N
    ranks (the last step padded on its real tiles); rank r runs the r-th
    ``batch_size`` of every step into this process's canvas (K2's box from
    its own share), then one all-reduce sums the canvases over the group:
    every rank holds the scene.

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
    ranks = mesh.size(group)
    per_step = batch_size * ranks
    n_padded = -(-n // per_step) * per_step
    positions = _pad_positions(positions, n_padded, per_step)
    pair_idx = _pad_round_up(pair_idx, n_padded)
    wy = _pad_round_up(wy, n_padded, 0.0)   # zero weights: padding adds nothing
    wx = _pad_round_up(wx, n_padded, 0.0)
    if ranks > 1:   # this rank's share of each step, as P(None, axes) splits it
        r = mesh.rank(group)
        positions, pair_idx, wy, wx = (
            a.reshape((-1, ranks, batch_size) + a.shape[1:])[:, r].reshape(
                (-1,) + a.shape[1:]) for a in (positions, pair_idx, wy, wx))
        n_padded //= ranks

    pos_d = to_device(positions.astype(np.int32), device)
    pair_d = to_device(pair_idx.astype(np.int64), device)
    wy_d = to_device(wy, device)
    wx_d = to_device(wx, device)

    dtype, kwargs = _storage(compute_dtype)

    def run_model(x):
        return apply_unet(model, x.to(dtype), **kwargs)[..., 0].to(torch.float32)

    def forward(x):
        if tta == 1:
            return run_model(x)
        if tta_merge == "median":
            # The per-tile denormalisation is a monotone affine map shared
            # by a tile's replicas, so the median commutes with it.
            return _median(torch.stack([_dihedral_invert(run_model(_dihedral_apply(x, g)), g)
                                        for g in TTA_SUBGROUPS[tta]]))
        # Averaging normalised predictions equals averaging the denormalised
        # ones (the stitch's denormalisation is affine).
        acc = 0.0
        for g in TTA_SUBGROUPS[tta]:
            acc = acc + _dihedral_invert(run_model(_dihedral_apply(x, g)), g)
        return acc / tta

    if canvas is None:
        canvas = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    with torch.inference_mode():
        for start in range(0, n_padded, batch_size):
            sl = slice(start, start + batch_size)
            with profiler.span("scene.gather", device=device):
                batch = build_batch(rasters, pos_d[sl], pair_d[sl], spec)
            with profiler.span("scene.forward", device=device):
                pred = forward(batch["input"])
            stitch.stitch_tiles(canvas, pred.contiguous(), pos_d[sl], wy_d[sl],
                                wx_d[sl], batch["dsm_mean"], dsm_std,
                                use_pallas=use_pallas,
                                bounds=stitch.batch_bounds(positions[sl], tile))
    return mesh.all_reduce_(canvas, group)


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


def _scene_batch(batch_size: int, ds: TileDataset, ranks: int = 1) -> int:
    """The scene's batch size a rank: ``batch_size`` capped at a rank's
    share of its tile count (zero-weight padding past that is wasted
    forward compute)."""
    return max(1, min(batch_size, -(-len(ds.positions) // ranks)))


def _scene_model(model: UNet, device, compute_dtype, fold_bn: bool) -> tuple:
    """``device`` with its index, and the module the scene loop runs:
    ``serving_model``'s with ``fold_bn``, else ``model``, which must
    already be on ``device`` in ``compute_dtype``'s storage dtype."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if fold_bn:
        return device, serving_model(model, device, compute_dtype)
    if (model.device != device
            or model.last_layer.weight.dtype != _storage(compute_dtype)[0]):
        raise ValueError(f"with fold_bn=False the model must already be on "
                         f"{device} in {_storage(compute_dtype)[0]} for "
                         f"{compute_dtype} (see serving_model)")
    return device, model


def predict_linear_blend(model: UNet, ds: TileDataset, *, device,
                         batch_size: int = 64,
                         compute_dtype: torch.dtype | str = torch.float32,
                         rasters: DeviceRasters | None = None,
                         use_pallas: bool | str | None = None,
                         fold_bn: bool = True, as_numpy: bool = True,
                         tta: int = 1, tta_merge: str = "mean", group=None):
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
    On CUDA a canvas of at most ``PINNED_SCENE_BYTES`` is copied into pinned
    host memory (``_fetch``), a fresh block of torch's caching host
    allocator each call: the array belongs to the caller, and no later call
    writes to it. The block is a power of two in size and stays pinned while
    the caller holds the array; once dropped, the allocator keeps it for a
    later scene and never hands it back to the system. A larger canvas is
    copied into pageable memory. False returns the device canvas as soon as
    the work is queued; fetch it with ``.cpu().numpy()`` (``np.asarray``
    raises on a CUDA tensor).

    ``tta`` in {1, 2, 4, 8}: predict each tile under that dihedral subgroup
    and merge the inverse-transformed predictions by ``tta_merge``
    ("mean" or "median").

    ``group`` (``parallel.mesh.data_mesh``) shares the tiles over its ranks,
    ``batch_size`` a rank a step (capped at a rank's share of the scene),
    and sums their canvases (``_predict_tiles``): every rank returns the
    scene. The sum regroups each pixel's tiles by rank, so the scene is
    held to K1's bar, not bitwise, against one process.
    """
    with profiler.span("scene"):
        device, model = _scene_model(model, device, compute_dtype, fold_bn)
        if rasters is None:
            rasters = device_put_dataset(ds, device)
        rasters = dataclasses.replace(rasters, dsm_target=None)

        with profiler.span("scene.weight_table"):
            wy, wx = blend.weight_table(ds.tile_size, ds.stride, ds.valid_bounds)
        out = _predict_tiles(model, rasters, ds.positions, ds.pair_indices, wy, wx,
                             ds.dsm_input.shape, _inference_spec(ds), ds.dsm_std,
                             _scene_batch(batch_size, ds, mesh.size(group)),
                             compute_dtype, use_pallas, tta, tta_merge, group=group)
        if not as_numpy:
            return out
        with profiler.span("scene.fetch", device=out.device):
            if out.nbytes > PINNED_SCENE_BYTES:
                return out.cpu().numpy()
            host, done = _fetch(out)
            if done is not None:
                done.synchronize()
            return host.numpy()


def predict_linear_blend_streaming(model: UNet, ds: TileDataset, *, device,
                                   max_device_pixels: int = 1 << 28,
                                   batch_size: int = 64,
                                   compute_dtype: torch.dtype | str = torch.float32,
                                   use_pallas: bool | str | None = None,
                                   fold_bn: bool = True, tta: int = 1,
                                   tta_merge: str = "mean",
                                   group=None) -> np.ndarray:
    """Refine a scene too large for the device budget by streaming row
    bands; returns the blended refined DSM (rows, cols) on the host.

    The stitch is additive, so the tile grid can be partitioned: the tiles
    group into full-width row bands whose raster windows fit
    ``max_device_pixels`` (raster pixels: the DSM and the ortho views), and
    for each band the window is uploaded, its tiles are refined and
    stitched into a band canvas on the device, and the canvas is fetched
    into the host scene. On CUDA the next band's window goes up while this
    band computes and its canvas comes down while the next computes, so at
    most two bands' windows and canvases are on the device at a time. Every
    band runs the resident scene's batch size (a band with
    fewer tiles pads up to it): cuDNN may take another algorithm at another
    batch size, which moves a tile's prediction (by 2 f32 ulps of the
    heights in float32, 42 in ``balanced16``, at a batch of 93 against 128
    on an H100). Each band pads its own last batch (``_pad_positions``), so
    K2's launch box stays on that band's real tiles.

    A band's canvas starts from the band above's canvas on the rows their
    windows share (the band above holds every earlier band's sums there),
    and replaces those rows of the host scene: each pixel adds its tiles in
    the resident scene's order (the grid's, row-major), so with K2 or the
    plain stitch the scene is bitwise the resident one. (The JAX package
    adds zero-started band canvases into the scene, which regroups the sums
    on the shared rows.)

    Under ``group`` each band runs as ``predict_linear_blend`` runs the
    scene (its tiles shared over the ranks, its canvas summed), at the
    resident scene's batch a rank; only the chief starts its band canvas
    from the band above's sums, which every rank holds after the sum, so
    they are counted once. The sums regroup there too: the scene is held to
    K1's bar against the resident one.

    The other arguments are ``predict_linear_blend``'s. Raises
    ``ValueError`` when the budget cannot hold one tile-high band of the
    full width (the JAX package takes that band anyway, over its budget).
    """
    device, model = _scene_model(model, device, compute_dtype, fold_bn)
    rows, cols = ds.dsm_input.shape
    rows_budget = _rows_budget(ds, max_device_pixels)
    tile = ds.tile_size
    spec = _inference_spec(ds)
    batch_size = _scene_batch(batch_size, ds, mesh.size(group))
    carry = mesh.rank(group) == 0
    wy_all, wx_all = blend.weight_table(tile, ds.stride, ds.valid_bounds)
    pairs = torch.as_tensor(ds.pairs_array, dtype=torch.int64, device=device)
    out = np.zeros((rows, cols), np.float32)
    above = fetching = None
    for window, band_idx, band_positions in _iter_bands(ds, rows_budget):
        band_rasters = DeviceRasters(
            dsm_input=to_device(ds.dsm_input[window], device),
            dsm_target=None,
            orthos=(to_device(ds.orthos[window].transpose(2, 0, 1), device)
                    if ds.orthos is not None else None),
            pairs=pairs, nodata=float(ds.nodata))
        canvas = torch.zeros((window.stop - window.start, cols),
                             dtype=torch.float32, device=device)
        if carry and above is not None and above[0].stop > window.start:
            canvas[:above[0].stop - window.start] = \
                above[1][window.start - above[0].start:]
        _predict_tiles(model, band_rasters, band_positions,
                       ds.pair_indices[band_idx], wy_all[band_idx],
                       wx_all[band_idx], canvas.shape, spec, ds.dsm_std,
                       batch_size, compute_dtype, use_pallas, tta, tta_merge,
                       canvas=canvas, group=group)
        if fetching is not None:
            _land(out, *fetching)
        fetching = (window, *_fetch(canvas))
        above = (window, canvas)
        del band_rasters
    if fetching is not None:
        _land(out, *fetching)
    return out


def predict_linear_blend_scene_sharded(model: UNet, ds: TileDataset, *, device,
                                       max_device_pixels: int = 1 << 28,
                                       batch_size: int = 64,
                                       compute_dtype: torch.dtype | str = torch.float32,
                                       use_pallas: bool | str | None = None,
                                       fold_bn: bool = True, tta: int = 1,
                                       tta_merge: str = "mean", group=None):
    """Refine a scene too large for one device's budget with every rank of
    ``group`` at once, whole row bands a rank; returns the blended refined
    DSM (rows, cols) on the host of rank 0, and None on the other ranks.

    The bands are ``predict_linear_blend_streaming``'s (``max_device_pixels``
    bounds each rank's raster window). Rank r of N refines bands r, r + N,
    ... in waves, each band padded to the bands' common window height and
    tile count (zero-weight tiles, on the band's real ones) as the JAX
    package pads them, at the resident scene's batch size. Each band
    starts from a zero canvas: the streaming path's carry from the band
    above cannot cross ranks while the bands run at once. Rank 0 receives
    the wave's canvases (``parallel.mesh.recv``: on the device under NCCL,
    through host memory under gloo) and adds them into the host scene in
    band order, as the JAX package does; on the rows two bands share the
    sums so regroup. Without ``group`` this process runs every band in
    turn. The other arguments are ``predict_linear_blend_streaming``'s.
    """
    device, model = _scene_model(model, device, compute_dtype, fold_bn)
    rows, cols = ds.dsm_input.shape
    tile = ds.tile_size
    spec = _inference_spec(ds)
    batch_size = _scene_batch(batch_size, ds)
    ranks, rank = mesh.size(group), mesh.rank(group)
    wy_all, wx_all = blend.weight_table(tile, ds.stride, ds.valid_bounds)
    bands = list(_iter_bands(ds, _rows_budget(ds, max_device_pixels)))
    window_rows = max(w.stop - w.start for w, _, _ in bands)
    n_tiles = max(len(idx) for _, idx, _ in bands)
    pairs = torch.as_tensor(ds.pairs_array, dtype=torch.int64, device=device)
    out = np.zeros((rows, cols), np.float32) if rank == 0 else None
    for wave in range(0, len(bands), ranks):
        canvas = None
        if wave + rank < len(bands):
            window, band_idx, band_positions = bands[wave + rank]
            n = window.stop - window.start
            dsm = np.zeros((window_rows, cols), np.float32)
            dsm[:n] = ds.dsm_input[window]
            orthos = None
            if ds.orthos is not None:
                orthos = np.zeros((ds.orthos.shape[2], window_rows, cols), np.float32)
                orthos[:, :n] = ds.orthos[window].transpose(2, 0, 1)
            band_rasters = DeviceRasters(
                dsm_input=to_device(dsm, device), dsm_target=None,
                orthos=to_device(orthos, device) if orthos is not None else None,
                pairs=pairs, nodata=float(ds.nodata))
            canvas = _predict_tiles(
                model, band_rasters,
                _pad_positions(band_positions, n_tiles, batch_size),
                _pad_round_up(ds.pair_indices[band_idx], n_tiles),
                _pad_round_up(wy_all[band_idx], n_tiles, 0.0),
                _pad_round_up(wx_all[band_idx], n_tiles, 0.0),
                (window_rows, cols), spec, ds.dsm_std, batch_size, compute_dtype,
                use_pallas, tta, tta_merge)
            del band_rasters
        if rank != 0:
            if canvas is not None:
                mesh.send(canvas, 0, group)
            continue
        for source, (window, _, _) in enumerate(bands[wave:wave + ranks]):
            band = canvas if source == 0 else mesh.recv((window_rows, cols), source,
                                                        group, device)
            out[window] += band[:window.stop - window.start].cpu().numpy()
    return out


def _rows_budget(ds: TileDataset, max_device_pixels: int) -> int:
    """The band height that ``max_device_pixels`` holds at the scene's full
    width over its raster planes (the DSM and the ortho views). Raises
    ``ValueError`` below one tile-high band (the JAX package takes that
    band anyway, over its budget)."""
    tile = ds.tile_size
    rows, cols = ds.dsm_input.shape
    planes = resident_pixels(ds, include_target=False) // (rows * cols)
    rows_budget = max_device_pixels // (cols * planes)
    if rows_budget < tile:
        raise ValueError(
            f"max_device_pixels {max_device_pixels:,} cannot hold one "
            f"{tile}-row band of the scene's full width: {tile} rows x "
            f"{cols} columns x {planes} raster planes need "
            f"{tile * cols * planes:,} pixels. Raise the budget or lower "
            f"the tile size.")
    return rows_budget


def _fetch(canvas: torch.Tensor) -> tuple:
    """Start copying ``canvas`` to the host: ``(host tensor, CUDA event or
    None)``, the copy done once the event is."""
    if canvas.device.type != "cuda":
        return canvas, None
    host = torch.empty(canvas.shape, dtype=canvas.dtype, pin_memory=True)
    host.copy_(canvas, non_blocking=True)
    done = torch.cuda.Event()
    # The copy runs on the canvas device's stream, which need not be the
    # current device's.
    done.record(torch.cuda.current_stream(canvas.device))
    return host, done


def _land(out: np.ndarray, window: slice, host: torch.Tensor, done) -> None:
    """Write a fetched band canvas over its window's rows of ``out``."""
    if done is not None:
        done.synchronize()
    out[window] = host.numpy()


def _iter_bands(ds: TileDataset, rows_budget: int):
    """The tile grid in full-width row bands of <= rows_budget rows
    (``data/banded.py::iter_bands``): ``(window, band_idx,
    band_positions)``, a tile in the band that holds its top row."""
    yield from iter_bands(ds.positions, ds.tile_size, rows_budget)
