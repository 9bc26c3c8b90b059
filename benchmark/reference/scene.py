"""A whole scene refined by the plain UNet (``reference/unet.py``) and
blended, as ResDepth's ``lib/evaluation.py`` describes it: an overlapping
grid of tiles whose last tile of a row or column is shifted inward to the
border, each tile's DSM centred on its mean over valid pixels and scaled
by the DSM's standard deviation, the orthos normalised by theirs, and the
predictions denormalised and blended with linear ramps over the overlaps
(weight 1 in the part no earlier tile covers). The grid and the ramps are
worked out here anew, not taken from the program."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import unet


def axis_tiles(length: int, tile: int, stride: int):
    """Tile starts along one axis of ``length`` pixels and each tile's
    exclusive span ``[lo, hi]`` (tile-local): the first tile owns
    ``[0, stride - 1]``, a later one ``[tile - stride, stride - 1]``, the
    last is shifted to end on the border and owns the rest of itself."""
    n = 1 if tile >= length else 1 + -(-(length - tile) // stride)
    starts = [k * stride for k in range(n)]
    lo = [0] + [tile - stride] * (n - 1)
    hi = [stride - 1] * (n - 1) + [tile - 1]
    shift = starts[-1] + tile - length
    starts[-1] -= shift
    lo[-1] += shift
    return starts, lo, hi


def axis_ramp(tile: int, stride: int, lo: int, hi: int) -> np.ndarray:
    """The blend weights of one tile along one axis."""
    overlap = tile - stride
    w = np.ones(tile, np.float64)
    ramp = np.linspace(0.0, 1.0, overlap) if overlap > 1 else np.full(overlap, 0.5)
    if lo > 0:
        w[:lo - overlap] = 0.0
        w[lo - overlap:lo] *= ramp
    if hi < tile - 1:
        w[hi + 1:] *= ramp[::-1][:tile - hi - 1]
    return w


def grid(rows: int, cols: int, tile: int, stride: int):
    """Row-major ``(y, x, wy, wx)`` of every tile."""
    ys, ylo, yhi = axis_tiles(rows, tile, stride)
    xs, xlo, xhi = axis_tiles(cols, tile, stride)
    return [(y, x, axis_ramp(tile, stride, a, b), axis_ramp(tile, stride, c, d))
            for y, a, b in zip(ys, ylo, yhi) for x, c, d in zip(xs, xlo, xhi)]


def refine_scene(sd: dict, depth: int, dsm: torch.Tensor, orthos, *, tile: int,
                 stride: int, dsm_std: float, ortho_mean: float, ortho_std: float,
                 nodata: float, block: int = 32, tf32: bool = False) -> torch.Tensor:
    """The blended refined DSM (rows, cols) float32 on ``dsm``'s device.
    ``orthos`` (V, rows, cols) or None (the DSM alone). ``tf32`` lets
    cuDNN round the convs' operands to TF32: a control, not the
    reference."""
    rows, cols = dsm.shape
    tiles = grid(rows, cols, tile, stride)
    canvas = torch.zeros((rows, cols), dtype=torch.float64, device=dsm.device)
    with unet.float32_exact(not tf32), torch.no_grad():
        for start in range(0, len(tiles), block):
            part = tiles[start:start + block]
            d = torch.stack([dsm[y:y + tile, x:x + tile] for y, x, _, _ in part])
            valid = d != nodata
            mean = (d * valid).sum((1, 2)) / valid.sum((1, 2)).clamp_min(1)
            planes = [(d - mean[:, None, None]) / dsm_std]
            if orthos is not None:
                o = torch.stack([orthos[:, y:y + tile, x:x + tile] for y, x, _, _ in part])
                planes = [planes[0][:, None], (o - ortho_mean) / ortho_std]
            else:
                planes = [planes[0][:, None]]
            pred = unet.forward(sd, torch.cat(planes, 1), depth)[:, 0]
            heights = (pred * dsm_std + mean[:, None, None]).double()
            for k, (y, x, wy, wx) in enumerate(part):
                wy, wx = (torch.from_numpy(w).to(dsm.device) for w in (wy, wx))
                canvas[y:y + tile, x:x + tile] += heights[k] * wy[:, None] * wx[None, :]
    return canvas.float()
