"""Weighted overlap-add of refined tiles into the scene canvas, in place.

Port of ``resdepth_tpu/ops/pallas_stitch.py``. For each tile i of a batch:

    scene[y_i:y_i+T, x_i:x_i+T] += (tile_i * sigma + mean_i) * (wy_i ⊗ wx_i)

Three implementations of that one function:

  * ``stitch_tiles`` on a CUDA canvas launches kernel K1 (``csrc/stitch.cu``,
    the port of ``stitch_tiles_pallas``): f32 atomics, any sum order.
  * ``stitch_tiles_fused`` on a CUDA canvas launches kernel K2 (the port of
    ``stitch_tiles_pallas_fused``): output-stationary, tiles summed in batch
    order, bitwise reproducible. It loads and stores by float4 where the
    shapes allow it (``k2_vector_paths``) and by scalars where they do not.
  * ``stitch_tiles_plain``, the torch twin of ``stitch_tiles_xla``
    (``index_add_`` along the flattened canvas, in batch order on the CPU).
    Both wrappers run it for a CPU canvas; it is the reference the kernels
    are held against. On a CUDA canvas nothing runs it but that comparison.

Dispatch has no hidden fallback: a CUDA canvas runs a kernel or raises.
``LAUNCHES`` counts kernel launches, so a run can show that its stitches
went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from resdepth_tpu_torch.ops import build

LAUNCHES = {"k1": 0, "k2": 0}

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "stitch_k1": [_PTR, _INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _FLOAT,
                  _INT, _INT, _PTR],
    "stitch_k2": [_PTR, _INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _FLOAT,
                  _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _PTR],
}


@functools.cache
def _library() -> ctypes.CDLL:
    """The built stitch library with its entry points typed (once)."""
    lib = build.load("stitch")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.stitch_error_string.argtypes = [ctypes.c_int]
    lib.stitch_error_string.restype = ctypes.c_char_p
    return lib


def validate_use_pallas(use_pallas, device) -> None:
    """Raise for a ``general.use_pallas`` value the stitch cannot honour on
    ``device`` (a torch.device)."""
    if use_pallas not in (None, True, False, "fused"):
        raise ValueError(f"use_pallas must be true, false, 'fused' or unset, "
                         f"got {use_pallas!r}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the stitch runs on 'cpu' or 'cuda', not {device.type!r}")
    if device.type == "cuda" and use_pallas is False:
        raise ValueError(
            "use_pallas: false selects the plain stitch, which is the port's "
            "CPU reference only; on CUDA the stitch runs kernel K1 "
            "(use_pallas true or unset) or K2 (use_pallas 'fused')")


def check_positions(positions, tile: int, shape) -> None:
    """Raise unless every tile of the (B, 2) (y, x) origins ``positions``
    (numpy or torch) lies inside a canvas of ``shape``. The kernels take the
    positions as given (the JAX gather clamps them instead), so callers
    check on the host before a launch."""
    if len(positions) and (int(positions.min()) < 0
                           or int(positions[:, 0].max()) + tile > shape[0]
                           or int(positions[:, 1].max()) + tile > shape[1]):
        raise ValueError(f"tile positions reach outside the {tuple(shape)} "
                         f"canvas for tile size {tile}")


def stitch_tiles_plain(scene, tiles, positions, wy, wx, means, sigma):
    """Torch twin of ``stitch_tiles_xla``; accumulates into ``scene`` in
    place and returns it.

    The adds go along one flattened index with ``index_add_``, which on the
    CPU takes them in index order, so each pixel sums as ``scene + tile_0 +
    tile_1 + ...``: the order of the TPU kernels and of K2. (On the CPU,
    ``index_put_(accumulate=True)`` with more than one thread does not keep
    that order: its sums moved by 2 ulps at 450 m with the thread count.)
    """
    cols_total = scene.shape[1]
    tile = tiles.shape[1]
    positions = positions.long()
    check_positions(positions, tile, scene.shape)
    sigma = torch.tensor(sigma, dtype=torch.float32, device=tiles.device)
    pred = tiles * sigma + means[:, None, None]
    weighted = pred * (wy[:, :, None] * wx[:, None, :])
    offsets = torch.arange(tile, device=positions.device)
    rows = positions[:, 0, None, None] + offsets[None, :, None]
    cols = positions[:, 1, None, None] + offsets[None, None, :]
    scene.view(-1).index_add_(0, (rows * cols_total + cols).reshape(-1),
                              weighted.reshape(-1))
    return scene


def _check_cuda_args(scene, tiles, positions, wy, wx, means) -> None:
    b, t = tiles.shape[0], tiles.shape[-1]
    expected = {"scene": (scene, torch.float32, None),
                "tiles": (tiles, torch.float32, (b, t, t)),
                "positions": (positions, torch.int32, (b, 2)),
                "wy": (wy, torch.float32, (b, t)),
                "wx": (wx, torch.float32, (b, t)),
                "means": (means, torch.float32, (b,))}
    for name, (tensor, dtype, shape) in expected.items():
        if tensor.device != scene.device:
            raise ValueError(f"{name} is on {tensor.device}, the canvas on {scene.device}")
        if tensor.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {tensor.dtype}")
        if shape is not None and tuple(tensor.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(tensor.shape)}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if scene.dim() != 2:
        raise ValueError(f"the canvas must be 2-D, got shape {tuple(scene.shape)}")
    if not 0 < b < 65536:
        raise ValueError(f"batch of {b} tiles: the kernels take 1 to 65535")


def _raise_on(lib, code: int, kernel: str) -> None:
    if code != 0:
        raise RuntimeError(f"stitch kernel {kernel} failed to launch: "
                           f"{lib.stitch_error_string(code).decode()}")


def stitch_tiles(scene, tiles, positions, wy, wx, means, sigma,
                 use_pallas: bool | str | None = None, bounds=None):
    """Stitch one batch into ``scene`` in place; returns ``scene``.

    ``scene`` (rows, cols) f32; ``tiles`` (B, T, T) f32; ``positions``
    (B, 2) int32 (y, x) origins, every tile inside the canvas; ``wy``/``wx``
    (B, T) f32; ``means`` (B,) f32; ``sigma`` a float. A CPU canvas runs
    the plain twin. A CUDA canvas runs K1 (``use_pallas`` True or None) or
    K2 (``"fused"``, see ``stitch_tiles_fused`` for ``bounds``) and raises
    for False.
    """
    validate_use_pallas(use_pallas, scene.device)
    if scene.device.type == "cpu":
        return stitch_tiles_plain(scene, tiles, positions, wy, wx, means, sigma)
    if use_pallas == "fused":
        return stitch_tiles_fused(scene, tiles, positions, wy, wx, means,
                                  sigma, bounds=bounds)
    _check_cuda_args(scene, tiles, positions, wy, wx, means)
    lib = _library()
    rows, cols = scene.shape
    code = lib.stitch_k1(
        scene.data_ptr(), rows, cols, tiles.data_ptr(), positions.data_ptr(),
        wy.data_ptr(), wx.data_ptr(), means.data_ptr(), float(sigma),
        tiles.shape[0], tiles.shape[1],
        torch.cuda.current_stream(scene.device).cuda_stream)
    _raise_on(lib, code, "K1")
    LAUNCHES["k1"] += 1
    return scene


def batch_bounds(positions, tile: int) -> tuple[int, int, int, int]:
    """(y0, x0, y1, x1), end-exclusive: the box of a batch's tiles, from
    its (B, 2) host positions (``stitch_tiles_fused``'s ``bounds``)."""
    return (int(positions[:, 0].min()), int(positions[:, 1].min()),
            int(positions[:, 0].max()) + tile, int(positions[:, 1].max()) + tile)


def k2_vector_paths(scene, tiles, wx) -> tuple[bool, bool]:
    """Which of K2's float4 paths a call takes, from shapes and alignment:
    (canvas, tiles). The canvas path needs ``cols % 4 == 0`` and a 16-byte
    aligned canvas; the tile path needs ``T % 4 == 0`` and 16-byte aligned
    tiles and ``wx``, and then serves each tile whose column origin is a
    multiple of 4 (the others load by scalars)."""
    canvas = scene.shape[1] % 4 == 0 and scene.data_ptr() % 16 == 0
    tile_rows = (tiles.shape[-1] % 4 == 0 and tiles.data_ptr() % 16 == 0
                 and wx.data_ptr() % 16 == 0)
    return canvas, tile_rows


def stitch_tiles_fused(scene, tiles, positions, wy, wx, means, sigma,
                       bounds=None):
    """Same contract as ``stitch_tiles``; a CUDA canvas runs K2.

    ``bounds`` = (y0, x0, y1, x1), a box of the canvas that holds every
    tile of the batch (end-exclusive; ``batch_bounds`` gives the least
    one). K2 launches one CTA per 16x128 canvas block of it; each finds the
    tiles that cover its block on the device, and a block that no tile
    covers leaves the canvas untouched. None takes the whole canvas.
    """
    if scene.device.type == "cpu":
        return stitch_tiles_plain(scene, tiles, positions, wy, wx, means, sigma)
    validate_use_pallas("fused", scene.device)
    _check_cuda_args(scene, tiles, positions, wy, wx, means)
    rows, cols = scene.shape
    y0, x0, y1, x1 = (0, 0, rows, cols) if bounds is None else bounds
    y0, x0, y1, x1 = max(0, y0), max(0, x0), min(rows, y1), min(cols, x1)
    if y1 <= y0 or x1 <= x0:
        return scene   # no tile meets the canvas
    vec_canvas, vec_tiles = k2_vector_paths(scene, tiles, wx)
    lib = _library()
    code = lib.stitch_k2(
        scene.data_ptr(), rows, cols, tiles.data_ptr(), positions.data_ptr(),
        wy.data_ptr(), wx.data_ptr(), means.data_ptr(), float(sigma),
        tiles.shape[0], tiles.shape[1], y0, x0, y1, x1, int(vec_canvas),
        int(vec_tiles), torch.cuda.current_stream(scene.device).cuda_stream)
    _raise_on(lib, code, "K2")
    LAUNCHES["k2"] += 1
    return scene
