"""The least time the card could take for a kernel's work, frozen from
``chip_smoke.py``'s ``bound_ms``, ``conv_bound`` and ``stitch_bound``.

Peaks: one NVIDIA H100 SXM at its 700 W limit, NVIDIA's data sheet, dense.
Every share of a peak in this benchmark is against these numbers; the run
prints the card's power limit beside them."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The larger of the bytes over the memory rate and the operations over
    the bf16 tensor rate."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_BF16_FLOPS)


def conv3x3_bound_s(x_shape, c_out: int, passes: int, element_size: int) -> float:
    """K3 on NHWC ``x_shape`` (N, H, W, Cin) to ``c_out`` channels: x, the
    weights and the output once in x's type, bias and slopes once in
    float32; 2·N·H·W·9·Cin·Cout operations for each bf16 pass."""
    n, h, w, c_in = x_shape
    n_bytes = ((n * h * w * c_in + 9 * c_in * c_out + n * h * w * c_out) * element_size
               + 8 * c_out)
    return bound_s(n_bytes, passes * 2.0 * n * h * w * 9 * c_in * c_out)


def stitch_bound_s(n_tiles: int, tile: int, covered_pixels: int) -> float:
    """One stitch launch: the float32 tiles, the int32 positions, the
    blend weights and the means read once, and the canvas pixels the batch
    covers read and written once; three operations a tile pixel."""
    n_bytes = 4 * (n_tiles * tile * tile + 2 * n_tiles + 2 * n_tiles * tile + n_tiles)
    n_bytes += 2 * 4 * covered_pixels
    return bound_s(n_bytes, 3.0 * n_tiles * tile * tile)
