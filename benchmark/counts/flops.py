"""Conv operations of one UNet forward, frozen from the port's
``models/unet.py::analytic_flops`` (plain graph, no composed top): the
model's work, whatever graph or kernel a mode runs it on.

``model`` is a configuration file's ``model`` section."""

from __future__ import annotations


def widths(model: dict) -> list[int]:
    return [min(model["start_kernel"] * 2 ** i, model["max_filter_depth"])
            for i in range(model["depth"])]


def forward_flops(model: dict, n_input_channels: int, tile: int) -> int:
    """Multiply-adds as 2: the encoder's 3x3 convs, the bottleneck, the
    ``depth`` 2x2 upconvs (one tap an output pixel), the 3x3 conv after
    every skip but the top one, and the last conv to one channel."""
    w = widths(model)
    depth = model["depth"]
    flops, c_in = 0, n_input_channels
    for i, c in enumerate(w):
        r = tile >> i
        flops += 2 * 9 * r * r * c_in * c
        c_in = c
    r = tile >> depth
    flops += 2 * 9 * r * r * w[-1] * w[-1]
    up = w[::-1]
    for i in range(depth):
        r_out = tile >> (depth - 1 - i)
        flops += 2 * r_out * r_out * up[i] * up[i]
        if i < depth - 1:
            flops += 2 * 9 * r_out * r_out * up[i] * up[i + 1]
    return flops + 2 * 9 * tile * tile * model["start_kernel"]
