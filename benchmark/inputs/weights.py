"""Seeded random UNet weights, made on the run's device in a few large
draws, in the published ResDepth ``state_dict`` layout (``lib/UNet.py``),
which the port's ``UNet.load_state_dict`` takes and the reference reads.

Convs and upconvs draw U(±gain/sqrt(fan_in)) (``gain`` 1 is PyTorch's
default; the configuration's ``assumed.weight_gain`` keeps activations
from fading through the depth), their biases (the upconvs', and the last
conv's where ``bias_conv_layer`` is set) U(±1/sqrt(fan_in)).
BatchNorm draws its affine and running statistics (weight U(0.5, 1.5),
bias N(0, 0.1), mean N(0, 0.1), variance U(0.5, 2)) so that folding it
has work to do, as ``chip_smoke.py::random_model`` does."""

from __future__ import annotations

import math

import torch

from benchmark.counts.flops import widths


def layout(model: dict, n_input_channels: int) -> list[tuple[str, tuple, str]]:
    """``(key, shape, kind)`` of every tensor, ``kind`` one of conv, up,
    bias, bn_weight, bn_bias, bn_mean, bn_var, count."""
    w = widths(model)
    out = []

    def block(prefix, c_in, c_out):
        out.append((f"{prefix}.0.weight", (c_out, c_in, 3, 3), "conv"))
        for name, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                           ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            out.append((f"{prefix}.1.{name}", (c_out,), kind))
        out.append((f"{prefix}.1.num_batches_tracked", (), "count"))

    c_in = n_input_channels
    for i, c in enumerate(w):
        block(f"encoder.{i}.0", c_in, c)
        c_in = c
    block("bottleneck", w[-1], w[-1])
    up = w[::-1]
    for i in range(model["depth"] - 1):
        out.append((f"decoder.{i}.0.weight", (up[i], up[i], 2, 2), "up"))
        out.append((f"decoder.{i}.0.bias", (up[i],), "bias"))
        block(f"decoder.{i}.1", up[i], up[i + 1])
    top = model["depth"] - 1
    out.append((f"decoder.{top}.weight", (up[-1], up[-1], 2, 2), "up"))
    out.append((f"decoder.{top}.bias", (up[-1],), "bias"))
    out.append(("last_layer.weight", (1, model["start_kernel"], 3, 3), "conv"))
    if model["bias_conv_layer"]:
        out.append(("last_layer.bias", (1,), "bias"))
    return out


def _fan_in(shape, kind) -> int:
    if kind == "conv":
        return shape[1] * shape[2] * shape[3]
    return shape[1] * 4          # a transposed 2x2 conv: its output side


def make_state(model: dict, n_input_channels: int, seed: int, device,
               gain: float) -> dict:
    """The weights of ``model`` from ``seed`` on ``device``, float32."""
    generator = torch.Generator(device=device).manual_seed(seed)
    entries = layout(model, n_input_channels)
    sizes = [math.prod(shape) for _, shape, _ in entries]
    uniform = torch.rand(sum(sizes), generator=generator, device=device) * 2 - 1
    normal = torch.randn(sum(sizes), generator=generator, device=device)
    state, offset = {}, 0
    fan_in_of = {}
    for (key, shape, kind), size in zip(entries, sizes):
        u = uniform[offset:offset + size].view(shape)
        z = normal[offset:offset + size].view(shape)
        offset += size
        if kind == "count":
            value = torch.zeros((), dtype=torch.int64, device=device)
        elif kind in ("conv", "up"):
            fan_in_of[key.rsplit(".", 1)[0]] = _fan_in(shape, kind)
            value = u * (gain / math.sqrt(fan_in_of[key.rsplit(".", 1)[0]]))
        elif kind == "bias":
            value = u / math.sqrt(fan_in_of[key.rsplit(".", 1)[0]])
        elif kind == "bn_weight":
            value = 1.0 + 0.5 * u
        elif kind in ("bn_bias", "bn_mean"):
            value = 0.1 * z
        else:
            value = 1.25 + 0.75 * u
        state[key] = value.contiguous()
    return state
