"""Convolutions at a number of bf16 product passes, with float32 results.

The JAX package's serving modes set the precision of its TPU convs, and a
TPU conv on float32 operands at a precision is a number of bf16 passes of
the MXU, summed in float32. With ``v = v_hi + v_lo``, ``v_hi = bf16(v)``
and ``v_lo = bf16(v - v_hi)``:

  * 1 pass (``Precision.DEFAULT``): ``x_hi w_hi``;
  * 2 passes (``(HIGH, DEFAULT)``: the activation split, the weights
    single-rounded): ``x_hi w_hi + x_lo w_hi``;
  * 3 passes (``Precision.HIGH``): ``x_hi w_hi + x_hi w_lo + x_lo w_hi``.

A product of two bf16 values is exact in float32, so one IEEE-float32 conv
over the operands concatenated along the input channels (``[x_hi]``,
``[x_hi, x_lo]`` or ``[x_hi, x_hi, x_lo]`` against ``[w_hi]``, ``[w_hi,
w_hi]`` or ``[w_hi, w_lo, w_hi]``) sums the same products as the TPU, in
another order. That is how this module computes them: the plain version of
kernel K3's passes (``ops/conv.py``) and, through ``F.conv_transpose2d`` and
``F.conv2d``, the convs the JAX package leaves to XLA at a precision, the
UNet's 2x2 stride-2 transposed upconv and the bilinear mode's 1x1 conv.
TF32 does not change these sums (bf16 operands are exact in TF32 too); the
serving modes keep it off as the float32 path does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PASSES = (1, 2, 3)


def split(t: torch.Tensor):
    """``t`` float32 -> ``(hi, lo)`` float32 tensors holding bf16 values,
    ``hi = bf16(t)`` and ``lo = bf16(t - hi)``."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def pass_operands(x: torch.Tensor, weight: torch.Tensor, passes: int,
                  x_dim: int, w_dim: int):
    """``x`` and ``weight`` concatenated along their input-channel dims
    (``x_dim``, ``w_dim``) so that one float32 conv sums the products of
    ``passes`` bf16 passes (module docstring)."""
    if passes not in PASSES:
        raise ValueError(f"passes must be one of {PASSES}, got {passes!r}")
    x_hi, x_lo = split(x.float())
    w_hi, w_lo = split(weight.float())
    xs = {1: [x_hi], 2: [x_hi, x_lo], 3: [x_hi, x_hi, x_lo]}[passes]
    ws = {1: [w_hi], 2: [w_hi, w_hi], 3: [w_hi, w_lo, w_hi]}[passes]
    return torch.cat(xs, dim=x_dim), torch.cat(ws, dim=w_dim)


def conv2d(x, weight, bias=None, passes: int | None = None, padding=0):
    """``F.conv2d`` on NCHW float32 ``x`` and OIHW ``weight`` at ``passes``
    bf16 passes, bias added in float32; ``passes`` None is IEEE float32."""
    if passes is not None:
        x, weight = pass_operands(x, weight, passes, 1, 1)
    return F.conv2d(x, weight, bias, padding=padding)


def conv_transpose2d(x, weight, bias=None, passes: int | None = None, stride=2):
    """``F.conv_transpose2d`` on NCHW float32 ``x`` and (Cin, Cout, kh, kw)
    ``weight`` at ``passes`` bf16 passes, bias added in float32; ``passes``
    None is IEEE float32."""
    if passes is not None:
        x, weight = pass_operands(x, weight, passes, 1, 0)
    return F.conv_transpose2d(x, weight, bias, stride=stride)
