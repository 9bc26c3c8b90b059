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

Training at a pass count (``same_conv``, ``upconv2x2``): autograd through
the split and the concatenation would hand back IEEE-float32 gradients, but
the JAX package's conv transposes keep the forward's precision, so dx and
dw are convs at its passes too. Each of these ``torch.autograd.Function``s
computes them itself:

  * dx of a same-padded conv is the same-padded conv of the cotangent ``g``
    with the weights flipped and their two channel axes swapped: for the
    3x3 conv kernel K3 again (``ops.conv.conv3x3_bias_act``), skipped where
    the input needs no gradient; dx of the 2x2 stride-2 upconv is the
    stride-2 conv of ``g`` with its weights;
  * dw sums the split products of the two operands over the batch: one
    ``torch.nn.grad.conv2d_weight`` over the operands concatenated along
    the batch (``[x_hi]`` against ``[g_hi]`` at 1 pass, ``[x_hi, x_hi,
    x_lo]`` against ``[g_hi, g_lo, g_hi]`` at 3), in JAX's operand order;
  * the bias gradient is the float32 sum of ``g``.
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


def conv2d(x, weight, bias=None, passes: int | None = None, padding=0, stride=1):
    """``F.conv2d`` on NCHW float32 ``x`` and OIHW ``weight`` at ``passes``
    bf16 passes, bias added in float32; ``passes`` None is IEEE float32."""
    if passes is not None:
        x, weight = pass_operands(x, weight, passes, 1, 1)
    return F.conv2d(x, weight, bias, padding=padding, stride=stride)


def conv_transpose2d(x, weight, bias=None, passes: int | None = None, stride=2):
    """``F.conv_transpose2d`` on NCHW float32 ``x`` and (Cin, Cout, kh, kw)
    ``weight`` at ``passes`` bf16 passes, bias added in float32; ``passes``
    None is IEEE float32."""
    if passes is not None:
        x, weight = pass_operands(x, weight, passes, 1, 0)
    return F.conv_transpose2d(x, weight, bias, stride=stride)


def _weight_grad(lhs, rhs, shape, passes: int, **conv_args):
    """The weight gradient ``torch.nn.grad.conv2d_weight(lhs, shape, rhs)``
    at ``passes``: the split products of the two operands, ``lhs`` taking
    the activation's side of ``pass_operands``, concatenated along the
    batch."""
    lhs, rhs = pass_operands(lhs, rhs, passes, 0, 0)
    return torch.nn.grad.conv2d_weight(lhs, shape, rhs, **conv_args)


def _same_conv_forward(x, weight, bias, passes: int):
    """The same-padded conv of NCHW ``x`` with OIHW ``weight`` (3x3 or
    1x1) at ``passes``: a 3x3 conv on kernel K3 (its plain version for a
    CPU tensor), a 1x1 conv through ``conv2d``."""
    if weight.shape[-1] == 1:
        return conv2d(x, weight, bias, passes)
    from resdepth_tpu_torch.ops import conv
    y = conv.conv3x3_bias_act(x.permute(0, 2, 3, 1), weight.permute(2, 3, 1, 0), bias,
                              act_fn="none", passes=passes)
    return y.permute(0, 3, 1, 2)


class _SameConv(torch.autograd.Function):
    """A same-padded 3x3 or 1x1 conv at a pass count, with the gradients
    at that pass count (module docstring)."""

    @staticmethod
    def forward(ctx, x, weight, bias, passes):
        ctx.save_for_backward(x, weight)
        ctx.passes = passes
        return _same_conv_forward(x, weight, bias, passes)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _same_conv_forward(g, weight.flip(2, 3).transpose(0, 1), None, ctx.passes)
        if ctx.needs_input_grad[1]:
            dw = _weight_grad(x, g, weight.shape, ctx.passes,
                              padding=weight.shape[-1] // 2)
        db = g.sum((0, 2, 3)) if ctx.needs_input_grad[2] else None
        return dx, dw, db, None


class _Upconv2x2(torch.autograd.Function):
    """The 2x2 stride-2 transposed conv at a pass count, with the gradients
    of the JAX ``_upconv2x2_bwd`` at that pass count: dx the stride-2 conv
    of ``g`` with the weights, dw ``g`` against ``x`` over the batch."""

    @staticmethod
    def forward(ctx, x, weight, bias, passes):
        ctx.save_for_backward(x, weight)
        ctx.passes = passes
        return conv_transpose2d(x, weight, bias, passes)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv2d(g, weight, None, ctx.passes, stride=2)
        if ctx.needs_input_grad[1]:
            dw = _weight_grad(g, x, weight.shape, ctx.passes, stride=2)
        db = g.sum((0, 2, 3)) if ctx.needs_input_grad[2] else None
        return dx, dw, db, None


def same_conv(x, weight, bias, passes: int):
    """The same-padded 3x3 (on K3) or 1x1 conv of NCHW float32 ``x`` with
    OIHW ``weight`` and ``bias`` (or None) at ``passes`` bf16 passes, its
    dx and dw at ``passes`` too."""
    return _SameConv.apply(x, weight, bias, passes)


def upconv2x2(x, weight, bias, passes: int):
    """``conv_transpose2d`` (2x2, stride 2) at ``passes`` bf16 passes, its
    dx and dw at ``passes`` too."""
    return _Upconv2x2.apply(x, weight, bias, passes)
