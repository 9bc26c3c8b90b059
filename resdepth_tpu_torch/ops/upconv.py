"""One pass for a float32 decoder level's upsampling and skip add:
``transposed2x2_skip_kernel`` (``csrc/upconv.cu``).

``upconv2x2_skip(x, weight, bias, skip, passes)``: x (N, H, W, Cin) and
skip (N, 2H, 2W, Cout) float32 in NHWC memory, the ``nn.ConvTranspose2d``
weight (Cin, Cout, 2, 2) and bias (Cout,) (or None), ``passes`` 1, 2 or 3
-> (N, 2H, 2W, Cout) float32 NHWC,

    out[n, 2i+a, 2j+b, o] = skip[n, 2i+a, 2j+b, o]
                            + (sum_c x[n, i, j, c] w[c, o, a, b] + bias[o])

with the products of ``ops.passes``' bf16 passes (1: ``x_hi w_hi``; 2:
``+ x_lo w_hi``; 3: ``+ x_hi w_lo``), summed in float32, and the two
roundings of the chain it replaces in its order: the sum plus the bias, then
plus the skip. Only the sum order of the products differs from that chain.

Two implementations:

  * a CUDA tensor launches the kernel (one small launch that splits the
    weights, then the upconv, into a new output tensor) or raises (device,
    dtype, shape, NHWC contiguity; no copy, no fallback);
  * a CPU tensor runs the plain version (``upconv2x2_skip_plain``): ``skip
    + ops.passes.conv_transpose2d(x, weight, bias, passes)`` on the NCHW
    views, the decoder's chain before the kernel, which on the card is the
    yardstick the kernel is held to.

``models/unet.py`` runs it at each eval decoder level of float32 storage
whose upconv has a pass count and needs no gradient. ``LAUNCHES`` counts
kernel launches: ``upconv`` the upconv, ``upconv_p1`` .. ``upconv_p3`` by
pass count, ``upconv_split`` the weights' splits (one a call).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from resdepth_tpu_torch.ops import build, passes as pass_ops

LAUNCHES = {"upconv": 0, "upconv_p1": 0, "upconv_p2": 0, "upconv_p3": 0, "upconv_split": 0}

_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# x, the weights and their 4 strides, bias, skip, scratch, out, N H W Cin
# Cout passes, the stream
_ARGTYPES = [_PTR] * 2 + [_LONG] * 4 + [_PTR] * 4 + [_INT] * 6 + [_PTR]
_MAX_PIXELS = 2 ** 31 - 1   # the kernel indexes x's pixels in 32 bits


@functools.cache
def _library() -> ctypes.CDLL:
    """The built upconv library with its entry point typed (once)."""
    lib = build.load("upconv")
    lib.upconv2x2_skip.argtypes = _ARGTYPES
    lib.upconv2x2_skip.restype = ctypes.c_int
    lib.upconv_error_string.argtypes = [ctypes.c_int]
    lib.upconv_error_string.restype = ctypes.c_char_p
    return lib


def _check_args(x, weight, bias, skip, passes) -> None:
    if passes not in pass_ops.PASSES:
        raise ValueError(f"passes must be one of {pass_ops.PASSES}, got {passes!r}")
    for name, t in (("x", x), ("weight", weight), ("skip", skip)):
        if t.dtype != torch.float32:
            raise ValueError(f"the upconv takes float32 {name}, got {t.dtype}")
    if x.dim() != 4 or weight.dim() != 4 or weight.shape[0] != x.shape[3] \
            or tuple(weight.shape[2:]) != (2, 2):
        raise ValueError(f"expected x (N, H, W, Cin) and weight (Cin, Cout, 2, 2), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    n, h, w, _ = x.shape
    c_out = weight.shape[1]
    if tuple(skip.shape) != (n, 2 * h, 2 * w, c_out):
        raise ValueError(f"skip must have shape {(n, 2 * h, 2 * w, c_out)}, got "
                         f"{tuple(skip.shape)}")
    if bias is not None and tuple(bias.shape) != (c_out,):
        raise ValueError(f"bias must have shape ({c_out},), got {tuple(bias.shape)}")


def upconv2x2_skip_plain(x, weight, bias, skip, passes: int):
    """The plain version of ``upconv2x2_skip``: the decoder's ops before the
    kernel, on the NCHW views of the NHWC arguments."""
    _check_args(x, weight, bias, skip, passes)
    y = pass_ops.conv_transpose2d(x.permute(0, 3, 1, 2), weight, bias, passes)
    return (skip.permute(0, 3, 1, 2) + y).permute(0, 2, 3, 1)


def check_layout(t: torch.Tensor, name: str) -> None:
    """Raise unless ``t`` (N, H, W, C) lies in contiguous NHWC memory, the
    only layout the kernel reads and writes (no copy is made)."""
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (N, H, W, C), NHWC memory, for the "
                         f"upconv kernel, got strides {t.stride()} for shape {tuple(t.shape)}")


def _check_cuda_args(x, weight, bias, skip) -> None:
    """The kernel's own demands: CUDA tensors on one device, x and skip in
    contiguous NHWC memory, a non-empty map of under 2^31 pixels."""
    if x.device.type != "cuda":
        raise ValueError(f"the upconv kernel runs on CUDA tensors (CPU tensors run the plain "
                         f"version), got a tensor on {x.device}")
    for name, t in (("weight", weight), ("bias", bias), ("skip", skip)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    check_layout(x, "x")
    check_layout(skip, "skip")
    n, h, w, _ = x.shape
    if x.numel() == 0 or weight.shape[1] == 0:
        raise ValueError(f"the upconv kernel needs a non-empty map, got {tuple(x.shape)} and "
                         f"weight {tuple(weight.shape)}")
    if n * h * w > _MAX_PIXELS:
        raise ValueError(f"{tuple(x.shape)} is too large for one upconv launch "
                         f"({n * h * w} pixels; at most {_MAX_PIXELS})")


def scratch_bytes(c_in: int, c_out: int, passes: int) -> int:
    """Scratch for a call's split weights and bias: the (4 Cout, Cin_p)
    bf16 hi, and lo at 3 passes (Cin_p = Cin rounded up to 16), then the
    bias by the rows, 4 Cout float32."""
    c_in_p = -(-c_in // 16) * 16
    return 4 * c_out * c_in_p * 2 * (2 if passes == 3 else 1) + 4 * c_out * 4


def upconv2x2_skip(x, weight, bias, skip, passes: int):
    """``skip`` plus the 2x2 stride-2 transposed conv of ``x`` at
    ``passes`` bf16 passes (module docstring). A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return upconv2x2_skip_plain(x, weight, bias, skip, passes)
    _check_args(x, weight, bias, skip, passes)
    _check_cuda_args(x, weight, bias, skip)
    n, h, w, c_in = x.shape
    c_out = weight.shape[1]
    b = None if bias is None else bias.to(dtype=torch.float32).contiguous()
    scratch = torch.empty(scratch_bytes(c_in, c_out, passes), dtype=torch.uint8,
                          device=x.device)
    out = torch.empty((n, 2 * h, 2 * w, c_out), dtype=torch.float32, device=x.device)
    lib = _library()
    code = lib.upconv2x2_skip(x.data_ptr(), weight.data_ptr(), *weight.stride(),
                              None if b is None else b.data_ptr(), skip.data_ptr(),
                              scratch.data_ptr(), out.data_ptr(), n, h, w, c_in, c_out, passes,
                              torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"upconv kernel failed to launch: "
                           f"{lib.upconv_error_string(code).decode()}")
    for key in ("upconv", f"upconv_p{passes}", "upconv_split"):
        LAUNCHES[key] += 1
    return out
