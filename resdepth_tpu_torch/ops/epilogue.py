"""One pass for the bf16 trunk's epilogue after each conv:
``trunk_epilogue_kernel`` (``csrc/epilogue.cu``).

On the bf16 trunk of an eval forward (``models/unet.py``: the serving
modes ``mixed`` and ``balanced16``, and bfloat16 compute on float32
weights) each conv's output takes a few elementwise maps before the next
conv reads it. This module computes them in one pass, with the roundings of
the separate ops they replace:

  * ``trunk_epilogue(y, bias, slope, act_fn=, pool=) -> (skip, pooled)``:
      - ``y`` bfloat16, a conv's raw output: ``skip = act(bf16(y +
        bf16(bias)))``, with ``act_fn`` and the (C,) ``slope`` as
        ``ops.conv._activate`` takes them (relu, lrelu at slope 0.01,
        prelu, any other name the identity) and ``bias`` (C,) or None;
      - ``y`` float32 (a K3 output with its bias and activation applied):
        ``skip = bf16(y)``, no bias and no activation;
    with ``pool``, ``pooled`` is the 2x2 stride-2 max-pool of ``skip``
    (``nn.MaxPool2d(2, 2)``: NaN propagates, an odd last row or column is
    dropped), else None.
  * ``skip_add_epilogue(u, bias, skip)``: ``bf16(skip + bf16(u +
    bf16(bias)))``: an upsampling's raw bfloat16 output, its bias and the
    decoder's additive skip.

Tensors are NCHW-shaped, as the UNet holds them; on the card in channels-
last memory (NHWC), as cuDNN and K3 hand them over. Two implementations:

  * a CUDA tensor launches the kernel (one launch a call, into new output
    tensors) or raises (device, dtype, shape, channels-last contiguity);
  * a CPU tensor runs the plain version (``trunk_epilogue_plain``,
    ``skip_add_epilogue_plain``): the separate ATen ops the kernel fuses,
    which on the card are the yardstick the kernel is held to, bitwise.

``LAUNCHES["epilogue"]`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from resdepth_tpu_torch.ops import build
from resdepth_tpu_torch.ops.conv import _ACT_CODES, _activate

LAUNCHES = {"epilogue": 0}

_MODES = {"block": 0, "cast": 1, "skip": 2}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# mode act pool vec, in skip bias slope out pooled, N H W C, the stream
_ARGTYPES = [_INT] * 4 + [_PTR] * 6 + [_INT] * 4 + [_PTR]
_MAX_ITEMS = 2 ** 31 - 1   # the kernel indexes its items in 32 bits


@functools.cache
def _library() -> ctypes.CDLL:
    """The built epilogue library with its entry point typed (once)."""
    lib = build.load("epilogue")
    lib.trunk_epilogue.argtypes = _ARGTYPES
    lib.trunk_epilogue.restype = ctypes.c_int
    lib.epilogue_error_string.argtypes = [ctypes.c_int]
    lib.epilogue_error_string.restype = ctypes.c_char_p
    return lib


def trunk_epilogue_plain(y, bias=None, slope=None, *, act_fn="none", pool=False):
    """The plain version of ``trunk_epilogue``: the separate ops, in the
    order and dtype they ran before the kernel fused them."""
    _check_args(y, bias, slope, act_fn)
    if y.dtype == torch.float32:
        skip = y.to(torch.bfloat16)
    else:
        skip = y if bias is None else y + bias.to(y.dtype).view(-1, 1, 1)
        skip = _activate(skip, act_fn, None if slope is None else slope.view(-1, 1, 1))
    return skip, F.max_pool2d(skip, 2, 2) if pool else None


def skip_add_epilogue_plain(u, bias, skip):
    """The plain version of ``skip_add_epilogue``: the bias add, then the
    skip add, each a bfloat16 op."""
    _check_skip_args(u, bias, skip)
    return skip + (u if bias is None else u + bias.to(u.dtype).view(-1, 1, 1))


def _check_vector(name, v, channels) -> None:
    if v is not None and tuple(v.shape) != (channels,):
        raise ValueError(f"{name} must have shape ({channels},), got {tuple(v.shape)}")


def _check_args(y, bias, slope, act_fn) -> None:
    if y.dim() != 4:
        raise ValueError(f"expected y (N, C, H, W), got shape {tuple(y.shape)}")
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the epilogue takes bfloat16 or float32 y, got {y.dtype}")
    if y.dtype == torch.float32 and (bias is not None or act_fn in _ACT_CODES):
        raise ValueError("a float32 y is only cast to the bfloat16 trunk: its conv (K3) "
                         "applies the bias and the activation")
    if act_fn == "prelu" and slope is None:
        raise ValueError("prelu needs its (C,) slopes")
    _check_vector("bias", bias, y.shape[1])
    _check_vector("slope", slope, y.shape[1])


def _check_skip_args(u, bias, skip) -> None:
    if u.dim() != 4 or tuple(skip.shape) != tuple(u.shape):
        raise ValueError(f"expected u and skip of one (N, C, H, W) shape, got "
                         f"{tuple(u.shape)} and {tuple(skip.shape)}")
    if u.dtype != torch.bfloat16 or skip.dtype != torch.bfloat16:
        raise ValueError(f"the skip add takes bfloat16 u and skip, got {u.dtype} "
                         f"and {skip.dtype}")
    _check_vector("bias", bias, u.shape[1])


def check_layout(t: torch.Tensor, name: str) -> None:
    """Raise unless ``t`` lies in channels-last (NHWC) contiguous memory,
    the only layout the kernel reads and writes (no copy is made)."""
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} must be channels-last contiguous (NHWC memory) for the "
                         f"epilogue kernel, got strides {t.stride()} for shape "
                         f"{tuple(t.shape)}")


def _device_vector(v, like):
    """A (C,) bias or slope as a contiguous float32 vector on ``like``'s
    device (the kernel rounds it to bf16 itself), or None."""
    if v is None:
        return None
    return v.to(device=like.device, dtype=torch.float32).contiguous()


def _check_cuda_args(x, skip) -> None:
    """The kernel's own demands: CUDA tensors in channels-last memory."""
    if x.device.type != "cuda":
        raise ValueError(f"the epilogue kernel runs on CUDA tensors (CPU tensors run the "
                         f"plain version), got a tensor on {x.device}")
    if skip is not None and skip.device != x.device:
        raise ValueError(f"skip is on {skip.device}, the input on {x.device}")
    check_layout(x, "the input")
    if skip is not None:
        check_layout(skip, "skip")


def _launch(mode, act_fn, x, skip, bias, slope, out, pooled):
    """Launch the kernel on the current stream on checked arguments: ``x``
    the input (y or u), ``skip`` the skip add's other input or None,
    ``bias`` and ``slope`` float32 vectors on x's device or None, ``out``
    and ``pooled`` (or None) the new outputs. One channel a thread where C
    is not a multiple of 8 or a tensor is not 16-byte aligned."""
    present = [t for t in (x, skip, bias, slope, out, pooled) if t is not None]
    n, c, h, w = x.shape
    if x.numel() == 0:
        raise ValueError(f"the epilogue kernel needs a non-empty map, got {tuple(x.shape)}")
    vec = 8 if c % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in present) else 1
    pixels = n * -(-h // 2) * -(-w // 2) if pooled is not None else n * h * w
    if pixels * (c // vec) > _MAX_ITEMS:
        raise ValueError(f"{tuple(x.shape)} is too large for one epilogue launch "
                         f"({pixels * (c // vec)} items; at most {_MAX_ITEMS})")
    lib = _library()
    ptr = [None if t is None else t.data_ptr() for t in (x, skip, bias, slope, out, pooled)]
    code = lib.trunk_epilogue(_MODES[mode], _ACT_CODES.get(act_fn, 0), int(pooled is not None),
                              vec, *ptr, n, h, w, c,
                              torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"trunk epilogue kernel failed to launch: "
                           f"{lib.epilogue_error_string(code).decode()}")
    LAUNCHES["epilogue"] += 1


def _empty_nhwc(n, c, h, w, like):
    return torch.empty((n, c, h, w), dtype=torch.bfloat16, device=like.device,
                       memory_format=torch.channels_last)


def trunk_epilogue(y, bias=None, slope=None, *, act_fn="none", pool=False):
    """The trunk's value after a conv, and its 2x2 max-pool with ``pool``
    -> ``(skip, pooled or None)``, both bfloat16 (module docstring). A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel or
    raises."""
    if y.device.type == "cpu":
        return trunk_epilogue_plain(y, bias, slope, act_fn=act_fn, pool=pool)
    _check_args(y, bias, slope, act_fn)
    _check_cuda_args(y, None)
    n, c, h, w = y.shape
    skip = _empty_nhwc(n, c, h, w, y)
    pooled = _empty_nhwc(n, c, h // 2, w // 2, y) if pool else None
    mode = "cast" if y.dtype == torch.float32 else "block"
    _launch(mode, act_fn, y, None, _device_vector(bias, y),
            _device_vector(slope, y) if act_fn == "prelu" else None, skip, pooled)
    return skip, pooled


def skip_add_epilogue(u, bias, skip):
    """``skip + (u + bias)`` in bfloat16 (module docstring). A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel or raises."""
    if u.device.type == "cpu":
        return skip_add_epilogue_plain(u, bias, skip)
    _check_skip_args(u, bias, skip)
    _check_cuda_args(u, skip)
    out = _empty_nhwc(*u.shape, u)
    _launch("skip", "none", u, skip, _device_vector(bias, u), None, out, None)
    return out
