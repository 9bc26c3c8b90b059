"""Fused same-padded 3x3 conv + bias + activation, NHWC: kernel K3.

Port of ``resdepth_tpu/ops/pallas_conv.py::conv3x3_bias_act``, with its
contract: ``x`` (N, H, W, Cin) float32 or bfloat16, ``kernel`` (3, 3, Cin,
Cout) cast to ``x.dtype``, ``bias`` and the prelu slopes ``act_param``
(Cout,) in float32 added to a float32 accumulator (None reads as zeros),
``act_fn`` one of relu, lrelu (slope 0.01), prelu (per channel) or any other
name for identity; the result is (N, H, W, Cout) in ``x.dtype``.

Two implementations of that one function:

  * ``conv3x3_bias_act`` on a CUDA tensor launches kernel K3
    (``csrc/conv.cu``): IEEE fp32 FMAs for float32, bf16 loads with float32
    accumulation for bfloat16.
  * ``conv3x3_bias_act_plain``: ``F.conv2d`` on permuted tensors, then bias
    and activation. The wrapper runs it for a CPU tensor; on the card it is
    the yardstick K3 is held against and nothing else.

Like the JAX function, K3 is not on the UNet's path (``models/unet.py``
runs its convs through ``F.conv2d``, as the JAX UNet runs them through
XLA). ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from resdepth_tpu_torch.ops import build

LAUNCHES = {"k3": 0}

LRELU_SLOPE = 0.01
_ACT_CODES = {"relu": 1, "lrelu": 2, "prelu": 3}   # any other name: identity
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    """The built conv library with its entry point typed (once)."""
    lib = build.load("conv")
    lib.conv3x3_k3.argtypes = [_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT,
                               _INT, _INT, _INT, _INT, _PTR]
    lib.conv3x3_k3.restype = ctypes.c_int
    lib.conv_error_string.argtypes = [ctypes.c_int]
    lib.conv_error_string.restype = ctypes.c_char_p
    return lib


def _epilogue_vectors(x, kernel, bias, act_param):
    """Bias and prelu slopes as float32 (Cout,) vectors on ``x``'s device,
    zeros where None (as ``pallas_conv.py`` builds them)."""
    c_out = kernel.shape[3]
    zeros = torch.zeros(c_out, dtype=torch.float32, device=x.device)
    b = zeros if bias is None else bias.to(device=x.device, dtype=torch.float32)
    a = zeros if act_param is None else act_param.to(device=x.device,
                                                     dtype=torch.float32)
    return b, a


def _activate(v, act_fn, act_param):
    if act_fn == "relu":
        return torch.clamp_min(v, 0.0)
    if act_fn == "lrelu":
        return torch.where(v >= 0, v, LRELU_SLOPE * v)
    if act_fn == "prelu":
        return torch.where(v >= 0, v, act_param * v)
    return v


def conv3x3_bias_act_plain(x, kernel, bias=None, act_param=None, *,
                           act_fn="relu"):
    """The plain version: ``F.conv2d`` (cuDNN on the card) on the NCHW view
    of ``x``, then bias and activation in float32, cast to ``x.dtype``."""
    b, a = _epilogue_vectors(x, kernel, bias, act_param)
    weight = kernel.to(x.dtype).permute(3, 2, 0, 1)          # HWIO -> OIHW
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=1).permute(0, 2, 3, 1)
    return _activate(y.float() + b, act_fn, a).to(x.dtype)


def _check_cuda_args(x, kernel) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA tensors (CPU tensors run the plain "
                         f"version), got a tensor on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"K3 takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or kernel.dim() != 4 or tuple(kernel.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"expected x (N, H, W, Cin) and kernel (3, 3, Cin, Cout), "
                         f"got {tuple(x.shape)} and {tuple(kernel.shape)}")
    if kernel.device != x.device:
        raise ValueError(f"kernel is on {kernel.device}, x on {x.device}")
    if not 0 < x.shape[0] < 65536:
        raise ValueError(f"batch of {x.shape[0]}: K3 takes 1 to 65535 images")
    if min(x.shape[1:]) < 1 or kernel.shape[3] < 1:
        raise ValueError("K3 needs non-empty images and channels")


def conv3x3_bias_act(x, kernel, bias=None, act_param=None, *, act_fn="relu"):
    """Same-padded 3x3 conv + bias + activation (contract in the module
    docstring). A CPU tensor runs the plain version; a CUDA tensor launches
    K3 or raises."""
    if x.device.type == "cpu":
        return conv3x3_bias_act_plain(x, kernel, bias, act_param, act_fn=act_fn)
    _check_cuda_args(x, kernel)
    b, a = _epilogue_vectors(x, kernel, bias, act_param)
    xc = x.contiguous()
    kc = kernel.to(x.dtype).contiguous()
    n, h, w, c_in = xc.shape
    c_out = kc.shape[3]
    out = torch.empty((n, h, w, c_out), dtype=x.dtype, device=x.device)
    lib = _library()
    code = lib.conv3x3_k3(
        xc.data_ptr(), kc.data_ptr(), b.data_ptr(), a.data_ptr(), out.data_ptr(),
        n, h, w, c_in, c_out, _ACT_CODES.get(act_fn, 0), _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"conv kernel K3 failed to launch: "
                           f"{lib.conv_error_string(code).decode()}")
    LAUNCHES["k3"] += 1
    return out
