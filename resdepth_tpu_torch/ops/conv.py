"""Fused same-padded 3x3 conv + bias + activation, NHWC: kernel K3.

Port of ``resdepth_tpu/ops/pallas_conv.py::conv3x3_bias_act``, with its
contract: ``x`` (N, H, W, Cin) float32 or bfloat16, ``kernel`` (3, 3, Cin,
Cout), ``bias`` and the prelu slopes ``act_param`` (Cout,) in float32 added
to a float32 accumulator (None reads as zeros), ``act_fn`` one of relu,
lrelu (slope 0.01), prelu (per channel) or any other name for identity; the
result is (N, H, W, Cout) in ``x.dtype``. The products are the TPU
kernel's: bfloat16 is one bf16 pass with float32 accumulation; float32 is
the 3-pass bf16 split of ``Precision.HIGH``, ``x = x_hi + x_lo`` and ``w =
w_hi + w_lo`` in bf16, accumulating ``x_hi w_hi + x_hi w_lo + x_lo w_hi`` in
float32. For float32, ``passes`` (default 3) takes the TPU's other MXU
precisions on f32 operands, with a float32 result: 1 pass ``x_hi w_hi``
(``Precision.DEFAULT``), 2 passes ``+ x_lo w_hi`` (``(HIGH, DEFAULT)``),
3 passes ``+ x_hi w_lo`` (``ops/passes.py``). bfloat16 takes no ``passes``.

Two implementations of that one function:

  * ``conv3x3_bias_act`` on a CUDA tensor launches kernel K3
    (``csrc/conv.cu``), an implicit GEMM with ``wgmma`` fed by TMA. It
    hands the kernel bf16 operands (``kernel_operands``): Cin padded with
    zeros to a multiple of 16 and the weights re-laid as (9, Cout, Cin_p);
    for float32 the split kernel of the same source writes the hi halves and
    the lo halves the call's passes read.
  * ``conv3x3_bias_act_plain``: ``F.conv2d`` on permuted tensors (for
    float32 over the channel-concatenated split operands of its passes,
    ``ops.passes.pass_operands``, whose products are exact in float32),
    then bias and activation. The wrapper runs it for a CPU tensor; on the
    card it is the yardstick K3 is held against and nothing else.

The UNet's float32 and bfloat16 paths run their convs through ``F.conv2d``,
as the JAX UNet runs them through XLA; its serving modes run every 3x3 conv
that has a pass count through ``conv3x3_bias_act`` (``models/unet.py``).
``LAUNCHES`` counts kernel launches: ``k3`` the conv (any dtype), ``k3_p1``,
``k3_p2`` and ``k3_p3`` its float32 launches by pass count, ``k3_split`` the
float32 operand split (two a float32 call: x and the weights, each writing
only the halves the passes read).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from resdepth_tpu_torch.ops import build, passes as pass_ops

LAUNCHES = {"k3": 0, "k3_p1": 0, "k3_p2": 0, "k3_p3": 0, "k3_split": 0}

LRELU_SLOPE = 0.01
_ACT_CODES = {"relu": 1, "lrelu": 2, "prelu": 3}   # any other name: identity
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
CIN_ALIGN = 16     # TMA's 16-byte strides and wgmma's K step of 16

_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _library() -> ctypes.CDLL:
    """The built conv library with its entry points typed (once)."""
    lib = build.load("conv")
    lib.conv3x3_k3.argtypes = [_PTR] * 7 + [_INT] * 8 + [_PTR]
    lib.conv3x3_k3.restype = ctypes.c_int
    lib.conv_split_hi_lo.argtypes = [_PTR, _PTR, _PTR, _LONG, _INT, _INT, _PTR]
    lib.conv_split_hi_lo.restype = ctypes.c_int
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
    return b.contiguous(), a.contiguous()


def _activate(v, act_fn, act_param):
    """The activation in ``v``'s dtype (the JAX ``_activation``)."""
    if act_fn == "relu":
        return torch.clamp_min(v, 0.0)
    if act_fn == "lrelu":
        return torch.where(v >= 0, v, LRELU_SLOPE * v)
    if act_fn == "prelu":
        return torch.where(v >= 0, v, act_param.to(v.dtype) * v)
    return v


def split_hi_lo_plain(t: torch.Tensor, cols_p: int | None = None):
    """``t`` (..., C) float32 -> (hi, lo) bf16 with ``hi = bf16(t)`` and
    ``lo = bf16(t - hi)``, the last dimension zero-padded to ``cols_p``: the
    plain version of the split kernel."""
    pad = (cols_p or t.shape[-1]) - t.shape[-1]
    return tuple(F.pad(v.to(torch.bfloat16), (0, pad)) for v in pass_ops.split(t))


def pass_count(x, passes) -> int:
    """The bf16 passes a call runs: ``passes`` (default 3) for float32,
    1 for bfloat16, which takes no ``passes``; other values raise."""
    if x.dtype != torch.float32:
        if passes is not None:
            raise ValueError(f"passes is for float32 inputs; {x.dtype} takes one "
                             f"native pass, got passes={passes!r}")
        return 1
    if passes is None:
        return 3
    if passes not in pass_ops.PASSES:
        raise ValueError(f"passes must be one of {pass_ops.PASSES}, got {passes!r}")
    return passes


def conv3x3_bias_act_plain(x, kernel, bias=None, act_param=None, *,
                           act_fn="relu", passes=None):
    """The plain version: ``F.conv2d`` (cuDNN on the card) on the NCHW view
    of ``x``, then bias and activation in float32, cast to ``x.dtype``. For
    float32 the conv runs over the split operands of its passes, so it sums
    the same exact products as K3 and the TPU kernel, in another order."""
    n_passes = pass_count(x, passes)
    b, a = _epilogue_vectors(x, kernel, bias, act_param)
    if x.dtype == torch.float32:
        xs, ws = pass_ops.pass_operands(x, kernel, n_passes, 3, 2)
    else:
        xs, ws = x, kernel.to(x.dtype)
    weight = ws.permute(3, 2, 0, 1)                          # HWIO -> OIHW
    y = F.conv2d(xs.permute(0, 3, 1, 2), weight, padding=1).permute(0, 2, 3, 1)
    return _activate(y.float() + b, act_fn, a).to(x.dtype)


def _split(t: torch.Tensor, cols_p: int, with_lo: bool = True):
    """The split on ``t``'s device -> ``(hi, lo)``, ``lo`` None unless
    ``with_lo``: the split kernel on CUDA (counted in
    ``LAUNCHES['k3_split']``; it writes only the halves asked for), its
    plain version elsewhere."""
    if t.device.type != "cuda":
        hi, lo = split_hi_lo_plain(t, cols_p)
        return hi, lo if with_lo else None
    src = t.contiguous()
    hi = torch.empty(src.shape[:-1] + (cols_p,), dtype=torch.bfloat16, device=t.device)
    lo = torch.empty_like(hi) if with_lo else None
    lib = _library()
    code = lib.conv_split_hi_lo(src.data_ptr(), hi.data_ptr(),
                                lo.data_ptr() if with_lo else None,
                                src.numel() // src.shape[-1], src.shape[-1], cols_p,
                                torch.cuda.current_stream(t.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"K3's split kernel failed to launch: "
                           f"{lib.conv_error_string(code).decode()}")
    LAUNCHES["k3_split"] += 1
    return hi, lo


def kernel_operands(x, kernel, n_passes: int = 3):
    """The bf16 operands K3 reads at ``n_passes``: ``(x_hi, x_lo, w_hi,
    w_lo)``, x as (N, H, W, Cin_p) and the weights as (9, Cout, Cin_p),
    K-major, with Cin zero-padded to a multiple of 16. A lo half is None
    where no pass reads it: both for bfloat16 and at 1 pass, ``w_lo`` at 2
    passes. For float32 the split runs on ``x``'s device (the split kernel
    on CUDA, once for x and once for the weights)."""
    c_in = x.shape[3]
    c_in_p = -(-c_in // CIN_ALIGN) * CIN_ALIGN
    # (3, 3, Cin, Cout) -> (9, Cout, Cin): one small copy a call
    w9 = kernel.to(device=x.device, dtype=x.dtype).reshape(9, c_in, -1).transpose(1, 2)
    if x.dtype == torch.float32:
        x_hi, x_lo = _split(x, c_in_p, with_lo=n_passes >= 2)
        w_hi, w_lo = _split(w9, c_in_p, with_lo=n_passes == 3)
        return x_hi, x_lo, w_hi, w_lo
    pad = c_in_p - c_in
    x_p = F.pad(x, (0, pad)) if pad else x.contiguous()
    if x_p.data_ptr() % 16:                  # TMA needs 16-byte aligned bases
        x_p = x_p.clone()
    return x_p, None, F.pad(w9, (0, pad)).contiguous(), None


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


def conv3x3_bias_act(x, kernel, bias=None, act_param=None, *, act_fn="relu",
                     passes=None):
    """Same-padded 3x3 conv + bias + activation (contract in the module
    docstring). A CPU tensor runs the plain version; a CUDA tensor launches
    K3 or raises."""
    if x.device.type == "cpu":
        return conv3x3_bias_act_plain(x, kernel, bias, act_param, act_fn=act_fn,
                                      passes=passes)
    n_passes = pass_count(x, passes)
    _check_cuda_args(x, kernel)
    b, a = _epilogue_vectors(x, kernel, bias, act_param)
    x_hi, x_lo, w_hi, w_lo = kernel_operands(x, kernel, n_passes)
    n, h, w, c_in_p = x_hi.shape
    c_out = kernel.shape[3]
    out = torch.empty((n, h, w, c_out), dtype=x.dtype, device=x.device)
    lib = _library()
    code = lib.conv3x3_k3(
        x_hi.data_ptr(), None if x_lo is None else x_lo.data_ptr(), w_hi.data_ptr(),
        None if w_lo is None else w_lo.data_ptr(),
        b.data_ptr(), a.data_ptr(), out.data_ptr(), n, h, w, c_in_p, c_out,
        _ACT_CODES.get(act_fn, 0), _DTYPE_CODES[x.dtype], n_passes,
        torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"conv kernel K3 failed to launch: "
                           f"{lib.conv_error_string(code).decode()}")
    LAUNCHES["k3"] += 1
    if x.dtype == torch.float32:
        LAUNCHES[f"k3_p{n_passes}"] += 1
    return out
