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
3 passes ``+ x_hi w_lo`` (``ops/passes.py``). bfloat16 ``x`` with
``passes`` is the conv of its exact float32 value at those passes, with a
float32 result: exactly ``conv3x3_bias_act(x.float(), ..., passes=p)``
(the split of a bf16 value is ``x_hi = x``, ``x_lo = 0``), for Cout up to
``NARROW_COUT`` (the composed top's convs on the bf16 trunk); at any other
Cout it raises. bfloat16 without ``passes`` is one native pass with a
bfloat16 result.

Two implementations of that one function:

  * ``conv3x3_bias_act`` on a CUDA tensor launches kernel K3
    (``csrc/conv.cu``), one of its five kernels as ``k3_variant`` routes
    the call, by dtype, Cin, Cout and whether it names its ``passes``:
      - "wide" (bfloat16): an implicit GEMM with ``wgmma`` fed by TMA. It
        takes bf16 operands (``kernel_operands``): Cin padded with zeros to
        a multiple of 16 and the weights re-laid as (9, Cout, Cin_p).
      - "wide_f32" (float32 that neither narrow variant takes: the trunk
        of every f32-storage serving mode and of training at a pass
        count): reads x in place at its strides, one float32 halo a chunk
        of 64 input channels, splits it on chip into bf16 buffers that all
        9 taps read, and runs ``wgmma`` with A in registers on a persistent
        grid; one small kernel a call splits the weights into the (9,
        Cout, Cin_p) bf16 hi (and lo at 3 passes) that it reads by TMA
        (``wide_f32_weights_plain``).
      - "narrow" (float32 with Cout <= 8: the composed top's convs on
        float32 storage, the last conv in training, the narrow models'
        convs): reads x in place at its strides (the NHWC views the model
        hands it, of K3's own NHWC output in every serving mode or of NCHW
        memory, or any other layout), splits it in registers and runs
        ``mma.sync`` m16n8k16 over 8 output channels; one small kernel a
        call splits the weights into its fragments.
      - "narrow_bf16" (bfloat16 with ``passes``, Cout <= 8): the narrow
        variant's products on x's float32 value less its ``x_lo`` ones,
        which are zero, with x read as bf16 where it lies by TMA and no
        split of x at all; the weights' fragments as the narrow variant
        splits them. A view TMA cannot take (C not contiguous, strides or
        base not 16-byte multiples) runs the narrow variant on
        ``x.float()`` instead.
      - "narrow_k" (float32 with Cin <= 4 and 8 < Cout <= 64: the first
        convs, 3->64 and the channel modes' 1/2/4->64, and the last conv's
        dx in training, 1->64): reads x in place at its strides as the
        narrow variant does, packs taps x channels into K (9 Cin padded to
        a multiple of 16, not 16 a tap), splits x in registers and runs
        ``mma.sync`` m16n8k16 over up to 64 output channels on a persistent
        grid that stores the output from registers; one small kernel a call
        splits the weights into its fragments (``narrow_k_fragments_plain``).
  * ``conv3x3_bias_act_plain``: ``F.conv2d`` on permuted tensors (for
    float32 over the channel-concatenated split operands of its passes,
    ``ops.passes.pass_operands``, whose products are exact in float32;
    bfloat16 with ``passes`` the same on ``x.float()``), then bias and
    activation. The wrapper runs it for a CPU tensor; on the
    card it is the yardstick K3 is held against and nothing else.

The UNet's float32 and bfloat16 paths run their convs through ``F.conv2d``,
as the JAX UNet runs them through XLA; its serving modes run every 3x3 conv
that has a pass count through ``conv3x3_bias_act`` (``models/unet.py``),
the composed top's two on the bf16 trunk (``mixed``, ``balanced16``) on
its bfloat16 activations as they lie.
``LAUNCHES`` counts kernel launches: ``k3`` the conv (any dtype, any
variant), ``k3_p1``, ``k3_p2`` and ``k3_p3`` its launches with a pass count
(float32, and bfloat16 with ``passes``), ``k3_wide_f32``, ``k3_narrow``,
``k3_narrow_k`` and ``k3_narrow_bf16`` those of the four kernels that take
one, ``k3_split`` the splits of their weights (one a call with a pass
count; x is split on chip, never by a launch of its own);
``k3_bf16_upcast`` the bfloat16 calls with ``passes`` that ran the narrow
variant on ``x.float()`` because TMA could not take x's view (counted in
``k3_narrow`` too).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from resdepth_tpu_torch.ops import build, passes as pass_ops

LAUNCHES = {"k3": 0, "k3_p1": 0, "k3_p2": 0, "k3_p3": 0, "k3_split": 0, "k3_narrow": 0,
            "k3_narrow_k": 0, "k3_wide_f32": 0, "k3_narrow_bf16": 0, "k3_bf16_upcast": 0}

LRELU_SLOPE = 0.01
_ACT_CODES = {"relu": 1, "lrelu": 2, "prelu": 3}   # any other name: identity
_DTYPES = (torch.float32, torch.bfloat16)
CIN_ALIGN = 16     # TMA's 16-byte strides and wgmma's K step of 16
NARROW_COUT = 8    # the narrow variants' mma N: calls up to this Cout
# the narrow_k variant: float32 calls with Cin up to NARROW_K_CIN (K = 9 Cin
# packed) and Cout up to NARROW_K_COUT (8 n8 tiles), above NARROW_COUT
NARROW_K_CIN, NARROW_K_COUT = 4, 64

_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# conv3x3_k3_wide_f32, conv3x3_k3_narrow, conv3x3_k3_narrow_k and
# conv3x3_k3_narrow_bf16: x and its 4 strides, the weights and theirs,
# scratch, bias, slopes, out, N H W Cin Cout act passes, the stream
NARROW_ARGTYPES = ([_PTR] + [_LONG] * 4 + [_PTR] + [_LONG] * 4 + [_PTR] * 4 + [_INT] * 7
                   + [_PTR])


@functools.cache
def _library() -> ctypes.CDLL:
    """The built conv library with its entry points typed (once)."""
    lib = build.load("conv")
    lib.conv3x3_k3.argtypes = [_PTR] * 5 + [_INT] * 6 + [_PTR]
    lib.conv3x3_k3.restype = ctypes.c_int
    lib.conv3x3_k3_narrow.argtypes = NARROW_ARGTYPES
    lib.conv3x3_k3_narrow.restype = ctypes.c_int
    lib.conv3x3_k3_narrow_k.argtypes = NARROW_ARGTYPES
    lib.conv3x3_k3_narrow_k.restype = ctypes.c_int
    lib.conv3x3_k3_wide_f32.argtypes = NARROW_ARGTYPES
    lib.conv3x3_k3_wide_f32.restype = ctypes.c_int
    lib.conv3x3_k3_narrow_bf16.argtypes = NARROW_ARGTYPES
    lib.conv3x3_k3_narrow_bf16.restype = ctypes.c_int
    lib.conv_error_string.argtypes = [ctypes.c_int]
    lib.conv_error_string.restype = ctypes.c_char_p
    return lib


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


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
    split every float32 kernel of K3 makes of its operands."""
    pad = (cols_p or t.shape[-1]) - t.shape[-1]
    return tuple(F.pad(v.to(torch.bfloat16), (0, pad)) for v in pass_ops.split(t))


def narrow_fragments_plain(kernel: torch.Tensor) -> torch.Tensor:
    """The narrow variant's weight operands, the plain version of
    ``csrc/conv.cu::split_hi_lo_fragments_kernel``: the weights (3, 3, Cin,
    Cout <= 8) split into bf16 hi and lo and laid out as the B fragments of
    ``mma.sync`` m16n8k16, int32 (ceil(Cin / 16), 9, 32, 4). For chunk,
    tap and lane, at output channel ``o = lane // 4`` and input channel
    ``c = 16 chunk + 2 (lane % 4)``: hi of (c, c + 1), hi of (c + 8, c + 9),
    lo of (c, c + 1), lo of (c + 8, c + 9), each pair of bf16 bits with the
    first in the low half; zeros past Cin and Cout."""
    c_in, c_out = kernel.shape[2], kernel.shape[3]
    n_chunks = -(-c_in // CIN_ALIGN)
    w = F.pad(kernel.float().reshape(9, c_in, c_out),
              (0, NARROW_COUT - c_out, 0, n_chunks * CIN_ALIGN - c_in))
    lane = torch.arange(32)
    o = lane // 4
    c = torch.arange(n_chunks)[:, None] * CIN_ALIGN + 2 * (lane % 4)

    def pair(half, offset):       # -> (n_chunks, 9, 32) int32
        bits = [half[:, c + offset + e, o].view(torch.int16).int() for e in (0, 1)]
        return ((bits[0] & 0xFFFF) | (bits[1] << 16)).transpose(0, 1)

    hi, lo = split_hi_lo_plain(w)
    return torch.stack([pair(hi, 0), pair(hi, 8), pair(lo, 0), pair(lo, 8)], dim=-1)


def narrow_k_steps(c_in: int) -> int:
    """The narrow_k variant's k16 steps: K = 9 Cin packed, padded to a
    multiple of 16 (1 for Cin 1, 2 for Cin 2 and 3, 3 for Cin 4)."""
    return -(-9 * c_in // 16)


def narrow_k_fragments_plain(kernel: torch.Tensor) -> torch.Tensor:
    """The narrow_k variant's weight operands, the plain version of
    ``csrc/conv.cu::split_hi_lo_k_fragments_kernel``: the weights (3, 3,
    Cin <= 4, Cout <= 64) as a (K = 9 Cin, Cout) matrix, row ``k = tap Cin +
    c``, split into bf16 hi and lo and laid out as the B fragments of
    ``mma.sync`` m16n8k16, int32 (``narrow_k_steps(Cin)``, 8, 32, 4). For k
    step, n8 tile and lane, at output channel ``o = 8 tile + lane // 4``
    and ``k = 16 step + 2 (lane % 4)``: hi of (k, k + 1), hi of (k + 8, k +
    9), lo of (k, k + 1), lo of (k + 8, k + 9), each pair of bf16 bits with
    the first in the low half; zeros past 9 Cin and Cout."""
    c_in, c_out = kernel.shape[2], kernel.shape[3]
    steps = narrow_k_steps(c_in)
    w = F.pad(kernel.float().reshape(9 * c_in, c_out),
              (0, NARROW_K_COUT - c_out, 0, 16 * steps - 9 * c_in))
    lane = torch.arange(32)
    o = torch.arange(NARROW_K_COUT // 8)[:, None] * 8 + lane // 4        # (8, 32)
    k = torch.arange(steps)[:, None, None] * 16 + 2 * (lane % 4)         # (steps, 1, 32)

    def pair(half, offset):       # -> (steps, 8, 32) int32
        bits = [half[k + offset + e, o].view(torch.int16).int() for e in (0, 1)]
        return (bits[0] & 0xFFFF) | (bits[1] << 16)

    hi, lo = split_hi_lo_plain(w)
    return torch.stack([pair(hi, 0), pair(hi, 8), pair(lo, 0), pair(lo, 8)], dim=-1)


def wide_f32_weights_plain(kernel: torch.Tensor, n_passes: int):
    """The wide_f32 variant's weight operands, the plain version of
    ``csrc/conv.cu::split_hi_lo_weights_kernel``: the weights (3, 3, Cin,
    Cout) re-laid as (9, Cout, Cin_p), K-major, Cin zero-padded to a
    multiple of 16, split into bf16 ``(hi, lo)``; ``lo`` None below 3
    passes (no pass reads it)."""
    c_in, c_out = kernel.shape[2], kernel.shape[3]
    c_in_p = -(-c_in // CIN_ALIGN) * CIN_ALIGN
    hi, lo = split_hi_lo_plain(kernel.float().reshape(9, c_in, c_out).transpose(1, 2), c_in_p)
    return hi, lo if n_passes == 3 else None


def pass_count(x, passes) -> int:
    """The bf16 passes a call runs: ``passes`` where given (float32, or
    bfloat16 at its exact float32 value); else 3 for float32 and one
    native pass for bfloat16. Other values raise."""
    if passes is None:
        return 3 if x.dtype == torch.float32 else 1
    if passes not in pass_ops.PASSES:
        raise ValueError(f"passes must be one of {pass_ops.PASSES}, got {passes!r}")
    return passes


def conv3x3_bias_act_plain(x, kernel, bias=None, act_param=None, *,
                           act_fn="relu", passes=None):
    """The plain version: ``F.conv2d`` (cuDNN on the card) on the NCHW view
    of ``x``, then bias and activation in float32, cast to ``x.dtype``. For
    float32 the conv runs over the split operands of its passes, so it sums
    the same exact products as K3 and the TPU kernel, in another order;
    bfloat16 with ``passes`` is that on ``x.float()``."""
    n_passes = pass_count(x, passes)
    if x.dtype != torch.float32 and passes is not None:
        k3_variant(x.dtype, x.shape[3], kernel.shape[3], passes)   # raises past NARROW_COUT
        return conv3x3_bias_act_plain(x.float(), kernel, bias, act_param, act_fn=act_fn,
                                      passes=passes)
    b, a = _epilogue_vectors(x, kernel, bias, act_param)
    if x.dtype == torch.float32:
        xs, ws = pass_ops.pass_operands(x, kernel, n_passes, 3, 2)
    else:
        xs, ws = x, kernel.to(x.dtype)
    weight = ws.permute(3, 2, 0, 1)                          # HWIO -> OIHW
    y = F.conv2d(xs.permute(0, 3, 1, 2), weight, padding=1).permute(0, 2, 3, 1)
    return _activate(y.float() + b, act_fn, a).to(x.dtype)


def kernel_operands(x, kernel):
    """The bf16 operands the wide kernel reads: ``(x_p, w_p)``, x as (N, H,
    W, Cin_p) and the weights as (9, Cout, Cin_p), K-major, with Cin
    zero-padded to a multiple of 16 (bfloat16 ``x``; float32 calls go to
    the float32 kernels, which read x where it lies)."""
    c_in = x.shape[3]
    pad = -(-c_in // CIN_ALIGN) * CIN_ALIGN - c_in
    # (3, 3, Cin, Cout) -> (9, Cout, Cin): one small copy a call
    w9 = kernel.to(device=x.device, dtype=x.dtype).reshape(9, c_in, -1).transpose(1, 2)
    x_p = F.pad(x, (0, pad)) if pad else x.contiguous()
    if x_p.data_ptr() % 16:                  # TMA needs 16-byte aligned bases
        x_p = x_p.clone()
    return x_p, F.pad(w9, (0, pad)).contiguous()


def _check_cuda_args(x, kernel) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA tensors (CPU tensors run the plain "
                         f"version), got a tensor on {x.device}")
    if x.dtype not in _DTYPES:
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


def k3_variant(dtype, c_in: int, c_out: int, passes=None) -> str:
    """The K3 kernel a call on the card launches: "narrow" for float32 with
    at most ``NARROW_COUT`` output channels, "narrow_k" for float32 with at
    most ``NARROW_K_CIN`` input and ``NARROW_K_COUT`` output channels,
    "wide_f32" for every other float32 call; for bfloat16, "wide" without
    ``passes`` (one native pass, a bf16 result) and "narrow_bf16" with them
    (the conv of x's exact float32 value at those passes, a float32 result),
    which takes at most ``NARROW_COUT`` output channels: past them it
    raises."""
    if dtype != torch.float32:
        if passes is None:
            return "wide"
        if c_out > NARROW_COUT:
            raise ValueError(f"bfloat16 x with passes takes at most {NARROW_COUT} output "
                             f"channels (the narrow_bf16 kernel), got Cout {c_out}")
        return "narrow_bf16"
    if c_out <= NARROW_COUT:
        return "narrow"
    if c_in <= NARROW_K_CIN and c_out <= NARROW_K_COUT:
        return "narrow_k"
    return "wide_f32"


def conv3x3_bias_act(x, kernel, bias=None, act_param=None, *, act_fn="relu",
                     passes=None):
    """Same-padded 3x3 conv + bias + activation (contract in the module
    docstring). A CPU tensor runs the plain version; a CUDA tensor launches
    K3's variant for its dtype, Cin, Cout and passes (``k3_variant``) or
    raises."""
    if x.device.type == "cpu":
        return conv3x3_bias_act_plain(x, kernel, bias, act_param, act_fn=act_fn,
                                      passes=passes)
    n_passes = pass_count(x, passes)
    _check_cuda_args(x, kernel)
    b, a = _epilogue_vectors(x, kernel, bias, act_param)
    variant = k3_variant(x.dtype, x.shape[3], kernel.shape[3], passes)
    if variant == "wide":
        return _launch_wide(x, kernel, b, a, act_fn)
    if variant == "narrow_bf16" and not tma_takes_bf16(x):
        y = _launch_in_place("narrow", x.float(), kernel, b, a, act_fn, n_passes)
        LAUNCHES["k3_bf16_upcast"] += 1
        return y
    return _launch_in_place(variant, x, kernel, b, a, act_fn, n_passes)


def tma_takes_bf16(x) -> bool:
    """Whether the narrow_bf16 kernel's TMA map takes bfloat16 ``x`` (N, H,
    W, C) where it lies: C contiguous, the other strides and the base
    16-byte multiples."""
    sn, sh, sw, sc = x.stride()
    return sc == 1 and sn % 8 == sh % 8 == sw % 8 == 0 and x.data_ptr() % 16 == 0


def _launch_wide(x, kernel, b, a, act_fn):
    """K3's wide kernel on checked bfloat16 arguments
    (``conv3x3_bias_act``), with ``b`` and ``a`` the epilogue vectors."""
    x_p, w_p = kernel_operands(x, kernel)
    n, h, w, c_in_p = x_p.shape
    c_out = kernel.shape[3]
    out = torch.empty((n, h, w, c_out), dtype=x.dtype, device=x.device)
    lib = _library()
    code = lib.conv3x3_k3(x_p.data_ptr(), w_p.data_ptr(), b.data_ptr(), a.data_ptr(),
                          out.data_ptr(), n, h, w, c_in_p, c_out, _ACT_CODES.get(act_fn, 0),
                          _stream(x))
    if code != 0:
        raise RuntimeError(f"conv kernel K3 failed to launch: "
                           f"{lib.conv_error_string(code).decode()}")
    LAUNCHES["k3"] += 1
    return out


def _fragment_bytes(variant: str, c_in: int, c_out: int, n_passes: int) -> int:
    """Scratch for a call's split weights: 512 bytes a tap and chunk of 16
    input channels (narrow and narrow_bf16, ``narrow_fragments_plain``),
    4096 a k16 step (narrow_k, ``narrow_k_fragments_plain``), or the (9,
    Cout, Cin_p) bf16 hi, and lo at 3 passes (wide_f32,
    ``wide_f32_weights_plain``)."""
    if variant in ("narrow", "narrow_bf16"):
        return -(-c_in // CIN_ALIGN) * 9 * 512
    if variant == "narrow_k":
        return narrow_k_steps(c_in) * 4096
    return 9 * c_out * -(-c_in // CIN_ALIGN) * CIN_ALIGN * 2 * (2 if n_passes == 3 else 1)


def _launch_in_place(variant, x, kernel, b, a, act_fn, n_passes):
    """K3's wide_f32, narrow, narrow_k or narrow_bf16 kernel (``variant``)
    on checked arguments (float32 x, bfloat16 for narrow_bf16): x and the
    weights handed over at their strides, as they lie; scratch for the
    weights' split and the contiguous float32 output allocated here. The
    entry splits the weights, then launches the conv: one ``k3_split`` and
    one conv launch."""
    n, h, w, c_in = x.shape
    c_out = kernel.shape[3]
    weights = kernel.to(device=x.device, dtype=torch.float32)
    frags = torch.empty(_fragment_bytes(variant, c_in, c_out, n_passes), dtype=torch.uint8,
                        device=x.device)
    out = torch.empty((n, h, w, c_out), dtype=torch.float32, device=x.device)
    lib = _library()
    code = getattr(lib, f"conv3x3_k3_{variant}")(
        x.data_ptr(), *x.stride(), weights.data_ptr(), *weights.stride(), frags.data_ptr(),
        b.data_ptr(), a.data_ptr(), out.data_ptr(), n, h, w, c_in, c_out,
        _ACT_CODES.get(act_fn, 0), n_passes, _stream(x))
    if code != 0:
        raise RuntimeError(f"conv kernel K3 failed to launch ({variant} variant): "
                           f"{lib.conv_error_string(code).decode()}")
    for key in ("k3", f"k3_p{n_passes}", f"k3_{variant}", "k3_split"):
        LAUNCHES[key] += 1
    return out
