"""Port of kernel K3 (resdepth_tpu_torch.ops.conv) against the JAX Pallas
``conv3x3_bias_act`` in interpret mode, as ``tests/test_pallas_conv.py``
runs it.

On the CPU the wrapper runs its plain version (``F.conv2d`` + bias + act),
the yardstick the CUDA kernel is held against on the card
(``chip_smoke.py`` phase 6). Its float32 path is the TPU kernel's 3-pass
bf16 split (``x_hi w_hi + x_hi w_lo + x_lo w_hi``), so both sides sum the
same 27·Cin products, each exact in float32 (bf16 times bf16), and differ
only in the order of the float32 sums. Such a sum's rounding errors add up
like a random walk, about sqrt(n) ulps of the result for n terms, so the
float32 bar is ``2·sqrt(27·Cin)`` f32 ulps at the output's largest
magnitude, rtol 0 (measured: 2-13 ulps for Cin 3-64). In bf16 the bar is 2
bf16 ulps at the output's largest magnitude (both round the f32 sum to
bf16 once; the plain version also rounds the conv before the bias).

The bfloat16 path's operands (``kernel_operands``: Cin zero-padded to a
multiple of 16, weights re-laid as (9, Cout, Cin_p)) are held against JAX
too, through the kernel's GEMM written out in float64 here, at channel
counts that need the padding (Cin 1, 2, 3, 4 and 5, Cout 7 and 64: the
first convs of the channel modes among them).

K3's wide_f32 kernel (every other float32 call: the trunk) is held the
same way: its routing at every conv the served flagship and the train step
hand K3, its wrapper on meta tensors (x and the weights handed over where
they lie, one split launch a call: the weights'), its weights' layout
(``wide_f32_weights_plain``: (9, Cout, Cin_p) bf16 hi, lo at 3 passes)
against ``split_hi_lo_plain``, and the plain version and its operands (x
gathered where it lies and split as the kernel splits it on chip) through
its GEMM against the JAX kernel (3 passes) and the float64 split products
(1 and 2 passes), at the channel counts above and trunk-like ones.

K3's narrow variant (float32 with Cout <= 8) is held the same way: its
routing, its wrapper on meta tensors (x handed over where it lies, no split
of x), and its operands (x split as the kernel splits it, gathered at the
strides the wrapper hands over; the weights as mma B fragments,
``narrow_fragments_plain``) through its GEMM, against the JAX kernel at 3
passes and against the float64 sum of the JAX kernel's split products at 1
and 2 passes, which the JAX kernel does not take.

K3's narrow_k variant (float32 with Cin <= 4 and Cout 9 to 64) likewise:
its routing, its wrapper on meta tensors (x and the weights handed over
where they lie), its weights' B fragments over the packed K (``k = tap Cin
+ c``, ``narrow_k_fragments_plain``) against ``pass_ops.split``, and the
plain version and its operands through its GEMM against the JAX kernel
(3 passes) and the float64 split products (1 and 2 passes) at Cin 1-4.

bfloat16 x with ``passes`` (K3's narrow_bf16 variant, Cout <= 8: the
composed top's convs on the bf16 trunk) is held to its contract, bitwise
the float32 route on ``x.float()``; its routing, its wrapper on meta
tensors (x handed over where it lies, or upcast where TMA cannot take
it), its launch counts in a served forward, and the composed top bitwise
the upcast route it replaces.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from resdepth_tpu.ops.pallas_conv import conv3x3_bias_act as jax_conv
from resdepth_tpu_torch.ops import build
from resdepth_tpu_torch.ops import conv


def _f32_bar(want, c_in):
    """2·sqrt(27·Cin) f32 ulps at the largest output (module docstring)."""
    return 2.0 * np.sqrt(27 * c_in) * float(np.spacing(np.float32(np.abs(want).max())))


def _bf16_bar(want):
    """2 bf16 ulps at the largest output."""
    return 2 * float(torch.finfo(torch.bfloat16).eps) * 2.0 ** np.floor(
        np.log2(np.abs(want).max()))


def _inputs(shape, act, seed=0, bias=True):
    n, h, w, ci, co = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, ci)).astype(np.float32)
    k = rng.normal(size=(3, 3, ci, co)).astype(np.float32) * 0.1
    b = rng.normal(size=(co,)).astype(np.float32) if bias else None
    ap = rng.uniform(0.05, 0.4, co).astype(np.float32) if act == "prelu" else None
    return x, k, b, ap


def _torch(x, k, b, ap, act, dtype=torch.float32):
    args = [None if a is None else torch.from_numpy(a) for a in (x, k, b, ap)]
    args[0] = args[0].to(dtype)
    return conv.conv3x3_bias_act(*args, act_fn=act)


def _jax(x, k, b, ap, act, block_rows=8, dtype=jnp.float32):
    out = jax_conv(jnp.asarray(x).astype(dtype), jnp.asarray(k),
                   None if b is None else jnp.asarray(b),
                   None if ap is None else jnp.asarray(ap),
                   act_fn=act, block_rows=block_rows, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("shape,act", [
    ((2, 16, 16, 8, 16), "relu"),
    ((1, 32, 16, 4, 8), "lrelu"),
    ((2, 16, 32, 16, 8), "prelu"),
    ((1, 16, 16, 8, 8), "none"),
    ((1, 16, 16, 64, 32), "relu"),
    ((2, 16, 16, 3, 7), "relu"),
    ((1, 16, 16, 5, 7), "prelu"),
    # encoder0 of the channel modes geom (1), geom-mono and stereo (2),
    # geom-multiview 3-view (4): Cin -> 64, relu
    ((2, 16, 16, 1, 64), "relu"),
    ((2, 16, 16, 2, 64), "relu"),
    ((2, 16, 16, 4, 64), "relu"),
])
def test_plain_matches_jax_kernel(shape, act):
    inputs = _inputs(shape, act)
    got = _torch(*inputs, act)
    assert got.shape == shape[:3] + (shape[4],) and got.dtype == torch.float32
    want = _jax(*inputs, act)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_f32_bar(want, shape[3]))


def test_plain_matches_jax_kernel_multi_row_blocks():
    """The JAX kernel over several row programs per image; the flagship
    first layer's 3 input channels; no bias (zeros)."""
    inputs = _inputs((2, 32, 16, 3, 8), "relu", seed=3, bias=False)
    want = _jax(*inputs, "relu")
    np.testing.assert_allclose(_torch(*inputs, "relu").numpy(), want, rtol=0,
                               atol=_f32_bar(want, 3))


def test_plain_bfloat16_matches_jax_kernel():
    inputs = _inputs((2, 16, 16, 8, 16), "lrelu", seed=5)
    got = _torch(*inputs, "lrelu", dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = _jax(*inputs, "lrelu", dtype=jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=_bf16_bar(want))


@pytest.mark.parametrize("shape,act", [
    ((2, 16, 16, 3, 7), "relu"), ((1, 16, 32, 5, 7), "prelu"),
    ((1, 16, 16, 5, 16), "lrelu")])
def test_plain_bfloat16_ragged_channels_match_jax_kernel(shape, act):
    inputs = _inputs(shape, act, seed=6)
    got = _torch(*inputs, act, dtype=torch.bfloat16)
    want = _jax(*inputs, act, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=_bf16_bar(want))


def _gemm_from_operands(x_hi, x_lo, w_hi, w_lo):
    """K3's implicit GEMM on its operands, in float64: for each tap (dy, dx)
    the input window at (y+dy-1, x+dx-1), zero outside the image, times the
    tap's (Cout, Cin_p) weights; the three split passes when lo is given."""
    def window(t, dy, dx):
        n, h, w, _ = t.shape
        return F.pad(t.double(), (0, 0, 1, 1, 1, 1))[:, dy:dy + h, dx:dx + w]

    passes = [(x_hi, w_hi)] + ([(x_hi, w_lo), (x_lo, w_hi)] if x_lo is not None else [])
    acc = 0.0
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        for xs, ws in passes:
            acc = acc + window(xs, dy, dx) @ ws[tap].double().T
    return acc


# The shapes whose operands are held through the kernels' GEMM: Cin 1-5,
# 16 and 20 (padded to 16 and 32), Cout 7, 8 and 64.
OPERAND_SHAPES = [
    ((2, 16, 16, 3, 7), "relu"), ((1, 16, 16, 5, 7), "prelu"),
    ((1, 16, 32, 16, 8), "lrelu"), ((1, 16, 16, 20, 64), "none"),
    ((2, 16, 16, 1, 64), "relu"), ((2, 16, 16, 2, 64), "relu"),
    ((2, 16, 16, 4, 64), "relu")]


@pytest.mark.parametrize("dtype", ["bfloat16"])
@pytest.mark.parametrize("shape,act", OPERAND_SHAPES)
def test_kernel_operands_match_jax_kernel(shape, act, dtype):
    """The operands the bfloat16 path hands the wide kernel (Cin padded to
    16, weights re-laid (9, Cout, Cin_p)) give the JAX kernel's result
    through the kernel's GEMM. (Float32 goes to the float32 kernels:
    ``test_wide_f32_operands_match_jax_kernel``.)"""
    x, k, b, ap = _inputs(shape, act, seed=8)
    tdtype = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdtype)
    x_p, w_p = conv.kernel_operands(xt, torch.from_numpy(k))
    c_in_p = -(-shape[3] // 16) * 16
    assert x_p.dtype == w_p.dtype == torch.bfloat16
    assert x_p.shape == shape[:3] + (c_in_p,) and w_p.shape == (9, shape[4], c_in_p)
    assert not x_p[..., shape[3]:].any() and not w_p[..., shape[3]:].any()
    bias, slope = conv._epilogue_vectors(xt, torch.from_numpy(k),
                                         None if b is None else torch.from_numpy(b),
                                         None if ap is None else torch.from_numpy(ap))
    acc = _gemm_from_operands(x_p, None, w_p, None).float()
    got = conv._activate(acc + bias, act, slope).to(tdtype).float().numpy()
    want = _jax(x, k, b, ap, act, dtype=getattr(jnp, dtype))
    np.testing.assert_allclose(got, want, rtol=0, atol=_bf16_bar(want))


def test_split_matches_the_tpu_kernels_split():
    """hi = bf16(v), lo = bf16(v - hi), bit for bit as ``pallas_conv.py``
    splits, and zeros in the padded columns."""
    v = np.random.default_rng(2).normal(size=(37, 5)).astype(np.float32) * 300.0
    hi, lo = conv.split_hi_lo_plain(torch.from_numpy(v), 16)
    jhi = jnp.asarray(v).astype(jnp.bfloat16)
    jlo = (jnp.asarray(v) - jhi.astype(jnp.float32)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(hi[:, :5].float().numpy(), np.asarray(jhi, np.float32))
    np.testing.assert_array_equal(lo[:, :5].float().numpy(), np.asarray(jlo, np.float32))
    assert hi.shape == lo.shape == (37, 16) and not hi[:, 5:].any() and not lo[:, 5:].any()


def test_cpu_call_launches_nothing():
    before = dict(conv.LAUNCHES)
    _torch(*_inputs((1, 16, 16, 4, 8), "relu"), "relu")
    assert conv.LAUNCHES == before


def test_device_tensor_never_runs_the_plain_version(monkeypatch):
    """A tensor off the CPU launches K3 or raises; the plain version never
    runs for it. Meta tensors stand in for CUDA ones (no card here): the
    argument check refuses them, and past a passing check the wrapper calls
    the kernel library and counts the launch, or raises on its error."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a device tensor")

    monkeypatch.setattr(conv, "conv3x3_bias_act_plain", plain)
    x = torch.empty((2, 16, 16, 16), device="meta")
    k = torch.empty((3, 3, 16, 16), device="meta")    # Cin 16, Cout 16: the wide_f32 kernel
    with pytest.raises(ValueError, match="CUDA"):
        conv.conv3x3_bias_act(x, k)

    calls = []

    class FakeLibrary:
        code = 0

        def conv3x3_k3_wide_f32(self, *args):
            calls.append(args)
            return self.code

        def conv_error_string(self, code):
            return b"invalid argument"

    class FakeStream:
        cuda_stream = 0

    lib = FakeLibrary()
    monkeypatch.setattr(conv, "_check_cuda_args", lambda x, k: None)
    monkeypatch.setattr(conv, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: FakeStream())
    before = conv.LAUNCHES["k3"]
    out = conv.conv3x3_bias_act(x, k, act_fn="prelu")
    assert out.shape == (2, 16, 16, 16) and conv.LAUNCHES["k3"] == before + 1
    assert calls[0][14:21] == (2, 16, 16, 16, 16, 3, 3)  # N H W Cin Cout act passes
    lib.code = 1
    with pytest.raises(RuntimeError, match="K3 failed to launch"):
        conv.conv3x3_bias_act(x, k)
    assert conv.LAUNCHES["k3"] == before + 1


def test_kernel_source_is_built_by_name():
    """K3's library is csrc/conv.cu, hashed with the nvcc flags."""
    path = build.library_path("conv")
    assert path.startswith(build.BUILD_DIR) and "libconv_" in path


# ------------------------- K3's narrow variant ------------------------------ #
# Float32 calls with Cout <= 8 go to the narrow kernel (``k3_variant``): it
# reads x at the strides it is handed, splits it in registers and takes the
# weights as mma B fragments (``narrow_fragments_plain``).

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in", [1, 3, 4, 5, 16])
@pytest.mark.parametrize("c_out", [1, 4, 8, 9, 64, 65])
def test_k3_variant_routes_by_dtype_and_cout(dtype, c_in, c_out):
    """float32 with Cout <= 8 goes to the narrow variant, float32 with Cin
    <= 4 and Cout 9 to 64 to the narrow_k variant, every other float32 call
    to the wide_f32 kernel, bfloat16 to the wide one."""
    if dtype != torch.float32:
        want = "wide"
    elif c_out <= 8:
        want = "narrow"
    else:
        want = "narrow_k" if c_in <= 4 and c_out <= 64 else "wide_f32"
    assert conv.k3_variant(dtype, c_in, c_out) == want


class _FakeLibrary:
    """K3's library for meta tensors: records each entry's arguments and
    returns ``code``."""

    def __init__(self):
        self.calls, self.code = [], 0

    def conv3x3_k3(self, *args):
        self.calls.append(("wide", args))
        return self.code

    def conv3x3_k3_narrow(self, *args):
        self.calls.append(("narrow", args))
        return self.code

    def conv3x3_k3_narrow_k(self, *args):
        self.calls.append(("narrow_k", args))
        return self.code

    def conv3x3_k3_wide_f32(self, *args):
        self.calls.append(("wide_f32", args))
        return self.code

    def conv3x3_k3_narrow_bf16(self, *args):
        self.calls.append(("narrow_bf16", args))
        return self.code

    def conv_error_string(self, code):
        return b"invalid argument"


@pytest.fixture
def fake_library(monkeypatch):
    class FakeStream:
        cuda_stream = 0

    lib = _FakeLibrary()
    monkeypatch.setattr(conv, "_check_cuda_args", lambda x, k: None)
    monkeypatch.setattr(conv, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: FakeStream())
    return lib


@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("c_out", [1, 4])
def test_narrow_call_reads_x_where_it_lies(fake_library, monkeypatch, c_out, passes):
    """A float32 call with Cout <= 8 on ``nchw.permute(0, 2, 3, 1)`` hands the
    narrow entry the NCHW tensor's own base pointer and strides (no copy),
    splits no x, counts ``k3``, ``k3_p{n}``, ``k3_narrow`` and the weights'
    split, and raises on a launch error without counting (meta tensors
    stand in for CUDA ones; a view at an offset gives a base pointer that a
    copy would not have)."""
    nchw = torch.empty((2, 6, 16, 24), device="meta")[:, 1:]
    x = nchw.permute(0, 2, 3, 1)
    k = torch.empty((3, 3, 5, c_out), device="meta")
    before = dict(conv.LAUNCHES)
    out = conv.conv3x3_bias_act(x, k, act_fn="lrelu", passes=passes)
    assert out.shape == (2, 16, 24, c_out) and out.is_contiguous()
    (entry, args), = fake_library.calls
    assert entry == "narrow" and args[0] == nchw.data_ptr() != 0
    assert args[1:5] == (6 * 16 * 24, 24, 1, 16 * 24)        # N H W C strides of NCHW
    assert args[14:21] == (2, 16, 24, 5, c_out, 2, passes)   # N H W Cin Cout act passes
    gained = {key: conv.LAUNCHES[key] - before[key] for key in before}
    assert {key: n for key, n in gained.items() if n} == {
        "k3": 1, f"k3_p{passes}": 1, "k3_narrow": 1, "k3_split": 1}
    fake_library.code = 1
    counted = dict(conv.LAUNCHES)
    with pytest.raises(RuntimeError, match="K3 failed to launch"):
        conv.conv3x3_bias_act(x, k, passes=passes)
    assert conv.LAUNCHES == counted


@pytest.mark.parametrize("dtype,c_out", [(torch.float32, 9), (torch.float32, 64),
                                         (torch.bfloat16, 1), (torch.bfloat16, 8)])
def test_other_calls_reach_the_wide_kernel(fake_library, dtype, c_out):
    """Cout above 8 in float32 at Cin above 4 launches the wide_f32 kernel,
    ``conv3x3_k3_wide_f32``; bfloat16 at any Cout the wide kernel,
    ``conv3x3_k3``, with its bf16 operands (Cin padded to 16); neither
    launches anything of the narrow variants."""
    x = torch.empty((2, 16, 16, 16), device="meta", dtype=dtype)
    k = torch.empty((3, 3, 16, c_out), device="meta")
    before = dict(conv.LAUNCHES)
    conv.conv3x3_bias_act(x, k)
    f32 = dtype == torch.float32
    assert [entry for entry, _ in fake_library.calls] == ["wide_f32" if f32 else "wide"]
    assert fake_library.calls[0][1][18 if f32 else 9] == c_out
    assert conv.LAUNCHES["k3"] == before["k3"] + 1
    assert conv.LAUNCHES["k3_wide_f32"] == before["k3_wide_f32"] + f32
    assert conv.LAUNCHES["k3_split"] == before["k3_split"] + f32
    assert conv.LAUNCHES["k3_narrow"] == before["k3_narrow"]
    assert conv.LAUNCHES["k3_narrow_k"] == before["k3_narrow_k"]


def _bf16_bits(bits):
    """int32 16-bit patterns -> the float32 values of those bf16 numbers."""
    signed = (bits & 0xFFFF) - ((bits & 0x8000) << 1)
    return signed.to(torch.int16).view(torch.bfloat16).float()


def _fragments_as_weights(frags):
    """mma m16n8k16's B operand read back from ``narrow_fragments_plain``:
    (hi, lo), each (9, 16 chunks, 8) float64. Lane l holds column l // 4,
    rows 2 (l % 4) and + 1 in its first register, + 8 and + 9 in its
    second, the lower row in the low half."""
    n_chunks = frags.shape[0]
    lane = torch.arange(32)
    o, q = lane // 4, lane % 4
    halves = []
    for first in (0, 2):
        w = torch.zeros(n_chunks, 9, 16, 8, dtype=torch.float64)
        for reg, rows in ((first, 2 * q), (first + 1, 2 * q + 8)):
            bits = frags[..., reg]
            w[:, :, rows, o] = _bf16_bits(bits).double()
            w[:, :, rows + 1, o] = _bf16_bits(bits >> 16).double()
        halves.append(w.transpose(0, 1).reshape(9, n_chunks * 16, 8))
    return halves


def _padded_from_storage(x, c_p):
    """``x`` (N, H, W, Cin) gathered from its storage at its strides (what
    the wrapper hands the kernel), one pixel of zeros around the image and
    zero channels up to ``c_p``: (N, H + 2, W + 2, c_p)."""
    n, h, w, c_in = x.shape
    flat = torch.as_strided(x, (x.untyped_storage().nbytes() // 4,), (1,), 0)
    ni, yi, xi, ci = torch.meshgrid(torch.arange(n), torch.arange(-1, h + 1),
                                    torch.arange(-1, w + 1), torch.arange(c_p), indexing="ij")
    inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w) & (ci < c_in)
    sn, sh, sw, sc = x.stride()
    at = x.storage_offset() + ni * sn + yi * sh + xi * sw + ci * sc
    return torch.where(inside, flat[torch.where(inside, at, 0)], torch.zeros(()))


def _narrow_emulation(x, kernel, passes):
    """K3's narrow variant in float64 on its operands: x gathered from its
    storage at the strides the wrapper hands the kernel (``x.stride()``),
    zeros outside the image and past Cin, split as the kernel splits it
    (``pass_ops.split``); the weights as B fragments, read back; each tap's
    window times the tap's weights, the passes' products summed. Returns
    (N, H, W, 8)."""
    from resdepth_tpu_torch.ops import passes as pass_ops

    n, h, w, c_in = x.shape
    w_hi, w_lo = _fragments_as_weights(conv.narrow_fragments_plain(kernel))
    x_hi, x_lo = (t.double() for t in pass_ops.split(_padded_from_storage(x, w_hi.shape[1])))
    pairs = {1: [(x_hi, w_hi)], 2: [(x_hi, w_hi), (x_lo, w_hi)],
             3: [(x_hi, w_hi), (x_hi, w_lo), (x_lo, w_hi)]}[passes]
    acc = torch.zeros(n, h, w, 8, dtype=torch.float64)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        for xs, ws in pairs:
            acc += xs[:, dy:dy + h, dx:dx + w] @ ws[tap]
    return acc


def _float64_passes(x, k, b, act, ap, passes):
    """The JAX kernel's split (``pallas_conv.py::_conv_kernel``: bf16 hi of
    the value, bf16 lo of the rest) with only ``passes`` of its products,
    summed in float64, then bias and activation: the reference for 1 and 2
    passes, which the JAX kernel does not take."""
    def halves(v):
        hi = torch.from_numpy(v).to(torch.bfloat16).double()
        return hi, (torch.from_numpy(v).double() - hi).float().to(torch.bfloat16).double()

    (x_hi, x_lo), (w_hi, w_lo) = halves(x), halves(k)
    pairs = {1: [(x_hi, w_hi)], 2: [(x_hi, w_hi), (x_lo, w_hi)]}[passes]
    n, h, w, _ = x.shape
    acc = torch.zeros(n, h, w, k.shape[3], dtype=torch.float64)
    for xs, ws in pairs:
        xp = F.pad(xs, (0, 0, 1, 1, 1, 1))
        for dy in range(3):
            for dx in range(3):
                acc += xp[:, dy:dy + h, dx:dx + w] @ ws[dy, dx]
    slope = torch.from_numpy(ap).double() if ap is not None else None
    return conv._activate(acc + torch.from_numpy(b).double(), act, slope).numpy()


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("c_out,act", [(1, "none"), (4, "prelu"), (8, "lrelu")])
def test_narrow_operands_match_jax_kernel(c_out, act, passes, layout):
    """The narrow variant's operands (x split where it lies, in either
    layout; the weights' B fragments) through its GEMM give the JAX kernel's
    result (interpret mode) within ``_f32_bar`` at 3 passes, and the JAX
    kernel's split products at 1 and 2 passes summed in float64 (the JAX
    kernel runs 3 only) within the same bar. Cin 20: a full chunk of 16 and
    a ragged one."""
    x, k, b, ap = _inputs((2, 16, 24, 20, c_out), act, seed=11 + passes)
    xt = torch.from_numpy(x)
    if layout == "nchw":
        xt = xt.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert xt.is_contiguous() == (layout == "nhwc")
    bias, slope = conv._epilogue_vectors(xt, torch.from_numpy(k), torch.from_numpy(b),
                                         None if ap is None else torch.from_numpy(ap))
    acc = _narrow_emulation(xt, torch.from_numpy(k), passes)[..., :c_out].float()
    got = conv._activate(acc + bias, act, slope).numpy()
    want = (_jax(x, k, b, ap, act) if passes == 3
            else _float64_passes(x, k, b, act, ap, passes))
    np.testing.assert_allclose(got, want, rtol=0, atol=_f32_bar(want, 20))
    if passes < 3:     # fewer passes are another function
        assert np.abs(want - _jax(x, k, b, ap, act)).max() > _f32_bar(want, 20)


@pytest.mark.parametrize("c_out", [1, 5, 8])
def test_narrow_fragments_hold_the_split_weights(c_out):
    """Every weight's hi and lo sit once in the fragments, at the lane and
    register that mma reads for its row (input channel) and column (output
    channel); the padding past Cin and Cout is zero."""
    k = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 3, 21, c_out))
                         .astype(np.float32))
    w_hi, w_lo = _fragments_as_weights(conv.narrow_fragments_plain(k))
    hi, lo = conv.split_hi_lo_plain(k.reshape(9, 21, c_out))
    assert torch.equal(w_hi[:, :21, :c_out], hi.double())
    assert torch.equal(w_lo[:, :21, :c_out], lo.double())
    assert not w_hi[:, 21:].any() and not w_hi[..., c_out:].any()
    assert not w_lo[:, 21:].any() and not w_lo[..., c_out:].any()


@pytest.mark.parametrize("name", ["whole", "no_mma", "no_mma_ldm", "no_split", "loads_only"])
def test_narrow_ablation_cuts_find_their_lines(name):
    """``studies/narrow_ablation.py`` cuts parts of the narrow kernel out of
    a copy of ``csrc/conv.cu`` by pattern: each cut still finds its lines
    (else it raises) and gives a source of its own."""
    from resdepth_tpu_torch.studies import narrow_ablation

    with open(os.path.join(build.CSRC, "conv.cu")) as f:
        source = f.read()
    cuts = narrow_ablation.cut_sources(source)
    assert (cuts[name] == source) == (name == "whole")
    assert len(cuts[name]) <= len(source) and len(set(cuts.values())) == len(cuts)
    assert "conv3x3_k3_narrow_kernel" in cuts[name]


# ------------------------- K3's narrow_bf16 variant ------------------------- #
# bfloat16 x with ``passes`` (the composed top's convs on the bf16 trunk) is
# the conv of x's exact float32 value at those passes, a float32 result, for
# Cout <= 8: on the card the narrow_bf16 kernel reads x as it lies (TMA),
# on the CPU the plain version runs on ``x.float()``.

def _layout(x, layout):
    """(N, H, W, C) ``x`` as NHWC memory or as the NHWC view of NCHW memory."""
    if layout == "nchw":
        return x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    return x.contiguous()


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("c_out,act", [(1, "none"), (4, "prelu")])
def test_bf16_passes_are_the_conv_of_the_upcast(c_out, act, passes, layout):
    """``conv3x3_bias_act(x_bf16, ..., passes=p)`` is bitwise
    ``conv3x3_bias_act(x_bf16.float(), ..., passes=p)``, float32, in either
    layout; Cin 20 (a full chunk of 16 and a ragged one)."""
    x, k, b, ap = (None if a is None else torch.from_numpy(a)
                   for a in _inputs((2, 16, 24, 20, c_out), act, seed=30 + passes))
    xb = _layout(x.to(torch.bfloat16), layout)
    got = conv.conv3x3_bias_act(xb, k, b, ap, act_fn=act, passes=passes)
    want = conv.conv3x3_bias_act(xb.float(), k, b, ap, act_fn=act, passes=passes)
    assert got.dtype == torch.float32 and got.shape == (2, 16, 24, c_out)
    assert torch.equal(got, want)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_bf16_passes_take_narrow_couts_only(fake_library, device):
    """bfloat16 x with ``passes`` at Cout above ``NARROW_COUT`` raises, on
    the CPU and before any launch on a device; without ``passes`` bfloat16
    keeps its one native pass and its bfloat16 result."""
    x = torch.zeros((1, 8, 8, 16), dtype=torch.bfloat16, device=device)
    wide = torch.zeros((3, 3, 16, conv.NARROW_COUT + 1), device=device)
    before = dict(conv.LAUNCHES)
    with pytest.raises(ValueError, match="output channels"):
        conv.conv3x3_bias_act(x, wide, passes=3)
    assert conv.LAUNCHES == before and not fake_library.calls
    with pytest.raises(ValueError, match="output channels"):
        conv.k3_variant(torch.bfloat16, 16, conv.NARROW_COUT + 1, 1)
    assert conv.k3_variant(torch.bfloat16, 16, conv.NARROW_COUT + 1) == "wide"
    assert conv.k3_variant(torch.bfloat16, 64, conv.NARROW_COUT, 2) == "narrow_bf16"
    assert conv.conv3x3_bias_act(x, wide).dtype == torch.bfloat16


@pytest.mark.parametrize("view", ["nhwc", "rotated"])
@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("c_out", [1, 4])
def test_narrow_bf16_call_reads_x_where_it_lies(fake_library, c_out, passes, view):
    """A bfloat16 call with ``passes`` and Cout <= 8 hands the narrow_bf16
    entry x's own base pointer and strides (no copy, no ``.float()``), in
    NHWC memory at an offset or as an H/W-transposed view of it (a
    rotation's), counts ``k3``, ``k3_p{n}``, ``k3_narrow_bf16`` and the
    weights' split once each, returns float32, and raises on a launch error
    without counting (meta tensors stand in for CUDA ones)."""
    memory = torch.empty((2, 24, 24, 80), dtype=torch.bfloat16, device="meta")[..., 16:]
    x = memory if view == "nhwc" else memory.transpose(1, 2)
    k = torch.empty((3, 3, 64, c_out), device="meta")
    assert conv.k3_variant(x.dtype, 64, c_out, passes) == "narrow_bf16"
    before = dict(conv.LAUNCHES)
    out = conv.conv3x3_bias_act(x, k, act_fn="none", passes=passes)
    assert out.shape == (2, 24, 24, c_out) and out.dtype == torch.float32
    assert out.is_contiguous()
    (entry, args), = fake_library.calls
    assert entry == "narrow_bf16" and args[0] == x.data_ptr() == memory.data_ptr() != 0
    assert args[1:5] == x.stride()
    assert args[14:21] == (2, 24, 24, 64, c_out, 0, passes)   # N H W Cin Cout act passes
    gained = {key: conv.LAUNCHES[key] - before[key] for key in before}
    assert {key: n for key, n in gained.items() if n} == {
        "k3": 1, f"k3_p{passes}": 1, "k3_narrow_bf16": 1, "k3_split": 1}
    fake_library.code = 1
    counted = dict(conv.LAUNCHES)
    with pytest.raises(RuntimeError, match="narrow_bf16 variant"):
        conv.conv3x3_bias_act(x, k, passes=passes)
    assert conv.LAUNCHES == counted


@pytest.mark.parametrize("view", ["nchw", "odd_channels"])
def test_narrow_bf16_falls_back_where_tma_cannot_read(fake_library, view):
    """A bfloat16 view the narrow_bf16 kernel's TMA map cannot take (C not
    contiguous; 6-byte pixels) runs the narrow variant on ``x.float()``,
    counted in ``k3_bf16_upcast`` besides the narrow variant's own counts."""
    c_in = 64 if view == "nchw" else 3
    x = torch.empty((2, 16, 24, c_in), dtype=torch.bfloat16, device="meta")
    if view == "nchw":
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not conv.tma_takes_bf16(x)
    before = dict(conv.LAUNCHES)
    out = conv.conv3x3_bias_act(x, torch.empty((3, 3, c_in, 4), device="meta"), passes=3)
    assert out.dtype == torch.float32
    (entry, args), = fake_library.calls
    assert entry == "narrow" and args[1:5] == x.stride()   # the float32 copy, x's layout
    gained = {key: conv.LAUNCHES[key] - before[key] for key in before}
    assert {key: n for key, n in gained.items() if n} == {
        "k3": 1, "k3_p3": 1, "k3_narrow": 1, "k3_split": 1, "k3_bf16_upcast": 1}


@pytest.mark.parametrize("mode", ["fast32", "act2pass", "balanced", "balanced16", "mixed"])
def test_served_forward_launches_narrow_bf16_at_the_top(fake_library, mode):
    """One forward of the served flagship (traced on meta tensors through
    K3's wrapper and a fake library) launches the narrow_bf16 kernel twice
    on the bf16 trunk (``mixed``, ``balanced16``: the composed top's two
    convs, handed the trunk's bf16 activations) and never on float32
    storage; no call falls back to the upcast."""
    import chip_smoke

    before = dict(conv.LAUNCHES)
    chip_smoke._meta_forward(mode, None, 2, conv.conv3x3_bias_act)
    gained = {key: conv.LAUNCHES[key] - before[key] for key in before}
    by_passes = chip_smoke.k3_calls_a_forward(mode)
    assert gained["k3"] == sum(by_passes.values())
    assert {p: gained[f"k3_p{p}"] for p in by_passes} == by_passes
    assert gained["k3_narrow_bf16"] == (2 if mode in ("mixed", "balanced16") else 0)
    assert gained["k3_bf16_upcast"] == 0
    top = [args for entry, args in fake_library.calls if entry == "narrow_bf16"]
    assert [a[14:19] for a in top] == [(2, 256, 256, 64, 1), (2, 128, 128, 64, 4)][:len(top)]


def test_smoke_weighs_narrow_bf16_by_the_served_forwards():
    """``chip_smoke.narrow_bf16_weights``, by which the kernel record sums
    the narrow_bf16 kernel's times, finds the composed top's two convs once
    a forward at ``mixed``'s 1 pass and ``balanced16``'s 3, and no other."""
    import chip_smoke

    assert chip_smoke.narrow_bf16_weights() == {
        (h, 64, c_out, "none", p): 1 for h, c_out in ((256, 1), (128, 4)) for p in (1, 3)}


@pytest.mark.parametrize("mode", ["balanced16", "mixed"])
def test_composed_top_is_the_upcast_route_bitwise(monkeypatch, mode):
    """The composed top on the bf16 trunk hands K3 the trunk's bf16
    activations with the mode's passes, and the served forward is bitwise
    the one that upcasts them to float32 first (the route before the
    narrow_bf16 kernel) on the CPU."""
    from resdepth_tpu_torch.models import unet as tunet

    config = tunet.UNetConfig(n_input_channels=3, depth=2, start_kernel=8,
                              max_filter_depth=16, act_fn_encoder="prelu")
    model = tunet.fold_serving(tunet.init_unet(config, torch.Generator().manual_seed(3)))
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 32, 32, 3))
                         .astype(np.float32))
    kwargs = tunet.serving_precision(mode).apply_kwargs()
    calls, k3, f32_route = [], tunet.conv3x3_bias_act, tunet._conv3x3_f32

    def record(x, kernel, *args, passes=None, **kw):
        calls.append((x.dtype, kernel.shape[3], passes))
        return k3(x, kernel, *args, passes=passes, **kw)

    monkeypatch.setattr(tunet, "conv3x3_bias_act", record)
    with torch.no_grad():
        got = tunet.apply_unet(model, x, **kwargs)
        top = calls[-2:]
        monkeypatch.setattr(tunet, "_conv3x3_f32",
                            lambda x, *args, **kw: f32_route(x.float(), *args, **kw))
        want = tunet.apply_unet(model, x, **kwargs)
    passes = 3 if mode == "balanced16" else 1
    assert top == [(torch.bfloat16, 1, passes), (torch.bfloat16, 4, passes)]
    assert [c[0] for c in calls[-2:]] == [torch.float32, torch.float32]
    assert torch.equal(got, want)


# ------------------------- K3's narrow_k variant ---------------------------- #
# Float32 calls with Cin <= 4 and Cout 9 to 64 go to the narrow_k kernel
# (``k3_variant``): it reads x at the strides it is handed, packs taps x
# channels into K (column k = tap Cin + c, 9 Cin padded to a multiple of
# 16), splits x in registers and takes the weights as mma B fragments over
# 64 output channels (``narrow_k_fragments_plain``).

@pytest.mark.parametrize("c_out", [9, 64])
def test_narrow_k_calls_reach_the_narrow_k_kernel(fake_library, c_out):
    """float32 at Cin 4 with Cout 9 and 64 (the cases that went to the
    wide kernel before the narrow_k variant) launch ``conv3x3_k3_narrow_k``
    alone, and count ``k3``, ``k3_p3``, ``k3_narrow_k`` and the weights'
    split."""
    x = torch.empty((2, 16, 16, 4), device="meta")
    k = torch.empty((3, 3, 4, c_out), device="meta")
    before = dict(conv.LAUNCHES)
    conv.conv3x3_bias_act(x, k)
    (entry, args), = fake_library.calls
    assert entry == "narrow_k" and args[14:21] == (2, 16, 16, 4, c_out, 1, 3)
    gained = {key: conv.LAUNCHES[key] - before[key] for key in before}
    assert {key: n for key, n in gained.items() if n} == {
        "k3": 1, "k3_p3": 1, "k3_narrow_k": 1, "k3_split": 1}


@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_narrow_k_call_reads_x_where_it_lies(fake_library, monkeypatch, layout, passes):
    """A narrow_k call hands the kernel x's own base pointer and strides,
    for NHWC memory (encoder0's input) and for the NHWC view of NCHW memory
    (the last conv's dx reads its cotangent so), and the weights at their
    own strides (the dx's flipped and transposed view): no copy, no split
    of x; it counts ``k3``, ``k3_p{n}``, ``k3_narrow_k`` and the weights'
    split, and raises on a launch error without counting (meta tensors
    stand in for CUDA ones; a view at an offset gives a base pointer that a
    copy would not have)."""
    if layout == "nchw":
        memory = torch.empty((2, 4, 16, 24), device="meta")[:, 1:]
        x = memory.permute(0, 2, 3, 1)
        strides = (4 * 16 * 24, 24, 1, 16 * 24)
    else:
        memory = torch.empty((3, 16, 24, 3), device="meta")[1:]
        x = memory
        strides = (16 * 24 * 3, 24 * 3, 3, 1)
    oihw = torch.empty((3, 40, 3, 3), device="meta")       # a conv 40 -> 3; its dx 3 -> 40
    k = oihw.flip(2, 3).transpose(0, 1).permute(2, 3, 1, 0)
    before = dict(conv.LAUNCHES)
    out = conv.conv3x3_bias_act(x, k, act_fn="lrelu", passes=passes)
    assert out.shape == (2, 16, 24, 40) and out.is_contiguous()
    (entry, args), = fake_library.calls
    assert entry == "narrow_k" and args[0] == memory.data_ptr() != 0
    assert args[1:5] == strides and args[6:10] == k.stride()
    assert args[14:21] == (2, 16, 24, 3, 40, 2, passes)     # N H W Cin Cout act passes
    gained = {key: conv.LAUNCHES[key] - before[key] for key in before}
    assert {key: n for key, n in gained.items() if n} == {
        "k3": 1, f"k3_p{passes}": 1, "k3_narrow_k": 1, "k3_split": 1}
    fake_library.code = 1
    counted = dict(conv.LAUNCHES)
    with pytest.raises(RuntimeError, match="K3 failed to launch"):
        conv.conv3x3_bias_act(x, k, passes=passes)
    assert conv.LAUNCHES == counted


def _k_fragments_as_weights(frags):
    """mma m16n8k16's B operand read back from ``narrow_k_fragments_plain``:
    (hi, lo), each (16 k steps, 64) float64. In k step s and n8 tile t,
    lane l holds column 8 t + l // 4, rows 16 s + 2 (l % 4) and + 1 in its
    first register, + 8 and + 9 in its second, the lower row in the low
    half."""
    steps = frags.shape[0]
    halves = []
    for first in (0, 2):
        w = torch.zeros(steps, 16, 8, 8, dtype=torch.float64)   # step, row, tile, column
        for lane in range(32):
            o, q = lane // 4, lane % 4
            for reg, row in ((first, 2 * q), (first + 1, 2 * q + 8)):
                bits = frags[:, :, lane, reg]
                w[:, row, :, o] = _bf16_bits(bits).double()
                w[:, row + 1, :, o] = _bf16_bits(bits >> 16).double()
        halves.append(w.reshape(steps * 16, 64))
    return halves


@pytest.mark.parametrize("c_out", [9, 24, 64])
@pytest.mark.parametrize("c_in", [1, 2, 3, 4])
def test_narrow_k_fragments_hold_the_split_weights(c_in, c_out):
    """The fragments hold ``pass_ops.split`` of the packed weights, the
    (9 Cin, Cout) matrix of row ``k = tap Cin + c``: every weight's hi and
    lo once, at the lane and register mma reads for its row and column;
    zeros past 9 Cin (up to the k16 steps) and Cout (up to 64)."""
    from resdepth_tpu_torch.ops import passes as pass_ops

    k = torch.from_numpy(np.random.default_rng(c_in).normal(size=(3, 3, c_in, c_out))
                         .astype(np.float32))
    frags = conv.narrow_k_fragments_plain(k)
    steps = conv.narrow_k_steps(c_in)
    assert frags.shape == (steps, 8, 32, 4) and frags.dtype == torch.int32
    assert 16 * steps - 16 < 9 * c_in <= 16 * steps
    w_hi, w_lo = _k_fragments_as_weights(frags)
    hi, lo = pass_ops.split(k.reshape(9 * c_in, c_out))
    assert torch.equal(w_hi[:9 * c_in, :c_out], hi.double())
    assert torch.equal(w_lo[:9 * c_in, :c_out], lo.double())
    for w in (w_hi, w_lo):
        assert not w[9 * c_in:].any() and not w[:, c_out:].any()


def _narrow_k_emulation(x, kernel, passes):
    """K3's narrow_k variant in float64 on its operands: x gathered from its
    storage at the strides the wrapper hands the kernel, zeros outside the
    image; each pixel's row of A the 9 taps' windows with their channels
    (column ``tap Cin + c``), zeros up to the k16 steps, split as the kernel
    splits it; the weights as B fragments, read back; the passes' products
    summed. Returns (N, H, W, 64)."""
    from resdepth_tpu_torch.ops import passes as pass_ops

    n, h, w, c_in = x.shape
    w_hi, w_lo = _k_fragments_as_weights(conv.narrow_k_fragments_plain(kernel))
    xp = _padded_from_storage(x, c_in)
    a = torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], -1)
    a = F.pad(a, (0, w_hi.shape[0] - 9 * c_in))
    a_hi, a_lo = (t.double() for t in pass_ops.split(a))
    pairs = {1: [(a_hi, w_hi)], 2: [(a_hi, w_hi), (a_lo, w_hi)],
             3: [(a_hi, w_hi), (a_hi, w_lo), (a_lo, w_hi)]}[passes]
    return sum(xs @ ws for xs, ws in pairs)


@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("c_out,act", [(16, "relu"), (64, "prelu"), (24, "none")])
@pytest.mark.parametrize("c_in", [1, 2, 3, 4])
def test_narrow_k_matches_jax_kernel(c_in, c_out, act, passes):
    """The narrow_k variant's shapes (Cin 1-4 -> 16, 64 and a ragged 24) on
    a small image (2 x 12 x 20): the plain version, which the wrapper runs
    on the CPU, and the variant's operands through its GEMM (x gathered
    where it lies, NHWC memory and the NHWC view of NCHW memory; K packed;
    the weights' B fragments) give the JAX kernel's result (interpret mode)
    within ``_f32_bar`` at 3 passes, and the float64 sum of the JAX
    kernel's split products at 1 and 2 passes (the JAX kernel runs 3 only)
    within the same bar."""
    x, k, b, ap = _inputs((2, 12, 20, c_in, c_out), act, seed=20 + c_in)
    want = (_jax(x, k, b, ap, act, block_rows=4) if passes == 3
            else _float64_passes(x, k, b, act, ap, passes))
    bar = _f32_bar(want, c_in)
    kt, bt = torch.from_numpy(k), torch.from_numpy(b)
    at = None if ap is None else torch.from_numpy(ap)
    plain = conv.conv3x3_bias_act(torch.from_numpy(x), kt, bt, at, act_fn=act, passes=passes)
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=bar)
    bias, slope = conv._epilogue_vectors(plain, kt, bt, at)
    for xt in (torch.from_numpy(x), torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
               .permute(0, 2, 3, 1)):
        acc = _narrow_k_emulation(xt, kt, passes)[..., :c_out].float()
        got = conv._activate(acc + bias, act, slope).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=bar)


@pytest.mark.parametrize("name", ["whole", "no_mma", "no_split", "no_loads", "stores_only"])
def test_narrow_k_ablation_cuts_find_their_lines(name):
    """``studies/narrow_ablation.py --kernel narrow_k`` cuts parts of the
    narrow_k kernel out of a copy of ``csrc/conv.cu`` by pattern: each cut
    still finds its lines (else it raises), gives a source of its own and
    leaves the narrow kernel whole."""
    from resdepth_tpu_torch.studies import narrow_ablation

    with open(os.path.join(build.CSRC, "conv.cu")) as f:
        source = f.read()
    cuts = narrow_ablation.cut_sources(source, "narrow_k")
    assert (cuts[name] == source) == (name == "whole")
    assert len(cuts[name]) <= len(source) and len(set(cuts.values())) == len(cuts)
    assert "conv3x3_k3_narrow_k_kernel" in cuts[name]
    narrow = source[:source.index("namespace narrow_k {")]
    assert cuts[name].startswith(narrow)


# ------------------------- K3's wide_f32 kernel ----------------------------- #
# Every other float32 call (the trunk) goes to the wide_f32 kernel
# (``k3_variant``): it reads x at the strides it is handed, a float32 halo
# a chunk of 64 input channels, splits it on chip into the bf16 buffers
# that all 9 taps read, and takes the weights as (9, Cout, Cin_p) bf16 hi
# (and lo at 3 passes), split by one small launch a call
# (``wide_f32_weights_plain``).

# The kernel each (Cin, Cout) of the served flagship and of its train step
# goes to in float32 (bfloat16 goes to "wide" at any of them).
FLAGSHIP_ROUTES = {(3, 64): "narrow_k", (1, 64): "narrow_k", (64, 1): "narrow",
                   (64, 4): "narrow", (64, 128): "wide_f32", (128, 256): "wide_f32",
                   (256, 512): "wide_f32", (512, 512): "wide_f32", (512, 256): "wide_f32",
                   (256, 128): "wide_f32", (128, 64): "wide_f32"}


def _train_k3_calls():
    """The K3 calls of one flagship train step at 'default' as (H, Cin,
    Cout): the forward of every 3x3 conv (the top not composed: the last
    conv 64 -> 1) and the dx of each but encoder0 (Cout -> Cin)."""
    import chip_smoke

    forward = [c[:3] for c in chip_smoke.mode_k3_convs("fast32")
               if c[2] not in (1, 4)] + [(256, 64, 1)]
    return forward + [(h, c_out, c_in) for h, c_in, c_out in forward[1:]]


@pytest.mark.parametrize("path", ["mixed", "fast32", "act2pass", "balanced", "balanced16",
                                  "train"])
def test_k3_routes_every_served_and_trained_conv(path):
    """Every conv the served flagship hands K3 in a serving mode
    (``chip_smoke.mode_k3_convs``, traced on meta tensors), and every forward
    and dx call of its train step, goes in float32 to the kernel named in
    ``FLAGSHIP_ROUTES`` (the trunk to wide_f32), and in bfloat16 to the wide
    kernel."""
    import chip_smoke

    if path == "train":
        calls = _train_k3_calls()
        assert len(calls) == chip_smoke.k3_launches_a_step("default")[1]
    else:
        calls = [c[:3] for c in chip_smoke.mode_k3_convs(path)]
    assert calls
    for _, c_in, c_out in calls:
        assert conv.k3_variant(torch.float32, c_in, c_out) == FLAGSHIP_ROUTES[(c_in, c_out)]
        assert conv.k3_variant(torch.bfloat16, c_in, c_out) == "wide"


@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_wide_f32_call_reads_x_where_it_lies(fake_library, layout, passes):
    """A wide_f32 call hands the kernel x's own base pointer and strides,
    for NHWC memory (what K3 writes, as every serving mode hands it) and
    for the NHWC view of NCHW memory, and the weights at their own strides
    (the dx's flipped and transposed view): no copy of either, no split
    launch on x; it counts ``k3``, ``k3_p{n}``, ``k3_wide_f32`` and one
    split (the weights'), and raises on a launch error without counting
    (meta tensors stand in for CUDA ones; a view at an offset gives a base
    pointer that a copy would not have)."""
    if layout == "nchw":
        memory = torch.empty((2, 40, 16, 24), device="meta")[:, 1:]
        x = memory.permute(0, 2, 3, 1)
        strides = (40 * 16 * 24, 24, 1, 16 * 24)
    else:
        memory = torch.empty((3, 16, 24, 39), device="meta")[1:]
        x = memory
        strides = (16 * 24 * 39, 24 * 39, 39, 1)
    oihw = torch.empty((39, 72, 3, 3), device="meta")      # a conv 72 -> 39; its dx 39 -> 72
    k = oihw.flip(2, 3).transpose(0, 1).permute(2, 3, 1, 0)
    before = dict(conv.LAUNCHES)
    out = conv.conv3x3_bias_act(x, k, act_fn="prelu", passes=passes)
    assert out.shape == (2, 16, 24, 72) and out.is_contiguous()
    (entry, args), = fake_library.calls
    assert entry == "wide_f32" and args[0] == memory.data_ptr() != 0
    assert args[1:5] == strides and args[6:10] == k.stride()
    assert args[14:21] == (2, 16, 24, 39, 72, 3, passes)    # N H W Cin Cout act passes
    gained = {key: conv.LAUNCHES[key] - before[key] for key in before}
    assert {key: n for key, n in gained.items() if n} == {
        "k3": 1, f"k3_p{passes}": 1, "k3_wide_f32": 1, "k3_split": 1}
    fake_library.code = 1
    counted = dict(conv.LAUNCHES)
    with pytest.raises(RuntimeError, match="K3 failed to launch"):
        conv.conv3x3_bias_act(x, k, passes=passes)
    assert conv.LAUNCHES == counted


@pytest.mark.parametrize("c_out", [9, 72])
@pytest.mark.parametrize("c_in", [5, 64, 80])
def test_wide_f32_weights_hold_the_split_weights(c_in, c_out):
    """``wide_f32_weights_plain`` (the plain version of
    ``split_hi_lo_weights_kernel``) holds ``split_hi_lo_plain`` of the
    weights, re-laid (9, Cout, Cin_p) K-major: every weight's hi, and lo at
    3 passes, at [tap, output channel, input channel]; zeros past Cin up to
    the multiple of 16; no lo below 3 passes."""
    k = torch.from_numpy(np.random.default_rng(c_in + c_out).normal(
        size=(3, 3, c_in, c_out)).astype(np.float32))
    c_in_p = -(-c_in // 16) * 16
    hi, lo = conv.split_hi_lo_plain(k.reshape(9, c_in, c_out))
    w_hi, w_lo = conv.wide_f32_weights_plain(k, 3)
    assert w_hi.shape == w_lo.shape == (9, c_out, c_in_p) and w_hi.dtype == torch.bfloat16
    assert torch.equal(w_hi[..., :c_in], hi.transpose(1, 2))
    assert torch.equal(w_lo[..., :c_in], lo.transpose(1, 2))
    assert not w_hi[..., c_in:].any() and not w_lo[..., c_in:].any()
    for passes in (1, 2):
        one_half, none = conv.wide_f32_weights_plain(k, passes)
        assert torch.equal(one_half, w_hi) and none is None


def _wide_f32_emulation(x, kernel, passes):
    """K3's wide_f32 kernel in float64 on its operands: x gathered from its
    storage at the strides the wrapper hands the kernel, zeros outside the
    image and past Cin (TMA's zero fill), split as the kernel splits it on
    chip (``pass_ops.split``); the weights as ``wide_f32_weights_plain``
    lays them out; each tap's window times the tap's (Cout, Cin_p) weights,
    the passes' products summed. Returns (N, H, W, Cout)."""
    from resdepth_tpu_torch.ops import passes as pass_ops

    n, h, w, _ = x.shape
    w_hi, w_lo = conv.wide_f32_weights_plain(kernel, passes)
    x_hi, x_lo = (t.double() for t in pass_ops.split(_padded_from_storage(x, w_hi.shape[2])))
    pairs = {1: [(x_hi, w_hi)], 2: [(x_hi, w_hi), (x_lo, w_hi)],
             3: [(x_hi, w_hi), (x_hi, w_lo), (x_lo, w_hi)]}[passes]
    acc = torch.zeros(n, h, w, kernel.shape[3], dtype=torch.float64)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        for xs, ws in pairs:
            acc += xs[:, dy:dy + h, dx:dx + w] @ ws[tap].double().T
    return acc


@pytest.mark.parametrize("shape,act", OPERAND_SHAPES)
def test_wide_f32_operands_match_jax_kernel(shape, act):
    """The operands the float32 path hands the wide_f32 kernel (x where it
    lies, NHWC memory and the NHWC view of NCHW memory, split as the kernel
    splits it; the weights re-laid (9, Cout, Cin_p) and split) give the JAX
    kernel's result (3 passes) through the kernel's GEMM."""
    x, k, b, ap = _inputs(shape, act, seed=8)
    kt = torch.from_numpy(k)
    bias, slope = conv._epilogue_vectors(torch.from_numpy(x), kt,
                                         None if b is None else torch.from_numpy(b),
                                         None if ap is None else torch.from_numpy(ap))
    want = _jax(x, k, b, ap, act)
    for xt in (torch.from_numpy(x), torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
               .permute(0, 2, 3, 1)):
        acc = _wide_f32_emulation(xt, kt, 3).float()
        got = conv._activate(acc + bias, act, slope).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=_f32_bar(want, shape[3]))


@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("shape,act", [
    ((2, 16, 12, 64, 72), "relu"),     # a whole chunk, Cout past BN 64
    ((1, 8, 20, 80, 40), "prelu"),     # a chunk and a ragged one
    ((3, 8, 8, 24, 130), "lrelu")])    # 8 x 8 images, Cout past BN 128
def test_wide_f32_matches_jax_kernel(shape, act, passes):
    """The wide_f32 kernel's shapes: the plain version, which the wrapper
    runs on the CPU, and the kernel's operands through its GEMM (x gathered
    where it lies, NHWC memory) give the JAX kernel's result (interpret
    mode) within ``_f32_bar`` at 3 passes, and the float64 sum of the JAX
    kernel's split products at 1 and 2 passes (the JAX kernel runs 3 only)
    within the same bar."""
    x, k, b, ap = _inputs(shape, act, seed=30 + passes)
    want = (_jax(x, k, b, ap, act) if passes == 3
            else _float64_passes(x, k, b, act, ap, passes))
    bar = _f32_bar(want, shape[3])
    kt, bt = torch.from_numpy(k), torch.from_numpy(b)
    at = None if ap is None else torch.from_numpy(ap)
    plain = conv.conv3x3_bias_act(torch.from_numpy(x), kt, bt, at, act_fn=act, passes=passes)
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=bar)
    bias, slope = conv._epilogue_vectors(plain, kt, bt, at)
    acc = _wide_f32_emulation(torch.from_numpy(x), kt, passes).float()
    np.testing.assert_allclose(conv._activate(acc + bias, act, slope).numpy(), want, rtol=0,
                               atol=bar)


@pytest.mark.parametrize("name", ["whole", "no_mma", "no_split", "no_loads", "no_wloads",
                                  "stores_only"])
def test_wide_f32_ablation_cuts_find_their_lines(name):
    """``studies/narrow_ablation.py --kernel wide_f32`` cuts parts of the
    wide_f32 kernel out of a copy of ``csrc/conv.cu`` by pattern: each cut
    still finds its lines (else it raises), gives a source of its own and
    leaves the other kernels whole; a cut of the weights' loads keeps the
    ring's barrier (its producer arrives with no bytes to wait for)."""
    from resdepth_tpu_torch.studies import narrow_ablation

    with open(os.path.join(build.CSRC, "conv.cu")) as f:
        source = f.read()
    cuts = narrow_ablation.cut_sources(source, "wide_f32")
    assert (cuts[name] == source) == (name == "whole")
    assert len(cuts[name]) <= len(source) and len(set(cuts.values())) == len(cuts)
    assert "conv3x3_k3_wide_f32_kernel" in cuts[name]
    others = source[:source.index("namespace wide_f32 {")]
    assert cuts[name].startswith(others)
    if name in ("no_wloads", "stores_only"):
        assert "mbar_expect_tx(wfull(ws), 0);" in cuts[name]
        assert "mbar_wait(wfull(ws)" in cuts[name]
