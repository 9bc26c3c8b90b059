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

The CUDA path's operands (``kernel_operands``: Cin zero-padded to a
multiple of 16, weights re-laid as (9, Cout, Cin_p), the float32 hi/lo
split) are held against JAX too, through the kernel's GEMM written out in
float64 here, at channel counts that need the padding (Cin 1, 2, 3, 4 and
5, Cout 7 and 64: the first convs of the channel modes among them).
"""

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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,act", [
    ((2, 16, 16, 3, 7), "relu"), ((1, 16, 16, 5, 7), "prelu"),
    ((1, 16, 32, 16, 8), "lrelu"), ((1, 16, 16, 20, 64), "none"),
    ((2, 16, 16, 1, 64), "relu"), ((2, 16, 16, 2, 64), "relu"),
    ((2, 16, 16, 4, 64), "relu")])
def test_kernel_operands_match_jax_kernel(shape, act, dtype):
    """The operands the CUDA path hands K3 (Cin padded to 16, weights re-laid
    (9, Cout, Cin_p), the float32 split) give the JAX kernel's result
    through the kernel's GEMM."""
    x, k, b, ap = _inputs(shape, act, seed=8)
    tdtype = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdtype)
    x_hi, x_lo, w_hi, w_lo = conv.kernel_operands(xt, torch.from_numpy(k))
    c_in_p = -(-shape[3] // 16) * 16
    assert x_hi.dtype == w_hi.dtype == torch.bfloat16
    assert x_hi.shape == shape[:3] + (c_in_p,) and w_hi.shape == (9, shape[4], c_in_p)
    assert not x_hi[..., shape[3]:].any() and not w_hi[..., shape[3]:].any()
    assert (x_lo is None) == (dtype == "bfloat16")
    bias, slope = conv._epilogue_vectors(xt, torch.from_numpy(k),
                                         None if b is None else torch.from_numpy(b),
                                         None if ap is None else torch.from_numpy(ap))
    acc = _gemm_from_operands(x_hi, x_lo, w_hi, w_lo).float()
    got = conv._activate(acc + bias, act, slope).to(tdtype).float().numpy()
    want = _jax(x, k, b, ap, act, dtype=getattr(jnp, dtype))
    bar = _f32_bar(want, shape[3]) if dtype == "float32" else _bf16_bar(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=bar)


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
    x = torch.empty((2, 16, 16, 4), device="meta")
    k = torch.empty((3, 3, 4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv.conv3x3_bias_act(x, k)

    calls = []

    class FakeLibrary:
        code = 0

        def conv3x3_k3(self, *args):
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
    assert out.shape == (2, 16, 16, 8) and conv.LAUNCHES["k3"] == before + 1
    assert calls[0][7:14] == (2, 16, 16, 16, 8, 3, 0)  # N H W Cin_p Cout act dtype
    lib.code = 1
    with pytest.raises(RuntimeError, match="K3 failed to launch"):
        conv.conv3x3_bias_act(x, k)
    assert conv.LAUNCHES["k3"] == before + 1


def test_kernel_source_is_built_by_name():
    """K3's library is csrc/conv.cu, hashed with the nvcc flags."""
    path = build.library_path("conv")
    assert path.startswith(build.BUILD_DIR) and "libconv_" in path
