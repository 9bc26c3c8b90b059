"""Port of kernel K3 (resdepth_tpu_torch.ops.conv) against the JAX Pallas
``conv3x3_bias_act`` in interpret mode, as ``tests/test_pallas_conv.py``
runs it.

On the CPU the wrapper runs its plain version (``F.conv2d`` + bias + act),
the yardstick the CUDA kernel is held against on the card
(``chip_smoke.py`` phase 6). Tolerance against the JAX kernel: rtol 1e-3,
atol 5e-5 in f32, the bar of ``test_pallas_conv.py`` (the TPU kernel's f32
is a 3-pass bf16 split, about 1e-5 from exact f32); in bf16, 2 bf16 ulps
at the output's largest magnitude (both round the f32 sum to bf16 once;
the plain version also rounds the conv before the bias).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resdepth_tpu.ops.pallas_conv import conv3x3_bias_act as jax_conv
from resdepth_tpu_torch.ops import build
from resdepth_tpu_torch.ops import conv

F32 = dict(rtol=1e-3, atol=5e-5)


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
])
def test_plain_matches_jax_kernel(shape, act):
    inputs = _inputs(shape, act)
    got = _torch(*inputs, act)
    assert got.shape == shape[:3] + (shape[4],) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax(*inputs, act), **F32)


def test_plain_matches_jax_kernel_multi_row_blocks():
    """The JAX kernel over several row programs per image; the flagship
    first layer's 3 input channels; no bias (zeros)."""
    inputs = _inputs((2, 32, 16, 3, 8), "relu", seed=3, bias=False)
    np.testing.assert_allclose(_torch(*inputs, "relu").numpy(),
                               _jax(*inputs, "relu"), **F32)


def test_plain_bfloat16_matches_jax_kernel():
    inputs = _inputs((2, 16, 16, 8, 16), "lrelu", seed=5)
    got = _torch(*inputs, "lrelu", dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = _jax(*inputs, "lrelu", dtype=jnp.bfloat16)
    bar = 2 * float(torch.finfo(torch.bfloat16).eps) * 2.0 ** np.floor(
        np.log2(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=bar)


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
    assert calls[0][5:12] == (2, 16, 16, 4, 8, 3, 0)   # N H W Cin Cout act dtype
    lib.code = 1
    with pytest.raises(RuntimeError, match="K3 failed to launch"):
        conv.conv3x3_bias_act(x, k)
    assert conv.LAUNCHES["k3"] == before + 1


def test_kernel_source_is_built_by_name():
    """K3's library is csrc/conv.cu, hashed with the nvcc flags."""
    path = build.library_path("conv")
    assert path.startswith(build.BUILD_DIR) and "libconv_" in path
