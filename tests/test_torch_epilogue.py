"""The bf16 trunk's epilogue (``resdepth_tpu_torch.ops.epilogue``) on the CPU.

Its plain version is what the CPU forward runs and what the CUDA kernel
(``csrc/epilogue.cu``) is held to on the card, bitwise
(``chip_smoke.py --phase epilogue``). Here the plain version is held,
bitwise, to the separate ops the UNet ran after each bf16 conv before they
were fused (``models/unet.py``'s ``_add_bias``, ``_activate_nchw``, the
trunk's ``.to(torch.bfloat16)``, ``nn.MaxPool2d(2, 2)`` and the decoder's
``skip + up``), with NaN, +-inf and -0.0 in every input and odd sizes;
the wrapper's refusals and its launch on meta tensors against a fake
library are checked without CUDA.
"""

from __future__ import annotations

import re

import pytest
import torch
from torch import nn

from benchmark.counts import kernels
from resdepth_tpu_torch.models import unet
from resdepth_tpu_torch.ops import build, epilogue

SHAPES = [(2, 8, 6, 4), (2, 16, 7, 9), (1, 5, 5, 3)]   # (N, C, H, W): even, odd, C % 8
ACTS = ["relu", "lrelu", "prelu", "none"]


def _nhwc(t):
    return t.contiguous(memory_format=torch.channels_last)


def _draw(shape, dtype, seed):
    """Seeded (N, C, H, W) values in channels-last memory with NaN, +-inf
    and -0.0 planted, and -0.0 on a grid of channel 0."""
    g = torch.Generator().manual_seed(seed)
    t = torch.randn(shape, generator=g)
    flat = t.view(-1)
    spots = torch.randperm(flat.numel(), generator=g)[:8]
    flat[spots] = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0]).repeat(2)
    t[:, 0, ::2, ::3] = -0.0
    return _nhwc(t.to(dtype))


def _vectors(c, seed):
    g = torch.Generator().manual_seed(seed)
    bias = 0.1 * torch.randn(c, generator=g)
    bias[0] = -0.0
    return bias, 0.3 * torch.rand(c, generator=g)


def _bits(t):
    return t.contiguous().view(torch.int16)


def _same_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(_bits(got), _bits(want))


def _parent_block(y, bias, slope, act_fn, pool):
    """The separate ops of the UNet's bf16 block before the fusion: the
    bias in bf16, the activation, the trunk's cast, the level's pool."""
    skip = unet._activate_nchw(unet._add_bias(y, bias), act_fn, slope)
    skip = skip.to(torch.bfloat16)
    return skip, nn.MaxPool2d(2, 2)(skip) if pool else None


@pytest.mark.parametrize("pool", [False, True], ids=["no_pool", "pool"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("act_fn", ACTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_block_matches_the_parent_ops(shape, act_fn, with_bias, pool):
    y = _draw(shape, torch.bfloat16, seed=1)
    bias, slope = _vectors(shape[1], seed=2)
    bias = bias if with_bias else None
    slope = slope if act_fn == "prelu" else None
    got = epilogue.trunk_epilogue(y, bias, slope, act_fn=act_fn, pool=pool)
    want = _parent_block(y, bias, slope, act_fn, pool)
    _same_bits(got[0], want[0])
    if pool:
        _same_bits(got[1], want[1])
    else:
        assert got[1] is None
    assert torch.isnan(got[0].float()).any() and torch.isinf(got[0].float()).any()


def test_lrelu_and_prelu_round_as_the_parent():
    """LeakyReLU is ``bf16(0.01 * v)`` in float, PReLU's slope is rounded
    to bf16 before its product: values where the two orders differ."""
    y = _nhwc(-torch.linspace(0.5, 300.0, 8 * 64).reshape(1, 8, 8, 8).to(torch.bfloat16))
    slope = torch.full((8,), 0.3001)
    for act_fn, s in (("lrelu", None), ("prelu", slope)):
        got = epilogue.trunk_epilogue(y, None, s, act_fn=act_fn)[0]
        _same_bits(got, _parent_block(y, None, s, act_fn, False)[0])
    unrounded = (y.float() * slope.view(-1, 1, 1)).to(torch.bfloat16)
    assert not torch.equal(_bits(got), _bits(unrounded))


@pytest.mark.parametrize("pool", [False, True], ids=["no_pool", "pool"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cast_matches_the_parent_ops(shape, pool):
    """A float32 encoder0 output (K3 applied bias and activation): the
    trunk's cast, then the pool."""
    y = _draw(shape, torch.float32, seed=3)
    got = epilogue.trunk_epilogue(y, pool=pool)
    skip = y.to(torch.bfloat16)
    _same_bits(got[0], skip)
    if pool:
        _same_bits(got[1], nn.MaxPool2d(2, 2)(skip))


@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_skip_add_matches_the_parent_ops(shape, with_bias):
    """The upsampling's bias in bf16, then the decoder's additive skip."""
    u, skip = _draw(shape, torch.bfloat16, seed=4), _draw(shape, torch.bfloat16, seed=5)
    bias = _vectors(shape[1], seed=6)[0] if with_bias else None
    got = epilogue.skip_add_epilogue(u, bias, skip)
    _same_bits(got, skip + unet._add_bias(u, bias))


def test_pool_floors_odd_sizes_and_propagates_nan():
    """``nn.MaxPool2d(2, 2)``'s rule: an odd last row and column are
    dropped; a NaN in a quad wins it, as does +inf over finite values."""
    y = _nhwc(torch.zeros((1, 8, 5, 7), dtype=torch.bfloat16))
    y[0, :, 4, :] = 9.0          # the dropped last row
    y[0, :, :, 6] = 9.0          # the dropped last column
    y[0, 0, 0, 1] = float("nan")
    y[0, 1, 3, 2] = float("inf")
    skip, pooled = epilogue.trunk_epilogue(y, act_fn="none", pool=True)
    assert pooled.shape == (1, 8, 2, 3)
    assert torch.isnan(pooled[0, 0, 0, 0]) and pooled[0, 1, 1, 1] == float("inf")
    assert not (pooled.float() == 9.0).any()
    _same_bits(skip, y)


def test_refusals():
    y = _draw((1, 8, 4, 4), torch.bfloat16, seed=7)
    bias, slope = _vectors(8, seed=8)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        epilogue.trunk_epilogue(y.half())
    with pytest.raises(ValueError, match="N, C, H, W"):
        epilogue.trunk_epilogue(y[0])
    with pytest.raises(ValueError, match="float32 y is only cast"):
        epilogue.trunk_epilogue(y.float(), bias)
    with pytest.raises(ValueError, match="float32 y is only cast"):
        epilogue.trunk_epilogue(y.float(), act_fn="relu")
    with pytest.raises(ValueError, match="prelu needs"):
        epilogue.trunk_epilogue(y, bias, act_fn="prelu")
    with pytest.raises(ValueError, match=r"bias must have shape \(8,\)"):
        epilogue.trunk_epilogue(y, bias[:4])
    with pytest.raises(ValueError, match=r"slope must have shape \(8,\)"):
        epilogue.trunk_epilogue(y, bias, slope[:3], act_fn="prelu")
    with pytest.raises(ValueError, match="one \\(N, C, H, W\\) shape"):
        epilogue.skip_add_epilogue(y, bias, y[:, :, :2])
    with pytest.raises(ValueError, match="bfloat16 u and skip"):
        epilogue.skip_add_epilogue(y, bias, y.float())
    # the kernel's own demands, checked before any launch
    with pytest.raises(ValueError, match="CUDA tensors"):
        epilogue.trunk_epilogue(torch.empty((1, 8, 4, 4), dtype=torch.bfloat16,
                                            device="meta"))
    epilogue.check_layout(y, "y")
    with pytest.raises(ValueError, match="channels-last contiguous"):
        epilogue.check_layout(y.contiguous(), "y")
    with pytest.raises(ValueError, match="channels-last contiguous"):
        epilogue.check_layout(y[:, :, :, ::2], "y")


class _FakeLibrary:
    def __init__(self):
        self.calls, self.code = [], 0

    def trunk_epilogue(self, *args):
        self.calls.append(args)
        return self.code

    def epilogue_error_string(self, code):
        return b"invalid configuration argument"


@pytest.fixture
def fake_library(monkeypatch):
    class FakeStream:
        cuda_stream = 0

    lib = _FakeLibrary()
    real = epilogue._check_cuda_args

    def meta_is_cuda(x, skip):
        assert x.device.type == "meta"
        with pytest.raises(ValueError, match="CUDA tensors"):
            real(x, skip)

    monkeypatch.setattr(epilogue, "_check_cuda_args", meta_is_cuda)
    monkeypatch.setattr(epilogue, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: FakeStream())
    return lib


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta", memory_format=torch.channels_last)


@pytest.mark.parametrize("act_fn,act", [("relu", 1), ("lrelu", 2), ("prelu", 3), ("none", 0)])
def test_launch_arguments(fake_library, act_fn, act):
    """One launch a call: mode, activation code, pool, vector width, the
    outputs' shapes and N H W C as the kernel takes them."""
    y, bias = _meta((3, 16, 7, 9)), torch.zeros(16)
    slope = torch.ones(16) if act_fn == "prelu" else None
    before = epilogue.LAUNCHES["epilogue"]
    skip, pooled = epilogue.trunk_epilogue(y, bias, slope, act_fn=act_fn, pool=True)
    assert skip.shape == (3, 16, 7, 9) and pooled.shape == (3, 16, 3, 4)
    assert skip.dtype == pooled.dtype == torch.bfloat16
    assert skip.is_contiguous(memory_format=torch.channels_last)
    args = fake_library.calls[-1]
    assert args[:4] == (0, act, 1, 8) and args[10:14] == (3, 7, 9, 16)
    assert (args[7] is None) == (act_fn != "prelu")       # slopes for prelu only
    assert epilogue.LAUNCHES["epilogue"] == before + 1

    skip, pooled = epilogue.trunk_epilogue(_meta((2, 12, 4, 4), torch.float32))
    assert pooled is None and fake_library.calls[-1][:4] == (1, 0, 0, 1)   # C 12: vec 1
    out = epilogue.skip_add_epilogue(_meta((2, 24, 8, 8)), None, _meta((2, 24, 8, 8)))
    assert out.shape == (2, 24, 8, 8) and fake_library.calls[-1][:4] == (2, 0, 0, 8)
    assert fake_library.calls[-1][6] is None               # no bias
    assert epilogue.LAUNCHES["epilogue"] == before + 3


def test_launch_failure_and_size_raise(fake_library):
    before = epilogue.LAUNCHES["epilogue"]
    fake_library.code = 9
    with pytest.raises(RuntimeError, match="failed to launch: invalid configuration"):
        epilogue.trunk_epilogue(_meta((1, 8, 4, 4)), act_fn="relu")
    fake_library.code = 0
    with pytest.raises(ValueError, match="too large for one epilogue launch"):
        epilogue.trunk_epilogue(_meta((1024, 64, 1024, 1024)), act_fn="relu")
    with pytest.raises(ValueError, match="non-empty"):
        epilogue.trunk_epilogue(_meta((0, 8, 4, 4)), act_fn="relu")
    assert epilogue.LAUNCHES["epilogue"] == before


def test_kernel_source_and_name():
    """The library is csrc/epilogue.cu, hashed with the nvcc flags, and its
    kernel's name holds no fragment by which the benchmark groups K3, the
    stitch or cuDNN's convs (``benchmark/counts/kernels.py``)."""
    path = build.library_path("epilogue")
    assert path.startswith(build.BUILD_DIR) and "libepilogue_" in path
    with open(f"{build.CSRC}/epilogue.cu") as f:
        names = re.findall(r"__global__ void __launch_bounds__\(\w+\)\s+(\w+)", f.read())
    assert names == ["trunk_epilogue_kernel"]
    demangled = ("void (anonymous namespace)::trunk_epilogue_kernel<0, 1, true, 8>(void "
                 "const*, unsigned short const*, float const*, float const*, unsigned "
                 "short*, unsigned short*, int, int, int, unsigned int)")
    assert kernels.group_of(demangled) == "other"
