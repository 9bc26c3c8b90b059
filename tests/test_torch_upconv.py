"""The float32 decoder's upconv (``resdepth_tpu_torch.ops.upconv``) on the CPU.

Its plain version is what the CPU forward runs and what the CUDA kernel
(``csrc/upconv.cu``) is held to on the card (``chip_smoke.py --phase
upconv``). Here the plain version is held, bitwise, to the decoder's chain
before the kernel (``skip + models/unet.py::_upconv_at``), the UNet's
forward at ``fast32``, ``act2pass`` and ``balanced`` to the forward with the
decoder as it was, and the dispatch to the one case the kernel serves: eval,
float32, a pass count, a transposed conv, no gradient. The wrapper's
refusals and its launch on meta tensors against a fake library are checked
without CUDA.
"""

from __future__ import annotations

import re

import pytest
import torch
from torch import nn

from benchmark.counts import kernels
from resdepth_tpu_torch.models import unet
from resdepth_tpu_torch.ops import build, epilogue, upconv

H, D = unet.Precision.HIGH, unet.Precision.DEFAULT
PRECISIONS = {1: D, 2: (H, D), 3: H}


def _draw(shape, seed):
    g = torch.Generator().manual_seed(seed)
    t = torch.randn(shape, generator=g)
    t.view(-1)[::7] = -0.0
    return t


def _module(c_in, c_out, seed, bias=True):
    g = torch.Generator().manual_seed(seed)
    m = nn.ConvTranspose2d(c_in, c_out, 2, stride=2, bias=bias)
    with torch.no_grad():
        m.weight.copy_(torch.randn(m.weight.shape, generator=g) / (2 * c_in ** 0.5))
        if bias:
            m.bias.copy_(0.1 * torch.randn(c_out, generator=g))
    return m


def _nchw_args(n, c_in, c_out, h, w, seed):
    """x (N, Cin, H, W) and skip (N, Cout, 2H, 2W) in channels-last memory,
    as K3 hands them to the decoder on the card."""
    x = _draw((n, c_in, h, w), seed).contiguous(memory_format=torch.channels_last)
    skip = _draw((n, c_out, 2 * h, 2 * w), seed + 1).contiguous(
        memory_format=torch.channels_last)
    return x, skip


@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("shape,bias", [((2, 8, 8, 5, 3), True), ((1, 13, 6, 4, 7), False)])
def test_plain_is_the_parents_chain(passes, shape, bias):
    """The plain version on NHWC views is bitwise ``skip + _upconv_at``."""
    n, c_in, c_out, h, w = shape
    module = _module(c_in, c_out, seed=passes, bias=bias)
    x, skip = _nchw_args(n, c_in, c_out, h, w, seed=10 * passes)
    with torch.no_grad():
        want = skip + unet._upconv_at(module, x, PRECISIONS[passes])
        got = upconv.upconv2x2_skip(x.permute(0, 2, 3, 1), module.weight, module.bias,
                                    skip.permute(0, 2, 3, 1), passes)
    assert got.shape == (n, 2 * h, 2 * w, c_out)
    assert torch.equal(got.permute(0, 3, 1, 2).view(torch.int32), want.view(torch.int32))


def _parent_decoder(self, i, module, skip, x):
    """``_AtPrecision.decoder`` as it was before the upconv kernel."""
    if self.train or x.dtype != torch.bfloat16:
        return skip + unet._upconv_at(module, x, self._precision(f"up{i}"))
    return epilogue.skip_add_epilogue(*unet._upconv_bf16(module, x), skip)


def _model(folded=True, up_mode="transpose", seed=0):
    config = unet.UNetConfig(n_input_channels=1, start_kernel=4, max_filter_depth=16,
                             depth=3, up_mode=up_mode)
    model = unet.init_unet(config, torch.Generator().manual_seed(seed), "cpu")
    return unet.fold_serving(model) if folded else model


@pytest.fixture
def spy(monkeypatch):
    """Each call of the op as (x's shape, passes), the op still run."""
    calls, real = [], upconv.upconv2x2_skip

    def recorded(x, weight, bias, skip, passes):
        calls.append((tuple(x.shape), passes))
        return real(x, weight, bias, skip, passes)

    monkeypatch.setattr(upconv, "upconv2x2_skip", recorded)
    return calls


@pytest.mark.parametrize("mode", ["fast32", "act2pass", "balanced"])
@pytest.mark.parametrize("folded", [True, False])
def test_forward_is_the_parents(mode, folded, spy, monkeypatch):
    """``apply_unet`` at a float32 pass-count mode takes the op at every
    transposed upconv and is bitwise the forward with the parent's
    decoder."""
    model = _model(folded)
    x = _draw((2, 32, 32, 1), seed=3)
    kwargs = unet.serving_precision(mode).apply_kwargs()
    with torch.inference_mode():
        got = unet.apply_unet(model, x, **kwargs)
        monkeypatch.setattr(unet._AtPrecision, "decoder", _parent_decoder)
        want = unet.apply_unet(model, x, **kwargs)
    assert len(spy) == (2 if folded else 3)       # depth 3: the composed top folds one
    assert {p for _, p in spy} == {2 if mode == "act2pass" else 1}
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _apply(case, model):
    x = _draw((2, 32, 32, 1), seed=5)
    if case == "float32":
        return unet.apply_unet(model, x)
    if case == "bf16_storage":
        return unet.apply_unet(model.to(torch.bfloat16), x.to(torch.bfloat16))
    if case == "high":          # a layer without a precision: HIGH, 3 passes
        return unet.apply_unet(model, x, layer_precisions={"encoder0": D})
    if case.startswith("train_"):
        y, _ = unet.apply_unet(model, x, train=True,
                               **unet.serving_precision(case[6:]).apply_kwargs())
        return y
    return unet.apply_unet(model, x, **unet.serving_precision(case).apply_kwargs())


@pytest.mark.parametrize("case,up_mode,grad,want", [
    ("balanced", "transpose", False, [1, 1]),
    ("act2pass", "transpose", False, [2, 2]),
    ("high", "transpose", False, [3, 3]),
    ("balanced", "transpose", True, []),          # eval that needs a gradient
    ("train_balanced", "transpose", True, []),
    ("train_balanced", "transpose", False, []),   # training under no_grad
    ("float32", "transpose", False, []),          # HIGHEST: IEEE float32
    ("balanced16", "transpose", False, []),       # the bf16 trunk's epilogue
    ("mixed", "transpose", False, []),
    ("bf16_storage", "transpose", False, []),
    ("balanced", "bilinear", False, []),
])
def test_dispatch(case, up_mode, grad, want, spy):
    """The op runs exactly at eval, float32, a pass count, a transposed
    conv and no gradient, at the layer's pass count."""
    model = _model(up_mode=up_mode)
    if case.startswith("train_"):
        model = _model(folded=False, up_mode=up_mode)
    with torch.set_grad_enabled(grad):
        _apply(case, model)
    assert [p for _, p in spy] == want


@pytest.mark.parametrize("change,match", [
    (dict(x=torch.zeros(2, 3, 5, 8, dtype=torch.float64)), "float32 x"),
    (dict(skip=torch.zeros(2, 6, 10, 6, dtype=torch.bfloat16)), "float32 skip"),
    (dict(weight=torch.zeros(8, 6, 2, 2, dtype=torch.float16)), "float32 weight"),
    (dict(x=torch.zeros(3, 5, 8)), r"x \(N, H, W, Cin\)"),
    (dict(weight=torch.zeros(7, 6, 2, 2)), r"weight \(Cin, Cout, 2, 2\)"),
    (dict(weight=torch.zeros(8, 6, 3, 3)), r"weight \(Cin, Cout, 2, 2\)"),
    (dict(skip=torch.zeros(2, 6, 10, 5)), r"skip must have shape \(2, 6, 10, 6\)"),
    (dict(skip=torch.zeros(2, 5, 10, 6)), r"skip must have shape \(2, 6, 10, 6\)"),
    (dict(bias=torch.zeros(5)), r"bias must have shape \(6,\)"),
    (dict(passes=4), "passes must be one of"),
    (dict(passes=None), "passes must be one of"),
])
def test_refusals(change, match):
    args = dict(x=torch.zeros(2, 3, 5, 8), weight=torch.zeros(8, 6, 2, 2),
                bias=torch.zeros(6), skip=torch.zeros(2, 6, 10, 6), passes=1)
    args.update(change)
    with pytest.raises(ValueError, match=match):
        upconv.upconv2x2_skip(**args)


def test_kernel_demands():
    """The kernel's own demands, checked before any launch: a CUDA device
    and contiguous NHWC memory."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        upconv.upconv2x2_skip(torch.empty(2, 3, 5, 8, **meta), torch.empty(8, 6, 2, 2, **meta),
                              None, torch.empty(2, 6, 10, 6, **meta), 1)
    x = torch.zeros(2, 8, 3, 5).permute(0, 2, 3, 1)       # the NHWC view of NCHW memory
    with pytest.raises(ValueError, match="contiguous .N, H, W, C., NHWC memory"):
        upconv.check_layout(x, "x")
    with pytest.raises(ValueError, match="contiguous"):
        upconv.check_layout(torch.zeros(2, 6, 10, 12)[..., ::2], "skip")
    upconv.check_layout(x.contiguous(), "x")


class _FakeLibrary:
    def __init__(self):
        self.calls, self.code = [], 0

    def upconv2x2_skip(self, *args):
        self.calls.append(args)
        return self.code

    def upconv_error_string(self, code):
        return b"invalid configuration argument"


@pytest.fixture
def fake_library(monkeypatch):
    class FakeStream:
        cuda_stream = 0

    lib = _FakeLibrary()
    real = upconv._check_cuda_args

    def meta_is_cuda(x, weight, bias, skip):
        assert x.device.type == "meta"
        with pytest.raises(ValueError, match="CUDA tensors"):
            real(x, weight, bias, skip)
        upconv.check_layout(x, "x")
        upconv.check_layout(skip, "skip")

    monkeypatch.setattr(upconv, "_check_cuda_args", meta_is_cuda)
    monkeypatch.setattr(upconv, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: FakeStream())
    for key in upconv.LAUNCHES:
        monkeypatch.setitem(upconv.LAUNCHES, key, 0)
    return lib


@pytest.mark.parametrize("passes", [1, 2, 3])
def test_launch_arguments(fake_library, passes):
    """One entry call a call (the split and the upconv): the weights'
    strides, N H W Cin Cout and passes as the kernel takes them, a new
    contiguous NHWC output, the counters."""
    x = torch.empty(3, 5, 7, 24, device="meta")
    weight = torch.empty(24, 40, 2, 2, device="meta")
    skip = torch.empty(3, 10, 14, 40, device="meta")
    out = upconv.upconv2x2_skip(x, weight, torch.zeros(40), skip, passes)
    assert out.shape == (3, 10, 14, 40) and out.dtype == torch.float32 and out.is_contiguous()
    args = fake_library.calls[-1]
    assert args[2:6] == (160, 4, 2, 1)
    assert args[10:16] == (3, 5, 7, 24, 40, passes)
    assert upconv.LAUNCHES == {"upconv": 1, "upconv_split": 1,
                               **{f"upconv_p{p}": int(p == passes) for p in (1, 2, 3)}}
    upconv.upconv2x2_skip(x, weight, None, skip, passes)
    assert fake_library.calls[-1][6] is None                  # no bias
    assert upconv.scratch_bytes(24, 40, passes) == 160 * 32 * 2 * (2 if passes == 3 else 1) + 640


def test_launch_failure_and_size_raise(fake_library):
    x, weight = torch.empty(1, 4, 4, 8, device="meta"), torch.empty(8, 8, 2, 2, device="meta")
    skip = torch.empty(1, 8, 8, 8, device="meta")
    fake_library.code = 9
    with pytest.raises(RuntimeError, match="failed to launch: invalid configuration"):
        upconv.upconv2x2_skip(x, weight, None, skip, 1)
    fake_library.code = 0
    with pytest.raises(ValueError, match="contiguous"):
        upconv.upconv2x2_skip(x, weight, None, torch.empty(1, 8, 8, 16, device="meta")[..., ::2],
                              1)
    assert upconv.LAUNCHES["upconv"] == 0


def test_kernel_source_and_names():
    """The library is csrc/upconv.cu, hashed with the nvcc flags, and its
    kernels' names hold no fragment by which the benchmark groups K3, the
    stitch or cuDNN's convs (``benchmark/counts/kernels.py``), so that no
    roofline's time takes them in."""
    path = build.library_path("upconv")
    assert path.startswith(build.BUILD_DIR) and "libupconv_" in path
    with open(f"{build.CSRC}/upconv.cu") as f:
        names = re.findall(r"__global__ void __launch_bounds__\([\w, ]+\)\s+(\w+)", f.read())
    assert names == ["transposed2x2_skip_kernel", "transposed2x2_split_kernel"]
    for demangled in (
            "void (anonymous namespace)::up2x2::transposed2x2_skip_kernel<1>(CUtensorMap_st, "
            "CUtensorMap_st, CUtensorMap_st, float const*, float const*, float const*, float*, "
            "(anonymous namespace)::up2x2::Geometry, int, int)",
            "(anonymous namespace)::up2x2::transposed2x2_split_kernel(float const*, long long, "
            "long long, long long, long long, float const*, int, int, int, __nv_bfloat16*, "
            "__nv_bfloat16*, float*)"):
        assert kernels.group_of(demangled) == "other"
