"""The string serving modes of the port (``mixed``, ``fast32``, ``act2pass``,
``balanced``, ``balanced16``) against the JAX package's, on the CPU.

The JAX package defines each mode in TPU MXU passes; the port runs them as
explicit bf16 product passes with float32 sums (``ops/passes.py``; the 3x3
convs through kernel K3's wrapper, whose plain version runs here).

* The mode table: the port's ``serving_precision`` is the JAX one with each
  precision mapped to its pass count.
* K3's plain version at 1, 2 and 3 passes against a float64 numpy sum of
  the same split products: rtol 1e-6, and atol 1e-6 of the largest output
  (an f32 sum of 27·Cin exact products, in another order, near outputs
  that cancel to about zero); at 3 passes also against the JAX Pallas
  kernel in interpret mode, at ``tests/test_torch_conv.py``'s bar.
* Graph parity: the port's ``apply_unet`` with a mode's kwargs and every
  layer at HIGHEST against the JAX ``apply_unet`` with that mode's kwargs.
  XLA:CPU runs every precision as exact float32, so the f32-storage modes
  are held at rtol 1e-5, atol 1e-4, and the bf16-trunk modes at 4e-3 max,
  1e-4 mean, inside the bar of ``test_bfloat16_close_to_jax_bfloat16``
  (0.05 max, 2e-3 mean).
* The scene: ``predict_linear_blend(compute_dtype=mode)`` with real passes
  against the JAX scene of the mode (exact f32 on XLA:CPU), the CLI at
  ``balanced16``, and the K3 calls a forward makes.
* The bf16 trunk's epilogue (``ops/epilogue.py``): the calls an eval
  forward on the bf16 trunk makes, none off it, and the forward's bits
  with the entries swapped for the separate ops they fuse.
"""

import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from resdepth_tpu.infer import tiled as jtiled
from resdepth_tpu.models import unet as junet
from resdepth_tpu.ops.pallas_conv import conv3x3_bias_act as jax_conv
from resdepth_tpu_torch import predict
from resdepth_tpu_torch.geo.raster import open_raster
from resdepth_tpu_torch.infer import tiled as ttiled
from resdepth_tpu_torch.models import unet as tunet
from resdepth_tpu_torch.models import weights
from resdepth_tpu_torch.ops import conv, epilogue, passes
from resdepth_tpu_torch.studies import precision_study
from test_torch_conv import _f32_bar
from test_torch_infer import _scene_datasets, _small_artifacts, _small_scene_models
from test_torch_unet import _input, _pair

MODES = tunet.SERVING_PRECISION_MODES
BF16_TRUNK = ("mixed", "balanced16")
F32 = dict(rtol=1e-5, atol=1e-4)
TILE = 16


def _jax_passes(precision):
    """Pass count of a JAX precision on float32 operands (None: unset)."""
    H, D = jax.lax.Precision.HIGH, jax.lax.Precision.DEFAULT
    if precision is None:
        return None
    return {D: 1, (H, D): 2, H: 3}[precision]


@pytest.mark.parametrize("mode", MODES)
def test_serving_table_matches_jax(mode):
    got, want = tunet.serving_precision(mode), junet.serving_precision(mode)
    assert (got.mixed, got.hifi_endpoints) == (want.mixed, want.hifi_endpoints)
    assert tunet.precision_passes(got.precision) == _jax_passes(want.precision)
    layers = {k: tunet.precision_passes(v) for k, v in (got.layer_precisions or {}).items()}
    assert layers == {k: _jax_passes(v) for k, v in (want.layer_precisions or {}).items()}
    assert set(got.apply_kwargs()) == set(want.apply_kwargs())
    assert tunet.SERVING_PRECISION_MODES == junet.SERVING_PRECISION_MODES


def _bf16(v):
    return torch.from_numpy(v).to(torch.bfloat16).float().numpy()


def _numpy_passes(x, k, b, n_passes):
    """The split products of ``n_passes`` bf16 passes summed in float64."""
    x_hi, w_hi = _bf16(x), _bf16(k)
    x_lo, w_lo = _bf16(x - x_hi), _bf16(k - w_hi)
    pairs = {1: [(x_hi, w_hi)], 2: [(x_hi, w_hi), (x_lo, w_hi)],
             3: [(x_hi, w_hi), (x_hi, w_lo), (x_lo, w_hi)]}[n_passes]
    n, h, w, _ = x.shape
    acc = np.zeros((n, h, w, k.shape[3]))
    for xs, ws in pairs:
        xp = np.pad(xs.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)))
        for dy in range(3):
            for dx in range(3):
                acc += xp[:, dy:dy + h, dx:dx + w] @ ws[dy, dx].astype(np.float64)
    return acc + b


def _conv_inputs(shape, seed):
    n, h, w, ci, co = shape
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, h, w, ci)) * 30.0).astype(np.float32)
    k = (rng.normal(size=(3, 3, ci, co)) * 0.1).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    return x, k, b


@pytest.mark.parametrize("shape", [(2, 16, 16, 3, 7), (1, 8, 16, 32, 16)],
                         ids=["cin3", "cin32"])
@pytest.mark.parametrize("n_passes", [1, 2, 3])
def test_plain_passes_match_float64_sum(n_passes, shape):
    x, k, b = _conv_inputs(shape, seed=n_passes)
    got = conv.conv3x3_bias_act(torch.from_numpy(x), torch.from_numpy(k),
                                torch.from_numpy(b), act_fn="none",
                                passes=n_passes).numpy()
    want = _numpy_passes(x, k, b, n_passes)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    if n_passes < 3:    # fewer passes are another function: not HIGH
        assert np.abs(want - _numpy_passes(x, k, b, 3)).max() > 1e-4


def test_plain_three_passes_match_jax_kernel():
    x, k, b = _conv_inputs((2, 16, 16, 5, 8), seed=9)
    got = conv.conv3x3_bias_act(torch.from_numpy(x), torch.from_numpy(k),
                                torch.from_numpy(b), act_fn="lrelu", passes=3)
    want = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), None,
                               act_fn="lrelu", block_rows=8, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_f32_bar(want, 5))


def test_passes_are_refused_where_they_mean_nothing():
    x, k, b = (torch.from_numpy(a) for a in _conv_inputs((1, 8, 8, 4, 4), seed=1))
    with pytest.raises(ValueError, match="float32"):
        conv.conv3x3_bias_act(x.to(torch.bfloat16), k, b, passes=1)
    for bad in (0, 4, 2.5):
        with pytest.raises(ValueError, match="passes"):
            conv.conv3x3_bias_act(x, k, b, passes=bad)
    with pytest.raises(ValueError, match="precision"):
        tunet.precision_passes((tunet.Precision.DEFAULT, tunet.Precision.HIGH))


@pytest.mark.parametrize("n_passes", [None, 1, 2, 3])
def test_upconv_passes_match_float64_sum(n_passes):
    """The transposed 2x2 upconv and the 1x1 conv of ``ops.passes`` sum
    the split products of their passes (None: IEEE float32)."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 6, 5, 7)) * 20.0).astype(np.float32)      # NCHW
    wt = (rng.normal(size=(6, 3, 2, 2)) * 0.2).astype(np.float32)
    w1 = (rng.normal(size=(3, 6, 1, 1)) * 0.2).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    if n_passes is None:
        xs = [(x, wt, w1)]
    else:
        x_hi, x_lo = _bf16(x), _bf16(x - _bf16(x))
        wt_hi, wt_lo = _bf16(wt), _bf16(wt - _bf16(wt))
        w1_hi, w1_lo = _bf16(w1), _bf16(w1 - _bf16(w1))
        xs = {1: [(x_hi, wt_hi, w1_hi)],
              2: [(x_hi, wt_hi, w1_hi), (x_lo, wt_hi, w1_hi)],
              3: [(x_hi, wt_hi, w1_hi), (x_hi, wt_lo, w1_lo),
                  (x_lo, wt_hi, w1_hi)]}[n_passes]
    want_t = sum(np.einsum("nchw,cokl->nohkwl", a.astype(np.float64), c.astype(np.float64))
                 for a, c, _ in xs).reshape(2, 3, 10, 14) + b[None, :, None, None]
    want_1 = sum(np.einsum("nchw,oc->nohw", a.astype(np.float64), c[:, :, 0, 0].astype(np.float64))
                 for a, _, c in xs) + b[None, :, None, None]
    got_t = passes.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(wt),
                                    torch.from_numpy(b), n_passes).numpy()
    got_1 = passes.conv2d(torch.from_numpy(x), torch.from_numpy(w1),
                          torch.from_numpy(b), n_passes).numpy()
    for got, want in ((got_t, want_t), (got_1, want_1)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def _folded_pair(up_mode, seed=0, folded=True):
    overrides = dict(up_mode=up_mode, act_fn_encoder="prelu", act_fn_decoder="lrelu")
    jconfig, params, state, model = _pair(3, overrides, seed=seed)
    if folded:
        jconfig, params, state = junet.fold_serving(jconfig, params, state)
        model = tunet.fold_serving(model)
    return jconfig, params, state, model


@pytest.mark.parametrize("up_mode", ["transpose", "bilinear"])
@pytest.mark.parametrize("mode", MODES)
def test_graph_matches_jax(mode, up_mode):
    """The mode's graph, every layer at HIGHEST, against the JAX graph of
    the mode (exact f32 convs on XLA:CPU): casts, endpoints and the
    composed top's branches, folded, depth 3, start 8."""
    jconfig, params, state, model = _folded_pair(up_mode)
    x = _input(3)
    want, _ = junet.apply_unet(jconfig, params, state, jnp.asarray(x), train=False,
                               **junet.serving_precision(mode).apply_kwargs())
    kwargs = dict(tunet.serving_precision(mode).apply_kwargs(),
                  precision=tunet.Precision.HIGHEST, layer_precisions=None)
    with torch.no_grad():
        got = tunet.apply_unet(model, torch.from_numpy(x), **kwargs).numpy()
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 32, 32, 1) and got.dtype == np.float32
    if mode in BF16_TRUNK:
        # within test_bfloat16_close_to_jax_bfloat16's bar (0.05 max, 2e-3
        # mean) by far: the trunk rounds where and as JAX rounds (the bias
        # after the conv's rounding, the resize one axis at a time), and the
        # gap measured 1.0e-6 / 1.6e-5 mean, 7.9e-5 / 8.5e-4 max (transpose
        # / bilinear)
        assert np.abs(got - want).max() <= 4e-3
        assert np.abs(got - want).mean() <= 1e-4
    else:
        np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("mode", ["balanced", "balanced16"])
def test_unfolded_graph_matches_jax(mode):
    """BatchNorm not folded: the conv at its precision, then BN in f32."""
    jconfig, params, state, model = _folded_pair("transpose", seed=2, folded=False)
    x = _input(3, seed=3)
    want, _ = junet.apply_unet(jconfig, params, state, jnp.asarray(x), train=False,
                               **junet.serving_precision(mode).apply_kwargs())
    kwargs = dict(tunet.serving_precision(mode).apply_kwargs(),
                  precision=tunet.Precision.HIGHEST, layer_precisions=None)
    with torch.no_grad():
        got = tunet.apply_unet(model, torch.from_numpy(x), **kwargs).numpy()
    if mode in BF16_TRUNK:
        assert np.abs(got - np.asarray(want)).mean() <= 2e-3
    else:
        np.testing.assert_allclose(got, np.asarray(want), **F32)


# Measured on this scene (weights seed 5, 35 tiles of 16 px at stride 8,
# heights near 410 m), mean / max |port - JAX| in m: mixed 1.8e-5 / 3.2e-3,
# fast32 1.9e-3 / 1.1e-2, act2pass 1.5e-3 / 7.8e-3, balanced 8.5e-5 /
# 8.9e-4, balanced16 1.4e-5 / 1.1e-3. The JAX side is exact f32 on XLA:CPU
# for the f32-storage modes, so their gap is the mode's own pass rounding
# (and equals their deviation from the JAX float32 scene); on the bf16
# trunk it is what the two frameworks' bf16 roundings leave of it. Each bar
# is twice the measured value, rounded up. The f32-storage modes must also
# deviate by at least half their measured mean (``SCENE_FLOORS``): a port
# that ran their convs exactly would miss it.
SCENE_BARS = {"mixed": (4e-5, 7e-3), "fast32": (4e-3, 2.5e-2),
              "act2pass": (3e-3, 1.6e-2), "balanced": (2e-4, 2e-3),
              "balanced16": (3e-5, 2.5e-3)}
SCENE_FLOORS = {"fast32": 9e-4, "act2pass": 7e-4, "balanced": 4e-5}


@pytest.mark.parametrize("mode", MODES)
def test_scene_matches_jax_mode(make_geotiff, mode):
    ds, jds = _scene_datasets(make_geotiff, TILE // 2)
    jconfig, params, state, model = _small_scene_models()
    want = np.asarray(jtiled.predict_linear_blend(jconfig, params, state, jds,
                                                  batch_size=5, use_pallas=False,
                                                  compute_dtype=mode))
    got = ttiled.predict_linear_blend(model, ds, device="cpu", batch_size=5,
                                      compute_dtype=mode)
    assert got.shape == want.shape and np.isfinite(got).all()
    diff = np.abs(got - want)
    mean_bar, max_bar = SCENE_BARS[mode]
    assert diff.mean() <= mean_bar and diff.max() <= max_bar, (diff.mean(), diff.max())
    assert diff.mean() >= SCENE_FLOORS.get(mode, 0.0), diff.mean()


# K3 calls a forward (the 3x3 convs with a pass count) of a folded
# transpose-mode UNet of depth d, in order, by their passes: the
# f32-storage modes all 2d + 2 (d encoder blocks, the bottleneck, d - 1
# decoder blocks, two top convs), at (encoder0, the rest, the top);
# balanced16 encoder0 and the two top convs; mixed the two top convs.
K3_PASSES = {"fast32": (1, 1, 1), "act2pass": (2, 2, 2), "balanced": (3, 1, 3)}


@pytest.mark.parametrize("mode", MODES)
def test_k3_calls_a_forward(monkeypatch, mode):
    _, _, _, model = _folded_pair("transpose", seed=1)
    calls = []
    k3 = tunet.conv3x3_bias_act

    def record(x, kernel, *args, passes=None, **kwargs):
        calls.append((tuple(kernel.shape), passes))
        return k3(x, kernel, *args, passes=passes, **kwargs)

    monkeypatch.setattr(tunet, "conv3x3_bias_act", record)
    with torch.no_grad():
        tunet.apply_unet(model, torch.from_numpy(_input(3)),
                         **tunet.serving_precision(mode).apply_kwargs())
    depth = model.config.depth
    if mode in K3_PASSES:
        first, body, top = K3_PASSES[mode]
        want = [first] + [body] * (2 * depth - 1) + [top, top]
    else:
        want = {"mixed": [1, 1], "balanced16": [3, 3, 3]}[mode]
    assert [p for _, p in calls] == want
    assert collections.Counter(want) == chip_smoke.k3_calls_a_forward(mode, depth)
    assert calls[-2][0][3] == 1 and calls[-1][0][3] == 4   # the top's two convs


def test_chip_smoke_traces_each_k3_conv():
    """Phase 6 of ``chip_smoke.py`` holds K3 at the convs the served
    flagship hands it (traced on meta tensors): one per block at widths 64 *
    2^i capped at 512, then the composed top's two, and each mode's pass
    counts."""
    widths = [(3, 64), (64, 128), (128, 256), (256, 512), (512, 512), (512, 512),
              (512, 512), (512, 256), (256, 128), (128, 64)]
    sizes = [256, 128, 64, 32, 16, 8, 16, 32, 64, 128]
    blocks = [(h, ci, co, "relu") for h, (ci, co) in zip(sizes, widths)]
    top = [(256, 64, 1, "none"), (128, 64, 4, "none")]
    assert chip_smoke.mode_k3_convs("fast32") == [s + (1,) for s in blocks + top]
    assert chip_smoke.mode_k3_convs("mixed") == [s + (1,) for s in top]
    assert [c[4] for c in chip_smoke.mode_k3_convs("balanced")] == [3] + [1] * 9 + [3, 3]
    cases = chip_smoke.k3_cases()
    assert list(cases) == list(dict.fromkeys(blocks + top))
    assert cases[(16, 512, 512, "relu")] == {1: 4, 2: 2, 3: 0}
    assert cases[(256, 3, 64, "relu")] == {1: 1, 2: 1, 3: 2}


def _parent_trunk(y, bias=None, slope=None, *, act_fn="none", pool=False):
    """The separate ops ``ops.epilogue.trunk_epilogue`` fuses, as the UNet
    ran them: the bias, the activation, the trunk's cast, the pool."""
    skip = tunet._activate_nchw(tunet._add_bias(y, bias), act_fn, slope).to(torch.bfloat16)
    return skip, torch.nn.MaxPool2d(2, 2)(skip) if pool else None


def _parent_skip_add(u, bias, skip):
    return skip + tunet._add_bias(u, bias)


def _count_epilogue(monkeypatch) -> list:
    """Record each call of the epilogue's two entries by name."""
    calls = []
    for name in ("trunk_epilogue", "skip_add_epilogue"):
        def counted(*args, _real=getattr(epilogue, name), _name=name, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(epilogue, name, counted)
    return calls


@pytest.mark.parametrize("folded", [True, False], ids=["folded", "unfolded"])
@pytest.mark.parametrize("up_mode", ["transpose", "bilinear"])
@pytest.mark.parametrize("mode", ["balanced16", "mixed", "bf16_compute"])
def test_epilogue_calls_a_forward(monkeypatch, mode, up_mode, folded):
    """An eval forward on the bf16 trunk of depth d hands the epilogue
    every conv's output: d encoder blocks (with the pool), the bottleneck,
    d - 1 decoder blocks and each upsampling with its skip: 3d - 1 with a
    composed top (folded, transpose), else 3d. With the entries swapped for
    the separate ops they fuse, the forward gives the same bits (unfolded:
    BatchNorm in float32 before the epilogue, which adds no bias)."""
    _, _, _, model = _folded_pair(up_mode, folded=folded)
    x = torch.from_numpy(_input(3))
    if mode == "bf16_compute":   # bfloat16 x on float32 weights
        x, kwargs = x.to(torch.bfloat16), {}
    else:
        kwargs = tunet.serving_precision(mode).apply_kwargs()
    calls = _count_epilogue(monkeypatch)
    with torch.no_grad():
        got = tunet.apply_unet(model, x, **kwargs)
    depth = model.config.depth
    composed = model.top_composed is not None
    assert len(calls) == 3 * depth - composed
    assert calls.count("skip_add_epilogue") == depth - composed
    monkeypatch.setattr(epilogue, "trunk_epilogue", _parent_trunk)
    monkeypatch.setattr(epilogue, "skip_add_epilogue", _parent_skip_add)
    with torch.no_grad():
        want = tunet.apply_unet(model, x, **kwargs)
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    assert got.dtype == want.dtype and torch.equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("case", ["fast32", "act2pass", "balanced", "bfloat16", "train"])
def test_epilogue_not_called_off_the_bf16_trunk(monkeypatch, case):
    """The f32-storage modes, the module's own layers in bfloat16 and a
    training forward (``balanced16``'s bf16 trunk under autograd) keep
    their separate ops: no epilogue call."""
    _, _, _, model = _folded_pair("transpose")
    x = torch.from_numpy(_input(3))
    calls = _count_epilogue(monkeypatch)
    if case == "train":
        y, _ = tunet.apply_unet(model, x, train=True,
                                **tunet.serving_precision("balanced16").apply_kwargs())
        y.sum().backward()
    elif case == "bfloat16":
        with torch.no_grad():
            tunet.apply_unet(model.to(torch.bfloat16), x.to(torch.bfloat16))
    else:
        with torch.no_grad():
            tunet.apply_unet(model, x, **tunet.serving_precision(case).apply_kwargs())
    assert calls == []


@pytest.mark.parametrize("g", range(8))
@pytest.mark.parametrize("mode", ["balanced16", "mixed", "bf16_compute"])
def test_epilogue_reads_nhwc_under_tta(monkeypatch, mode, g):
    """Test-time augmentation hands the forward a rotated or flipped view
    of the tiles (``infer.tiled._dihedral_apply``); each epilogue input
    still lies in channels-last memory, as the kernel demands on the card
    (the CPU's convs lay out their outputs as cuDNN does, after their
    input), and the forward is the unrotated layout's, bit for bit."""
    _, _, _, model = _folded_pair("transpose")
    x = torch.from_numpy(_input(3))
    if mode == "bf16_compute":
        x, kwargs = x.to(torch.bfloat16), {}
    else:
        kwargs = tunet.serving_precision(mode).apply_kwargs()
    calls = []

    def checked(name, real):
        def entry(*args, **kwargs):
            for t in args[:1] + args[2:]:
                if isinstance(t, torch.Tensor) and t.dim() == 4:
                    epilogue.check_layout(t, name)
            calls.append(name)
            return real(*args, **kwargs)
        return entry

    view = ttiled._dihedral_apply(x, g)
    monkeypatch.setattr(epilogue, "trunk_epilogue",
                        checked("trunk_epilogue", epilogue.trunk_epilogue))
    monkeypatch.setattr(epilogue, "skip_add_epilogue",
                        checked("skip_add_epilogue", epilogue.skip_add_epilogue))
    with torch.no_grad():
        got = tunet.apply_unet(model, view, **kwargs)
        want = tunet.apply_unet(model, view.contiguous(), **kwargs)
    assert len(calls) == 2 * (3 * model.config.depth - 1)
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.contiguous().view(bits), want.contiguous().view(bits))


def test_chip_smoke_traces_each_epilogue_call():
    """``chip_smoke.py --phase epilogue`` holds the kernel at the 14 calls
    a balanced16 forward of the served flagship makes at batch 128 (traced
    on meta tensors): encoder0's float32 cast and the other encoders'
    blocks pooled, the bottleneck, then each level's skip add and block."""
    calls = chip_smoke.epilogue_calls("balanced16")
    widths, sizes = (64, 128, 256, 512, 512), (256, 128, 64, 32, 16)
    encoders = [("cast" if i == 0 else "block", (128, c, h, h), "relu" if i else "none", True)
                for i, (c, h) in enumerate(zip(widths, sizes))]
    decoders = []
    for c_up, c_out, h in ((512, 512, 16), (512, 256, 32), (256, 128, 64), (128, 64, 128)):
        decoders += [("skip", (128, c_up, h, h), "none", False),
                     ("block", (128, c_out, h, h), "relu", False)]
    assert calls == encoders + [("block", (128, 512, 8, 8), "relu", False)] + decoders
    assert [c[:2] for c in chip_smoke.epilogue_calls("mixed")][1:] == [c[:2] for c in calls][1:]
    assert chip_smoke.epilogue_calls("mixed")[0] == ("block", (128, 64, 256, 256), "relu", True)
    assert chip_smoke.epilogue_calls("fast32") == []


def test_mixed_bilinear_last_conv_at_high(monkeypatch):
    """Without a composed top, ``mixed`` runs its last conv on the f32
    upcast at precision None, which is HIGH on float32 as in JAX: one K3
    call at 3 passes, the bf16 trunk on cuDNN."""
    _, _, _, model = _folded_pair("bilinear", seed=1)
    calls = []
    k3 = tunet.conv3x3_bias_act

    def record(x, kernel, *args, passes=None, **kwargs):
        calls.append((x.dtype, tuple(kernel.shape), passes))
        return k3(x, kernel, *args, passes=passes, **kwargs)

    monkeypatch.setattr(tunet, "conv3x3_bias_act", record)
    with torch.no_grad():
        tunet.apply_unet(model, torch.from_numpy(_input(3)),
                         **tunet.serving_precision("mixed").apply_kwargs())
    assert calls == [(torch.float32, (3, 3, 8, 1), 3)]


def test_bf16_resize_matches_jax():
    """The bf16 trunk's bilinear resize rounds as ``jax.image.resize``
    does: bitwise."""
    x = np.random.default_rng(0).normal(size=(2, 8, 6, 16)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x).astype(jnp.bfloat16), (2, 16, 12, 16),
                            method="linear")
    got = tunet._resize2x(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("n_passes", [1, 2, 3])
def test_operands_hold_only_the_halves_read(n_passes):
    """K3's float32 operands at a pass count: the weights' lo at 3 passes
    only (``wide_f32_weights_plain``, and the scratch the wrapper allocates
    for them); x is split on chip, so it hands over no halves at all."""
    x, k, _ = (torch.from_numpy(a) for a in _conv_inputs((1, 8, 8, 5, 4), seed=2))
    w_hi, w_lo = conv.wide_f32_weights_plain(k, n_passes)
    full = conv.wide_f32_weights_plain(k, 3)
    assert (w_lo is not None) == (n_passes == 3)
    assert torch.equal(w_hi, full[0]) and (w_lo is None or torch.equal(w_lo, full[1]))
    halves = 2 if n_passes == 3 else 1
    assert conv._fragment_bytes("wide_f32", 5, 4, n_passes) == halves * w_hi.numel() * 2


def test_cuda_launches_count_by_passes(monkeypatch):
    """On a device tensor the wrapper hands the pass count to the kernel
    library and counts the launch under it (meta tensors stand in): float32
    at Cout 8 on K3's narrow variant, which splits the weights in one
    counted launch of its own and x in registers, bfloat16 on the wide one
    (one native pass, no pass count handed over)."""
    calls = []

    class FakeLibrary:
        def conv3x3_k3(self, *args):              # bfloat16 only
            calls.append((1, 1))
            return 0

        def conv3x3_k3_narrow(self, *args):
            calls.append((0, args[20]))           # float32 only; passes
            return 0

        def conv3x3_k3_narrow_k(self, *args):     # float32, Cin <= 4, Cout 9-64
            calls.append((0, args[20]))
            return 0

    class FakeStream:
        cuda_stream = 0

    monkeypatch.setattr(conv, "_check_cuda_args", lambda x, k: None)
    monkeypatch.setattr(conv, "_library", lambda: FakeLibrary())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: FakeStream())
    x = torch.empty((2, 16, 16, 4), device="meta")
    k = torch.empty((3, 3, 4, 8), device="meta")
    before = dict(conv.LAUNCHES)
    for n_passes in (1, 2, 2, 3):
        conv.conv3x3_bias_act(x, k, passes=n_passes)
    conv.conv3x3_bias_act(x.to(torch.bfloat16), k)
    assert calls == [(0, 1), (0, 2), (0, 2), (0, 3), (1, 1)]
    gained = {key: conv.LAUNCHES[key] - before[key] for key in before}
    assert gained == {"k3": 5, "k3_p1": 1, "k3_p2": 2, "k3_p3": 1, "k3_split": 4,
                      "k3_narrow": 4, "k3_narrow_k": 0, "k3_wide_f32": 0}


def test_mode_served_on_cpu_launches_nothing(make_geotiff):
    ds, _ = _scene_datasets(make_geotiff, TILE // 2)
    _, _, _, model = _small_scene_models()
    before = dict(conv.LAUNCHES)
    ttiled.predict_linear_blend(model, ds, device="cpu", batch_size=8,
                                compute_dtype="balanced16")
    assert conv.LAUNCHES == before


def test_cli_serves_balanced16(tmp_path):
    """``general.compute_dtype: "balanced16"`` through the CLI on the CPU
    writes the scene that the library call computes."""
    scene, config, model = _small_artifacts(str(tmp_path))
    out_dir = str(tmp_path / "eval")
    cfg = chip_smoke.write_config(str(tmp_path / "cfg.json"), scene["paths"], model,
                                  out_dir, tile_size=TILE, batch_size=4,
                                  compute_dtype="balanced16")
    chip_smoke.run_cli(cfg, "cpu")
    paths = chip_smoke.output_paths(out_dir)
    assert os.path.exists(paths["statistics"])
    got = open_raster(paths["prediction"]).band(1)
    assert predict.select_compute_dtype("balanced16", torch.device("cpu")) == "balanced16"
    ds = chip_smoke._tile_dataset(scene["paths"], 64, scene["image_mean"],
                                  scene["image_std"], tile=TILE)
    net = tunet.UNet(config)
    net.load_state_dict(weights.load_state_dict(model["weights"], config))
    want = ttiled.predict_linear_blend(net, ds, device="cpu", batch_size=4,
                                       compute_dtype="balanced16")
    np.testing.assert_array_equal(got, want)
    f32 = ttiled.predict_linear_blend(net, ds, device="cpu", batch_size=4)
    assert 0 < np.abs(got - f32).max() < 0.05


def test_precision_study_runs_small(tmp_path, capsys):
    """The trained-weights deviation study at a tiny size on the CPU."""
    rows = precision_study.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                                 "--rows", "64", "--cols", "96", "--tile", "32",
                                 "--depth", "2", "--start-kernel", "4",
                                 "--seeds", "3", "--bench-batch", "2",
                                 "--out", str(tmp_path / "study.json")])
    assert [r["mode"] for r in rows] == ["bfloat16", *MODES]
    assert all(np.isfinite([r["mean_cm"], r["p99_cm"]]).all() for r in rows)
    assert os.path.exists(tmp_path / "study.json")
    assert "balanced16" in capsys.readouterr().out
