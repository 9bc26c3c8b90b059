"""The port's training precisions against the JAX package's, on the CPU.

``tpu.train_precision`` 'default', 'highest', 'balanced' and 'balanced16'
and ``tpu.compute_dtype`` 'bfloat16' train as ``train.py`` trains them:

* The policy table: ``select_train_precision`` builds ``train.py``'s
  ``apply_unet`` kwargs (each precision as its pass count), and the
  validators accept and reject the same pairs with the same errors.
* One train step per policy, every f32 conv forced to HIGHEST, against one
  JAX ``make_train_step`` step at the policy's kwargs (XLA:CPU runs every
  precision as exact float32): metric, weights, BatchNorm state and Adam
  moments. f32 storage: rtol 1e-5 (weights atol 1e-6) and 1e-4 relative
  L2 on the moments, as ``test_torch_train.py``. The bf16 trunks round as
  JAX rounds, but the two frameworks' bf16 convs sum in other orders, so
  their gradients hold at the bars of ``BF16_STEP_BARS``.
* The pass-count convs' gradients (``ops.passes.same_conv``, 3x3 on K3's
  plain version and 1x1, and ``ops.passes.upconv2x2``) at 1 and 3 passes
  against a float64 sum of the split products of JAX's operand pairs:
  rtol 1e-6, atol 1e-6 of the largest value; and a 'default' step's
  gradients away from the IEEE step's by at least half their measured gap.
* K3's launches a step by pass count, on meta tensors with the CUDA calls
  stubbed, against ``chip_smoke.k3_launches_a_step``.
* The train CLI runs ``scripts/make_demo_data.py``'s training config
  (balanced16, ``steps_per_call`` 8) at a small size, and validates with
  the float32 policy.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from resdepth_tpu.config import validate_train as j_vtrain
from resdepth_tpu.config.io import merge as j_merge
from resdepth_tpu.data import pipeline as jpipe
from resdepth_tpu.data.dataset import TileDataset as JTileDataset
from resdepth_tpu.models import unet as junet
from resdepth_tpu.train.optim import build_optimizer as jbuild_optimizer
from resdepth_tpu.train.step import init_train_state as jinit_state
from resdepth_tpu.train.step import make_eval_step as jmake_eval_step
from resdepth_tpu.train.step import make_train_step as jmake_step
from resdepth_tpu_torch.config import validate_train as t_vtrain
from resdepth_tpu_torch.config.io import merge as t_merge
from resdepth_tpu_torch.data import pipeline as tpipe
from resdepth_tpu_torch.data.dataset import TileDataset
from resdepth_tpu_torch.models import unet as tunet
from resdepth_tpu_torch.models import weights
from resdepth_tpu_torch.ops import conv, passes
from resdepth_tpu_torch.train import cli
from resdepth_tpu_torch.train import step as tstep
from resdepth_tpu_torch.train.step import init_train_state, make_train_step
from test_torch_pipeline import COLS, ROWS, _training_scene
from test_torch_train import LR, _adam_state, _check_state
from test_torch_unet import _jax_weights, _rel_l2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = 32
SETTINGS = dict(n_input_channels=3, start_kernel=4, max_filter_depth=8, depth=3,
                act_fn_encoder="prelu", outer_skip_BN=True)
# (tpu.train_precision, tpu.compute_dtype) of each policy
POLICIES = {"default": ("default", "float32"), "highest": ("highest", "float32"),
            "balanced": ("balanced", "float32"), "balanced16": ("balanced16", "float32"),
            "bf16-high": ("high", "bfloat16"), "bf16-default": ("default", "bfloat16")}
BF16_TRUNK = ("balanced16", "bf16-high", "bf16-default")
BF16_COMPUTE = ("bf16-high", "bf16-default")


def _jax_policy(train_precision):
    """``train.py``'s ``precision_kwargs`` for ``train_precision``."""
    if train_precision in ("balanced", "balanced16"):
        return junet.serving_precision(train_precision).apply_kwargs()
    return {"high": dict(precision=None),
            "default": dict(precision=jax.lax.Precision.DEFAULT),
            "highest": dict(precision=jax.lax.Precision.HIGHEST)}[train_precision]


def _jax_passes(precision):
    """Pass count of a JAX precision on float32 operands (None: unset)."""
    if precision is None:
        return None
    H, D = jax.lax.Precision.HIGH, jax.lax.Precision.DEFAULT
    return {D: 1, (H, D): 2, H: 3, jax.lax.Precision.HIGHEST: "ieee"}[precision]


def _port_passes(precision):
    if precision is None:
        return None
    return tunet.precision_passes(precision) or "ieee"


# ------------------------------ the policy table ----------------------------- #

class _Errors:
    def __init__(self):
        self.lines = []

    def error(self, message):
        self.lines.append(message)

    info = warning = error


PAIRS = [(p, d) for p in ("high", "default", "highest", "balanced", "balanced16")
         for d in ("float32", "bfloat16")]


@pytest.mark.parametrize("train_precision,compute_dtype", PAIRS,
                         ids=[f"{p}-{d}" for p, d in PAIRS])
def test_policy_matches_train_py(train_precision, compute_dtype):
    """The port's validator accepts and rejects each pair as the JAX one
    does, with the same errors; an accepted pair selects ``train.py``'s
    kwargs (precisions by pass count) and compute dtype."""
    tpu = {"train_precision": train_precision, "compute_dtype": compute_dtype}
    verdicts = []
    for vtrain, merge in ((j_vtrain, j_merge), (t_vtrain, t_merge)):
        errors = _Errors()
        verdicts.append((vtrain._valid_tpu_args(merge({}, {"tpu": tpu}), errors),
                         errors.lines))
    assert verdicts[0] == verdicts[1]
    rejected = (train_precision.startswith("balanced") and compute_dtype == "bfloat16")
    assert verdicts[1][0] is not rejected
    if rejected:
        return
    got, dtype = tstep.select_train_precision(train_precision, compute_dtype,
                                              torch.device("cpu"))
    want = _jax_policy(train_precision)
    assert dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute_dtype]
    assert set(got) == set(want)
    assert _port_passes(got["precision"]) == _jax_passes(want["precision"])
    for key in ("mixed_precision", "hifi_endpoints"):
        assert got.get(key) == want.get(key)
    layers = {k: _port_passes(v) for k, v in (got.get("layer_precisions") or {}).items()}
    assert layers == {k: _jax_passes(v)
                      for k, v in (want.get("layer_precisions") or {}).items()}


def test_bf16_trunk_needs_float32_input():
    """balanced16 with bfloat16 compute raises for a programmatic caller,
    as the JAX ``make_train_step`` does; so does the bf16 trunk of
    ``apply_unet`` on a bfloat16 input."""
    kwargs = tunet.serving_precision("balanced16").apply_kwargs()
    with pytest.raises(ValueError, match="compute_dtype float32, got bfloat16"):
        make_train_step(None, compute_dtype=torch.bfloat16, **kwargs)
    model = tunet.UNet(tunet.UNetConfig(**SETTINGS))
    with pytest.raises(ValueError, match="float32"):
        tunet.apply_unet(model, torch.zeros((1, TILE, TILE, 3), dtype=torch.bfloat16),
                         train=True, mixed_precision=True)


# --------------------------- one step against JAX ---------------------------- #

def _datasets(make_geotiff):
    """The port's and the JAX package's training dataset over one scene,
    tiles of 32."""
    paths = _training_scene(make_geotiff)
    entry = {"raster_in": paths["raster_in"], "raster_gt": paths["raster_gt"],
             "area_defn": {"x_extent": [(0, COLS - 1)], "y_extent": [(0, ROWS - 1)]},
             "n_samples": 12, "image_list": paths["image_list"],
             "image_pairs": [(2, 1)]}
    return [cls(entry, input_channels="geom-stereo", tile_size=TILE,
                sampling_strategy="train", dsm_std=5.0, ortho_mean=None,
                ortho_std=25.0, seed=3) for cls in (TileDataset, JTileDataset)]


def _models(seed=0):
    jconfig = junet.UNetConfig(**SETTINGS)
    params, state = _jax_weights(jconfig, seed)
    model = tunet.UNet(tunet.UNetConfig(**SETTINGS))
    model.load_state_dict(weights.state_dict_from_jax_params(params, state, model.config))
    return jconfig, params, state, model


def _batch(ds, size=4):
    """``size - 1`` real samples and one zero-weight padding sample."""
    idx = np.arange(size) % len(ds)
    w = np.ones(size, np.float32)
    w[-1] = 0.0
    return ds.positions[idx], ds.pair_indices[idx], np.zeros((size, 4), np.int32), w


def _port_step(ds, model, policy, **overrides):
    """One Adam step (weight decay 1e-5) of the port at ``policy`` with
    ``overrides`` of its kwargs; returns the state and the metric."""
    kwargs, dtype = tstep.select_train_precision(*POLICIES[policy], torch.device("cpu"))
    state = init_train_state(model, "Adam", LR, 1e-5)
    step = make_train_step(tpipe.batch_spec_for(ds), compute_dtype=dtype,
                           **{**kwargs, **overrides})
    metric = step(state, tpipe.device_put_dataset(ds, "cpu", include_target=True),
                  *_batch(ds), tpipe.GeneratorDraws(torch.Generator().manual_seed(0)))
    return state, float(metric)


# The bf16 trunks' one step, port against JAX, measured (balanced16 /
# bf16-high / bf16-default): metric relative gap 6.4e-5 / 1.1e-4 / 1.1e-4;
# gradients (Adam's first moment, all parameters) relative L2 1.4e-2 / 3.2e-2
# / 3.2e-2; BN running statistics, worst tensor's relative L2 1.6e-4 / 1.1e-3
# / 1.1e-3. The two frameworks' bf16
# convs agree bit for bit here, but the f32 sums of the batch statistics
# (in another order) move a few bf16 roundings, and a training-mode trunk
# this small carries one moved rounding far: two input values moved by one
# bf16 ulp move JAX's own balanced16 output by 3e-4 mean, as much as the
# port is from it. Each bar is about three times the largest measured gap.
# Weights move by lr g / |g| in Adam's first step, so no more than 2 lr
# apart.
BF16_STEP_BARS = {"metric": 3.5e-4, "grads": 0.1, "bn": 3.5e-3}


def _bf16_gaps(state, jstate, metric, jmetric):
    """The port's state after one step against JAX's: the metric's
    relative gap, the gradients' (Adam ``mu``) relative L2 over all
    parameters, the worst BN running statistic's relative L2 and the
    largest weight difference."""
    from resdepth_tpu_torch.train.trainer import checkpoint_trees

    def flat(tree):
        return weights.flatten_keystr(jax.tree_util.tree_map(np.asarray, tree))

    trees = checkpoint_trees(state)
    got, want = weights.flatten_keystr(trees["bn_state"]), flat(jstate.bn_state)
    assert got.keys() == want.keys()
    bn = max(_rel_l2(got[k], want[k]) for k in want)
    mu, _, count = weights.adam_moments_to_jax(state.model, state.optimizer,
                                               state.model.config)
    adam = _adam_state(jstate, 1e-5)
    assert count == int(adam.count) == 1
    got, want = weights.flatten_keystr(mu), flat(adam.mu)
    keys = sorted(want)
    grads = _rel_l2(np.concatenate([got[k].ravel() for k in keys]),
                    np.concatenate([want[k].ravel() for k in keys]))
    got, want = weights.flatten_keystr(trees["params"]), flat(jstate.params)
    moved = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    return {"metric": abs(metric / jmetric - 1), "grads": grads, "bn": bn,
            "moved": moved}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_train_step_matches_jax(make_geotiff, policy):
    ds, jds = _datasets(make_geotiff)
    jconfig, params, state, model = _models()
    train_precision, compute_dtype = POLICIES[policy]
    tx = jbuild_optimizer("Adam", 1e-5)
    jstep = jmake_step(jconfig, jpipe.batch_spec_for(jds), tx, donate=False,
                       compute_dtype=getattr(jnp, compute_dtype),
                       **_jax_policy(train_precision))
    jstate, jmetric = jstep(jinit_state(params, state, tx, LR),
                            jpipe.device_put_dataset(jds), *_batch(ds),
                            jax.random.PRNGKey(0))
    tstate, metric = _port_step(ds, model, policy, precision=tunet.Precision.HIGHEST,
                                layer_precisions=None)
    assert np.isfinite(metric)
    if policy not in BF16_TRUNK:
        np.testing.assert_allclose(metric, float(jmetric), rtol=1e-5)
        _check_state(tstate, jstate, "Adam", 1e-5)
        return
    gaps = _bf16_gaps(tstate, jstate, metric, float(jmetric))
    assert all(gaps[k] <= bar for k, bar in BF16_STEP_BARS.items()), gaps
    assert gaps["moved"] <= 2 * LR * (1 + 1e-3), gaps


# The port's 'default' step (1 bf16 pass, its plain version here) against
# its IEEE step on the same weights and batch: the gradients' relative L2,
# over all parameters, measured 6.7e-3. A port that trained exactly (or
# took IEEE gradients through the split) would fall far below half of it.
DEFAULT_GRAD_GAP = 6.7e-3


def test_default_step_takes_its_passes(make_geotiff):
    ds, _ = _datasets(make_geotiff)
    grads = {}
    for policy, overrides in (("default", {}), ("highest", {})):
        _, _, _, model = _models(seed=4)
        _port_step(ds, model, policy, **overrides)
        grads[policy] = np.concatenate([p.grad.numpy().ravel() for p in model.parameters()])
    gap = _rel_l2(grads["default"], grads["highest"])
    assert 0.5 * DEFAULT_GRAD_GAP <= gap <= 4 * DEFAULT_GRAD_GAP, gap


# ------------------------ the pass-count convs' gradients --------------------- #

def _split64(v):
    hi = v.to(torch.bfloat16).double()
    return hi, (v.double() - hi).to(torch.bfloat16).double()


def _pairs(a, b, n_passes):
    """JAX's split products of operands ``a`` (the activation's side) and
    ``b`` at ``n_passes``, in float64."""
    (a_hi, a_lo), (b_hi, b_lo) = _split64(a), _split64(b)
    return {1: [(a_hi, b_hi)], 3: [(a_hi, b_hi), (a_hi, b_lo), (a_lo, b_hi)]}[n_passes]


def _grad_inputs(shape_x, shape_w, shape_g, seed):
    """x, the weights, a bias of g's channels and the cotangent g."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape_x) * 20.0
    w = rng.normal(size=shape_w) * 0.2
    b = rng.normal(size=shape_g[1])
    g = rng.normal(size=shape_g) * 3.0
    return tuple(torch.from_numpy(v.astype(np.float32)) for v in (x, w, b, g))


def _close(got, want):
    want = want.numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def _autograd(fn, x, w, b, g):
    x, w, b = (t.clone().requires_grad_(True) for t in (x, w, b))
    fn(x, w, b).backward(g)
    return x.grad, w.grad, b.grad


@pytest.mark.parametrize("n_passes", [1, 3])
@pytest.mark.parametrize("k", [3, 1], ids=["3x3", "1x1"])
def test_same_conv_grads_match_float64_sum(k, n_passes):
    """dx is the conv of g with the flipped, transposed weights at the
    passes (g on the activation's side), dw the products of x and g over
    the batch (x on the activation's side), db the sum of g."""
    x, w, b, g = _grad_inputs((2, 5, 9, 7), (6, 5, k, k), (2, 6, 9, 7), seed=k + n_passes)
    dx, dw, db = _autograd(lambda x, w, b: passes.same_conv(x, w, b, n_passes), x, w, b, g)
    pad = k // 2
    want_dx = sum(torch.nn.grad.conv2d_input(x.shape, wp, gp, padding=pad)
                  for gp, wp in _pairs(g, w, n_passes))
    want_dw = sum(torch.nn.grad.conv2d_weight(xp, w.shape, gp, padding=pad)
                  for xp, gp in _pairs(x, g, n_passes))
    _close(dx, want_dx)
    _close(dw, want_dw)
    _close(db, g.double().sum((0, 2, 3)))
    ieee = _autograd(lambda x, w, b: F.conv2d(x, w, b, padding=pad), x, w, b, g)
    if n_passes == 1:    # not autograd's IEEE gradient
        assert (dx - ieee[0]).abs().max() > 1e-3 * ieee[0].abs().max()
        assert (dw - ieee[1]).abs().max() > 1e-3 * ieee[1].abs().max()


@pytest.mark.parametrize("n_passes", [1, 3])
def test_upconv_grads_match_float64_sum(n_passes):
    """The JAX ``_upconv2x2_bwd`` at the passes: dx the stride-2 conv of g
    with the weights, dw g (on the activation's side) against x."""
    x, w, b, g = _grad_inputs((2, 6, 5, 4), (6, 3, 2, 2), (2, 3, 10, 8), seed=n_passes)
    dx, dw, db = _autograd(lambda x, w, b: passes.upconv2x2(x, w, b, n_passes), x, w, b, g)
    want_dx = sum(F.conv2d(gp, wp, stride=2) for gp, wp in _pairs(g, w, n_passes))
    want_dw = sum(torch.nn.grad.conv2d_weight(gp, w.shape, xp, stride=2)
                  for gp, xp in _pairs(g, x, n_passes))
    _close(dx, want_dx)
    _close(dw, want_dw)
    _close(db, g.double().sum((0, 2, 3)))
    y = passes.upconv2x2(x, w, b, n_passes)
    np.testing.assert_array_equal(y.numpy(), passes.conv_transpose2d(x, w, b, n_passes).numpy())


# ----------------------------- K3 on the train step --------------------------- #

def test_remat_recomputes_the_same_step(make_geotiff):
    """``tpu.remat`` at a pass-count policy: each block's forward runs again
    in the backward (the pass-count Function included) to the same
    gradients."""
    ds, _ = _datasets(make_geotiff)
    grads = []
    for remat in (False, True):
        _, _, _, model = _models(seed=6)
        _port_step(ds, model, "balanced", remat=remat)
        grads.append([p.grad.clone() for p in model.parameters()])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("policy", ["default", "balanced", "balanced16", "bf16-high"])
def test_k3_launches_a_step(monkeypatch, policy):
    """One training forward and backward of the UNet at ``policy`` on
    device tensors (meta tensors, the CUDA calls stubbed): K3 runs every
    f32 3x3 conv with a pass count, forward and dx, and no dx for
    ``encoder0``, whose input needs no gradient."""
    calls = []

    class FakeLibrary:
        def conv3x3_k3(self, *args):
            calls.append(args)
            return 0

    class FakeStream:
        cuda_stream = 0

    monkeypatch.setattr(conv, "_check_cuda_args", lambda x, k: None)
    monkeypatch.setattr(conv, "_library", lambda: FakeLibrary())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: FakeStream())
    kwargs, dtype = tstep.select_train_precision(*POLICIES[policy], torch.device("cpu"))
    config = tunet.UNetConfig(**SETTINGS)
    model = tunet.UNet(config, "meta")
    x = torch.empty((2, TILE, TILE, 3), device="meta", dtype=dtype)
    before = dict(conv.LAUNCHES)
    y, _ = tunet.apply_unet(model, x, train=True, **kwargs)
    y.float().sum().backward()
    gained = {p: conv.LAUNCHES[f"k3_p{p}"] - before[f"k3_p{p}"] for p in (1, 2, 3)}
    want = chip_smoke.k3_launches_a_step(
        "bfloat16" if policy in BF16_COMPUTE else policy, config.depth)
    assert {p: n for p, n in gained.items() if n} == want
    assert len(calls) == sum(want.values()) == conv.LAUNCHES["k3"] - before["k3"]
    assert [c[14] for c in calls] == [c[14] for c in calls if c[13] == 0]   # f32 only


# ----------------------------- the train CLI ------------------------------ #

@pytest.fixture(scope="module")
def demo_run(tmp_path_factory):
    """``scripts/make_demo_data.py``'s training config at a small size: its
    ``tpu`` section (balanced16, ``steps_per_call`` 8) unedited."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import make_demo_data

    work = str(tmp_path_factory.mktemp("demo"))
    argv = sys.argv
    try:
        sys.argv = ["make_demo_data.py", work]
        make_demo_data.main()
    finally:
        sys.argv = argv
    with open(os.path.join(work, "config_train.json")) as f:
        cfg = json.load(f)
    assert cfg["tpu"] == {"train_precision": "balanced16", "steps_per_call": 8}
    cfg["model"].update(depth=2, start_kernel=4, max_filter_depth=8)
    cfg["training_settings"].update(tile_size=32, n_epochs=1)
    cfg["datasets"][0]["n_training_samples"] = 16
    path = os.path.join(work, "config_small.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return {"config": path, "out": cfg["output"]["output_directory"]}


def test_cli_trains_the_demo_config(demo_run, monkeypatch):
    """The demo config trains on the CPU at balanced16, validates with the
    float32 policy at float32 compute, logs its policy and writes its
    checkpoints; nothing launches a kernel."""
    evals, steps = [], []
    make_eval, make_step = cli.make_eval_step, cli.make_train_step

    def eval_recorder(*args, **kwargs):
        evals.append((args[1:], kwargs))
        return make_eval(*args, **kwargs)

    def step_recorder(*args, **kwargs):
        steps.append(kwargs)
        return make_step(*args, **kwargs)

    monkeypatch.setattr(cli, "make_eval_step", eval_recorder)
    monkeypatch.setattr(cli, "make_train_step", step_recorder)
    before = dict(conv.LAUNCHES)
    trainer = cli.main([demo_run["config"], "--device", "cpu"])
    assert conv.LAUNCHES == before
    assert evals == [((torch.float32, None), {})]   # float32, no process group
    assert steps[0]["mixed_precision"] and steps[0]["hifi_endpoints"]
    assert steps[0]["compute_dtype"] == torch.float32
    assert [e for e, _ in trainer.val_history] == [0]
    assert np.isfinite(trainer.val_history[0][1])
    run = chip_smoke.run_dir_of(demo_run["out"], "demo")
    assert os.path.exists(os.path.join(run, "checkpoints", "Model_best.npz"))
    with open(os.path.join(run, "run.log")) as f:
        assert "train_precision balanced16, compute_dtype float32" in f.read()


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_eval_step_matches_jax(make_geotiff, compute_dtype):
    """Validation at the compute dtype with the float32 policy: the JAX
    eval step's masked error sum and count (bfloat16 within the trunk's
    rounding)."""
    ds, jds = _datasets(make_geotiff)
    jconfig, params, state, model = _models(seed=2)
    batch = _batch(ds)
    jstep = jmake_eval_step(jconfig, jpipe.batch_spec_for(jds),
                            compute_dtype=getattr(jnp, compute_dtype))
    want = jstep(params, state, jpipe.device_put_dataset(jds), *batch,
                 jax.random.PRNGKey(0))
    step = tstep.make_eval_step(tpipe.batch_spec_for(ds), getattr(torch, compute_dtype))
    got = step(model, tpipe.device_put_dataset(ds, "cpu", include_target=True), *batch)
    assert float(got[1]) == float(want[1])
    rtol = 1e-5 if compute_dtype == "float32" else 2e-3
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=rtol)


def test_k3_time_by_passes_from_kernel_names():
    """``chip_smoke.k3_ms_by_passes`` reads the pass count from K3's
    template arguments (float32 launches only) and its split kernel's."""
    names = {"void (anonymous namespace)::conv3x3_k3_kernel<128, 1, true, 64, 1>(x)": 2.0,
             "void (anonymous namespace)::conv3x3_k3_kernel<64, 3, true, 16, 1>(x)": 1.5,
             "void (anonymous namespace)::conv3x3_k3_kernel<64, 1, true, 32, 1>(x)": 0.5,
             "void (anonymous namespace)::conv3x3_k3_kernel<128, 1, false, 64, 2>(x)": 9.0,
             "void (anonymous namespace)::split_hi_lo_kernel(float const*)": 0.25,
             "cudnn::winograd_nonfused::winogradForwardData4x4": 7.0}
    assert chip_smoke.k3_ms_by_passes(names) == {1: 2.5, 3: 1.5, "split": 0.25}


def test_precision_study_trains_at_a_precision(tmp_path):
    """The study's ``--train-precision`` trains at that policy (tiny, on
    the CPU, where the card-vs-CPU share is not taken)."""
    from resdepth_tpu_torch.studies import precision_study

    rows = precision_study.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                                 "--rows", "64", "--cols", "96", "--tile", "32",
                                 "--depth", "2", "--start-kernel", "4", "--seeds", "3",
                                 "--bench-batch", "2", "--train-precision", "default",
                                 "--out", str(tmp_path / "study.json")])
    with open(tmp_path / "study.json") as f:
        study = json.load(f)
    assert study["args"]["train_precision"] == "default"
    assert [r["mode"] for r in rows][-1] == "balanced16"
    assert all(r["card_vs_cpu_share"] == r["k3_vs_card_plain_share"] == [None]
               for r in rows)


def test_sum_order_alone_moves_balanced_on_the_cpu():
    """Another order of the same exact products moves a 1-pass mode's
    outputs where an activation rounds to bf16, and ``balanced``'s most
    against its own small deviation from float32: at the flagship's width
    (start 64, depth 4, tiles of 64, random weights), K3's plain version
    summed in float64 instead of float32 moved balanced by 0.195 of its own
    mean deviation, fast32 by 0.029 and act2pass, whose activations keep
    their lo half, by 3.4e-4. On the card, cuDNN's plain version stands as
    far from the CPU as K3 does (``studies/precision_study.py``'s shares):
    balanced's card-vs-CPU share is this, not a fault in K3's sums."""
    from unittest import mock

    def exact_sums(x, kernel, bias=None, act_param=None, *, act_fn="relu", passes=None):
        b, a = conv._epilogue_vectors(x, kernel, bias, act_param)
        xs, ws = conv.pass_ops.pass_operands(x, kernel, conv.pass_count(x, passes), 3, 2)
        y = F.conv2d(xs.permute(0, 3, 1, 2).double(), ws.permute(3, 2, 0, 1).double(),
                     padding=1).permute(0, 2, 3, 1)
        return conv._activate((y + b.double()).float(), act_fn, a)

    config = tunet.UNetConfig(n_input_channels=3, depth=4, start_kernel=64,
                              max_filter_depth=512)
    model = tunet.fold_serving(chip_smoke.random_model(config))
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (2, 64, 64, 3))
                         .astype(np.float32))
    shares = {}
    with torch.no_grad():
        f32 = tunet.apply_unet(model, x).numpy()
        for mode in ("fast32", "act2pass", "balanced"):
            kwargs = tunet.serving_precision(mode).apply_kwargs()
            got = tunet.apply_unet(model, x, **kwargs).numpy()
            with mock.patch.object(tunet, "conv3x3_bias_act", exact_sums):
                other = tunet.apply_unet(model, x, **kwargs).numpy()
            shares[mode] = np.abs(got - other).mean() / np.abs(got - f32).mean()
    assert shares["balanced"] >= 0.1 and shares["act2pass"] <= 1e-2, shares
    assert shares["fast32"] >= 10 * shares["act2pass"], shares
