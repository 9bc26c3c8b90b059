"""Port UNet (resdepth_tpu_torch.models) against the JAX apply_unet.

Same inputs (numpy, fixed seed) and the same weights (JAX params carried
over by ``state_dict_from_jax_params``) through both packages on the CPU.
BatchNorm running statistics, biases and PReLU slopes are randomised so
that folding has work to do. Tolerance for f32: rtol 1e-5, atol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resdepth_tpu.models import unet as junet
from resdepth_tpu.train.checkpoint import save_checkpoint
from resdepth_tpu_torch.models import unet as tunet
from resdepth_tpu_torch.models import weights
from torch_unet import TorchUNet

F32 = dict(rtol=1e-5, atol=1e-4)
TILE = 32

# (channel mode, n_input_channels, config overrides)
CASES = [
    ("geom", 1, dict()),
    ("geom-mono", 2, dict(act_fn_encoder="lrelu", act_fn_decoder="lrelu",
                          act_fn_bottleneck="lrelu", up_mode="bilinear")),
    ("geom-stereo", 3, dict(act_fn_encoder="prelu", act_fn_decoder="prelu",
                            act_fn_bottleneck="prelu", outer_skip_BN=True)),
    ("stereo", 2, dict(act_fn_encoder="relu", act_fn_decoder="prelu",
                       act_fn_bottleneck="lrelu", up_mode="bilinear",
                       outer_skip_BN=True)),
    ("geom-multiview", 6, dict(act_fn_encoder="lrelu", act_fn_decoder="relu",
                               act_fn_bottleneck="prelu")),
    ("geom-stereo", 3, dict(do_BN=False, bias_conv_layer=True,
                            act_fn_encoder="prelu")),
]
CASE_IDS = ["geom-relu", "geom-mono-lrelu-bilinear", "geom-stereo-prelu-skipbn",
            "stereo-mixed-bilinear-skipbn", "multiview5-mixed", "stereo-nobn-bias"]


def _config(n_in, **overrides):
    base = dict(n_input_channels=n_in, start_kernel=8, max_filter_depth=16,
                depth=3)
    base.update(overrides)
    return base


def _jax_weights(config: junet.UNetConfig, seed: int):
    """JAX init with randomised BN statistics, biases and PReLU slopes."""
    params, state = junet.init_unet(jax.random.PRNGKey(seed), config)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    rng = np.random.default_rng(seed)

    def randomise_bn(bn, bn_stats):
        n = bn["scale"].shape
        bn["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        bn["bias"] = rng.normal(0.0, 0.1, n).astype(np.float32)
        bn_stats["mean"] = rng.normal(0.0, 0.1, n).astype(np.float32)
        bn_stats["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)

    blocks = [(params["encoder"][i], state["encoder"][i])
              for i in range(config.depth)]
    blocks += [(params["bottleneck"], state["bottleneck"])]
    blocks += [(params["decoder"][i], state["decoder"][i])
               for i in range(config.depth - 1)]
    for block, block_state in blocks:
        if "bn" in block:
            randomise_bn(block["bn"], block_state["bn"])
        if "act" in block:
            block["act"]["alpha"] = rng.uniform(0.05, 0.4, (1,)).astype(np.float32)
    if "outer_skip_bn" in params:
        randomise_bn(params["outer_skip_bn"], state["outer_skip_bn"]["bn"])
    return params, state


def _pair(n_in, overrides, seed=0):
    jconfig = junet.UNetConfig(**_config(n_in, **overrides))
    tconfig = tunet.UNetConfig(**_config(n_in, **overrides))
    params, state = _jax_weights(jconfig, seed)
    model = tunet.UNet(tconfig)
    model.load_state_dict(weights.state_dict_from_jax_params(params, state, tconfig))
    return jconfig, params, state, model


def _input(n_in, seed=1, batch=2):
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, 1.0, (batch, TILE, TILE, n_in)).astype(np.float32)


def _torch_out(model, x):
    with torch.no_grad():
        return tunet.apply_unet(model, torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
@pytest.mark.parametrize("mode,n_in,overrides", CASES, ids=CASE_IDS)
def test_forward_matches_jax(mode, n_in, overrides, folded):
    jconfig, params, state, model = _pair(n_in, overrides)
    if folded:
        jconfig, params, state = junet.fold_serving(jconfig, params, state)
        model = tunet.fold_serving(model)
        assert model.top_composed is not None or jconfig.up_mode == "bilinear"
    x = _input(n_in)
    want, _ = junet.apply_unet(jconfig, params, state, jnp.asarray(x), train=False)
    got = _torch_out(model, x)
    assert got.shape == (2, TILE, TILE, 1)
    np.testing.assert_allclose(got, np.asarray(want), **F32)


@pytest.mark.parametrize("mode,n_in,overrides", CASES, ids=CASE_IDS)
def test_folded_equals_unfolded(mode, n_in, overrides):
    _, _, _, model = _pair(n_in, overrides, seed=3)
    x = _input(n_in, seed=4)
    folded = tunet.fold_serving(model)
    assert not folded.config.do_BN
    assert tunet.fold_batchnorm(folded) is folded      # idempotent
    assert tunet.fold_top_decoder(folded) is folded
    np.testing.assert_allclose(_torch_out(folded, x), _torch_out(model, x), **F32)


def test_fold_leaves_input_module_unchanged():
    _, _, _, model = _pair(3, dict(act_fn_encoder="prelu"))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tunet.fold_serving(model)
    after = model.state_dict()
    assert before.keys() == after.keys()
    for key in before:
        assert torch.equal(before[key], after[key]), key


@pytest.mark.parametrize("overrides", [
    dict(), dict(up_mode="bilinear", act_fn_decoder="prelu"),
    dict(do_BN=False, bias_conv_layer=True, outer_skip_BN=True)],
    ids=["default", "bilinear-prelu", "nobn-skipbn"])
def test_reference_state_dict_loads_verbatim(overrides):
    """A state_dict in the reference key layout (tests/torch_unet.py) loads
    strictly and gives the oracle's output."""
    kwargs = _config(3, **overrides)
    torch.manual_seed(0)
    oracle = TorchUNet(**kwargs).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for module in oracle.modules():
            if isinstance(module, torch.nn.BatchNorm2d):
                n = module.num_features
                module.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                module.running_var.copy_(0.5 + torch.rand(n, generator=gen))
    model = tunet.UNet(tunet.UNetConfig(**kwargs))
    model.load_state_dict(oracle.state_dict())
    x = _input(3, seed=5)
    with torch.no_grad():
        want = oracle(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(_torch_out(model, x), want.numpy(), **F32)


def test_jax_npz_checkpoint_loads(tmp_path):
    """A checkpoint written by the JAX save_checkpoint reads back with numpy
    alone into the same state_dict as the in-memory carry-over."""
    n_in, overrides = 3, dict(act_fn_encoder="prelu", outer_skip_BN=True)
    jconfig, params, state, model = _pair(n_in, overrides)
    path = str(tmp_path / "Model_best.npz")
    save_checkpoint(path, epoch=3, params=params, bn_state=state)
    tconfig = tunet.UNetConfig(**dataclasses.asdict(jconfig))
    loaded = weights.load_state_dict(path, tconfig)
    expected = model.state_dict()
    assert loaded.keys() == expected.keys()
    for key in expected:
        assert torch.equal(loaded[key], expected[key]), key


def test_pth_checkpoint_loads(tmp_path):
    """A reference .pth payload ({'model_state_dict': ...}) and a bare
    state_dict both load."""
    _, _, _, model = _pair(2, dict(up_mode="bilinear"))
    sd = model.state_dict()
    for blob, name in ((dict(epoch=1, model_state_dict=sd), "wrapped.pth"),
                       (sd, "bare.pth")):
        path = str(tmp_path / name)
        torch.save(blob, path)
        loaded = weights.load_state_dict(path, model.config)
        assert all(torch.equal(loaded[k], sd[k]) for k in sd)


def test_bfloat16_close_to_jax_bfloat16():
    """bf16 casts the whole network, outer skip included, in both packages.
    The frameworks round bf16 at different places on the CPU, so the bar is
    a measured one, far from f32-class agreement: on outputs of up to 4
    normalised units, seeds 0-2 measured at most 0.0156 (one bf16 ulp in
    [2, 4)) and 5e-4 on average; the bar is 0.05 max and 2e-3 mean."""
    jconfig, params, state, model = _pair(3, dict())
    jconfig, params, state = junet.fold_serving(jconfig, params, state)
    model = tunet.fold_serving(model).to(torch.bfloat16)
    assert model.top_composed.s_map.dtype == torch.float32
    x = _input(3)
    want, _ = junet.apply_unet(jconfig, params, state,
                               jnp.asarray(x).astype(jnp.bfloat16), train=False)
    with torch.no_grad():
        got = tunet.apply_unet(model, torch.from_numpy(x).to(torch.bfloat16))
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 0.05
    assert np.abs(got - want).mean() <= 2e-3


def test_init_unet_is_seeded():
    config = tunet.UNetConfig(**_config(3, act_fn_encoder="prelu"))
    a = tunet.init_unet(config, torch.Generator().manual_seed(7)).state_dict()
    b = tunet.init_unet(config, torch.Generator().manual_seed(7)).state_dict()
    c = tunet.init_unet(config, torch.Generator().manual_seed(8)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.0.0.0.weight"], c["encoder.0.0.0.weight"])
    assert torch.all(a["encoder.0.0.1.running_var"] == 1)


# ------------------------------ training mode ------------------------------ #
# Train-mode forward, new BatchNorm state and gradients against the JAX
# apply_unet(train=True) and jax.grad, on the same weights and batch. The
# loss is sum(y * g) for a fixed random g, so every output pixel carries
# gradient. Tolerances: outputs and BN state as in eval mode (rtol 1e-5,
# atol 1e-4); gradients to 1e-4 relative L2 per tensor (sums over batch and
# pixels in another order than XLA's).

TRAIN_CASES = [
    dict(),
    dict(act_fn_encoder="lrelu", act_fn_decoder="lrelu",
         act_fn_bottleneck="lrelu", up_mode="bilinear", outer_skip_BN=True),
    dict(act_fn_encoder="prelu", act_fn_decoder="prelu",
         act_fn_bottleneck="prelu", outer_skip_BN=True),
]
TRAIN_IDS = ["relu-transpose", "lrelu-bilinear-skipbn", "prelu-transpose-skipbn"]


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _torch_train(model, x, g, weights=None, remat=False):
    """Output, new BN state (by buffer name) and gradients (by parameter
    name) of one train-mode forward and backward."""
    model.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x)
    w = None if weights is None else torch.from_numpy(weights)
    y, bn_state = tunet.apply_unet(model, xt, train=True, sample_weights=w,
                                   remat=remat)
    (y * torch.from_numpy(g)).sum().backward()
    grads = {name: p.grad.clone() for name, p in model.named_parameters()}
    return y.detach().numpy(), bn_state, grads


def _jax_train(jconfig, params, state, x, g, weights=None):
    def loss(p):
        y, new_state = junet.apply_unet(
            jconfig, p, state, jnp.asarray(x), train=True,
            sample_weights=None if weights is None else jnp.asarray(weights))
        return (y * jnp.asarray(g)).sum(), (y, new_state)
    grads, (y, new_state) = jax.grad(loss, has_aux=True)(params)
    return np.asarray(y), new_state, grads


def _check_against_jax(config, got, want):
    y, bn_state, grads = got
    jy, jstate, jgrads = want
    np.testing.assert_allclose(y, jy, **F32)
    torch_bn = {}
    for name, value in bn_state.items():
        torch_bn[name] = value
    want_bn = weights.state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jgrads), jstate, config)
    assert set(torch_bn) == {k for k in want_bn if k.endswith(("running_mean",
                                                               "running_var"))}
    for name, value in torch_bn.items():
        np.testing.assert_allclose(value.numpy(), want_bn[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    want_grads = weights.state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jgrads), None, config)
    assert set(grads) == set(want_grads)
    for name, value in grads.items():
        assert _rel_l2(value.numpy(), want_grads[name].numpy()) <= 1e-4, name


@pytest.mark.parametrize("overrides", TRAIN_CASES, ids=TRAIN_IDS)
def test_train_forward_and_grads_match_jax(overrides):
    jconfig, params, state, model = _pair(3, overrides, seed=6)
    model.train()
    x = _input(3, seed=7, batch=3)
    g = np.random.default_rng(8).normal(size=x.shape[:3] + (1,)).astype(np.float32)
    got = _torch_train(model, x, g)
    _check_against_jax(model.config, got, _jax_train(jconfig, params, state, x, g))
    # apply_unet(train=True) leaves the buffers as they were
    np.testing.assert_array_equal(model.state_dict()["encoder.0.0.1.running_mean"].numpy(),
                                  state["encoder"][0]["bn"]["mean"])


@pytest.mark.parametrize("overrides", TRAIN_CASES, ids=TRAIN_IDS)
def test_zero_weight_padding_changes_nothing(overrides):
    """Two zero-weight samples appended to a batch of three: the real
    samples' outputs, the BN state and the gradients equal the unpadded
    batch's, in the port and against JAX's padded batch."""
    jconfig, params, state, model = _pair(3, overrides, seed=9)
    x = _input(3, seed=10, batch=3)
    pad = _input(3, seed=11, batch=2) * 5.0
    xp = np.concatenate([x, pad])
    w = np.array([1, 1, 1, 0, 0], np.float32)
    g = np.random.default_rng(12).normal(size=x.shape[:3] + (1,)).astype(np.float32)
    gp = np.concatenate([g, np.zeros((2,) + g.shape[1:], np.float32)])

    y, bn_state, grads = _torch_train(model, x, g)
    yp, bn_pad, grads_pad = _torch_train(model, xp, gp, weights=w)
    np.testing.assert_allclose(yp[:3], y, **F32)
    for name in bn_state:
        np.testing.assert_allclose(bn_pad[name].numpy(), bn_state[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for name in grads:
        assert _rel_l2(grads_pad[name].numpy(), grads[name].numpy()) <= 1e-4, name
    _check_against_jax(model.config, (yp, bn_pad, grads_pad),
                       _jax_train(jconfig, params, state, xp, gp, weights=w))


def test_remat_gives_the_same_gradients():
    _, _, _, model = _pair(3, dict(act_fn_encoder="prelu", outer_skip_BN=True),
                           seed=13)
    x = _input(3, seed=14, batch=2)
    g = np.random.default_rng(15).normal(size=x.shape[:3] + (1,)).astype(np.float32)
    w = np.array([1, 0], np.float32)
    y, bn_state, grads = _torch_train(model, x, g, weights=w)
    y_r, bn_r, grads_r = _torch_train(model, x, g, weights=w, remat=True)
    np.testing.assert_array_equal(y_r, y)
    assert bn_r.keys() == bn_state.keys()
    for name in grads:
        np.testing.assert_allclose(grads_r[name].numpy(), grads[name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_module_forward_in_training_mode_writes_running_stats():
    """``model.train(); model(x)`` writes the new running statistics into
    the buffers (torch's habit); ``apply_unet(train=True)`` returns them."""
    _, _, _, model = _pair(1, dict(), seed=16)
    x = _input(1, seed=17)
    _, bn_state = tunet.apply_unet(model, torch.from_numpy(x), train=True)
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(x).permute(0, 3, 1, 2))
    buffers = dict(model.named_buffers())
    for name, value in bn_state.items():
        assert torch.equal(buffers[name], value), name
    assert model.training


def test_parameter_order_is_the_reference_order():
    """Torch optimizer state indexes parameters by position: the port's
    order must be the reference's for a .pth optimizer state to load."""
    kwargs = _config(3, act_fn_encoder="prelu", outer_skip_BN=True)
    oracle = TorchUNet(**kwargs)
    model = tunet.UNet(tunet.UNetConfig(**kwargs))
    assert list(model.state_dict()) == list(oracle.state_dict())
    assert [n for n, _ in model.named_parameters()] == \
        [n for n, _ in oracle.named_parameters()]


@pytest.mark.parametrize("mode,n_in,overrides", CASES, ids=CASE_IDS)
def test_jax_params_round_trip(mode, n_in, overrides):
    """jax_params_from_state_dict inverts state_dict_from_jax_params, tree
    for tree and leaf for leaf."""
    jconfig, params, state, model = _pair(n_in, overrides, seed=18)
    got_params, got_state = weights.jax_params_from_state_dict(model.state_dict(),
                                                               model.config)
    assert jax.tree_util.tree_structure(got_params) == \
        jax.tree_util.tree_structure(params)
    assert jax.tree_util.tree_structure(got_state) == \
        jax.tree_util.tree_structure(state)
    for a, b in zip(jax.tree_util.tree_leaves((got_params, got_state)),
                    jax.tree_util.tree_leaves((params, state))):
        np.testing.assert_array_equal(a, b)
    assert set(weights.flatten_keystr(got_params)) == {
        jax.tree_util.keystr(p) for p, _ in
        jax.tree_util.tree_flatten_with_path(params)[0]}
