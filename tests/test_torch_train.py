"""The port's training slice against the JAX package on the CPU.

* Train steps of
  ``resdepth_tpu_torch.train.step`` against the JAX ``make_train_step(mesh=
  None)`` (and its ``steps_per_call=3`` scan) on identical weights and
  batch (a zero-weight padding sample included): metric, weights after Adam with weight decay and after SGD,
  BatchNorm state, Adam ``mu``, ``nu`` and ``count``, and the weight EMA.
* Checkpoints both ways: a port-written ``.npz`` restores in the JAX
  ``load_checkpoint`` with JAX templates; a JAX-written one resumes in the
  port, whose next step matches JAX's next step; a reference ``.pth``
  warm-starts the port with its Adam moments.
* The slice end to end: the port's CLI and ``train.py`` run 2 epochs from
  the same initial weights (augmentation and permutation off) to the same
  per-epoch val MAE and final weights, write the same artifact set, and the
  port's ``Model_best.npz`` serves through ``python -m
  resdepth_tpu_torch.predict`` and ``test.py``.
* The ``tpu`` knobs (the training precisions are
  ``test_torch_train_precision.py``'s): ``tpu.profile_dir`` writes a trace
  and changes no weight, ``tpu.distributed`` trains in a world of one
  process, ``tpu.dcn_slices`` 2 over one process raises and
  ``tpu.max_device_pixels`` trains with banded residency (multi-process
  worlds are ``test_torch_parallel*.py``'s).

Tolerances (f32 on the CPU; the two frameworks sum in different orders):
the metric and BN statistics rtol 1e-5; weights after a step rtol 1e-5 and
atol 1e-6 (an Adam step moves a weight by about lr = 1e-3, so 1e-6 is a
thousandth of a step); Adam moments 1e-4 relative L2 per tensor (they are
gradients and squared gradients, compared as gradients are in
``test_torch_unet.py``); end to end, val MAE within 1e-4 m and final
weights within 1e-4 relative L2 per tensor after 12 Adam steps.
"""

import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from resdepth_tpu.data import pipeline as jpipe
from resdepth_tpu.data.dataset import TileDataset as JTileDataset
from resdepth_tpu.models import unet as junet
from resdepth_tpu.train import checkpoint as jckpt
from resdepth_tpu.train.optim import build_optimizer as jbuild_optimizer
from resdepth_tpu.train.step import init_train_state as jinit_state
from resdepth_tpu.train.step import make_train_step as jmake_step
from resdepth_tpu_torch.data import pipeline as tpipe
from resdepth_tpu_torch.models import unet as tunet
from resdepth_tpu_torch.models import weights
from resdepth_tpu_torch.parallel import bootstrap
from resdepth_tpu_torch.train import checkpoint as tckpt
from resdepth_tpu_torch.train import cli
from resdepth_tpu_torch.train.step import init_train_state, make_train_step
from resdepth_tpu_torch.train.trainer import checkpoint_trees
from test_torch_infer import SCENE_ULPS
from test_torch_pipeline import _training_dataset, _training_scene
from test_torch_unet import _jax_weights, _rel_l2
from torch_unet import TorchUNet

LR = 1e-3
SETTINGS = dict(n_input_channels=3, start_kernel=4, max_filter_depth=8, depth=2,
                act_fn_encoder="prelu", outer_skip_BN=True)


def _setup(make_geotiff, seed=0):
    """The port's dataset, the JAX package's over the same files, and the
    same weights in both packages."""
    paths = _training_scene(make_geotiff)
    ds = _training_dataset(paths, "geom-stereo", "train")
    jds = _training_dataset(paths, "geom-stereo", "train", cls=JTileDataset)
    jconfig = junet.UNetConfig(**SETTINGS)
    params, state = _jax_weights(jconfig, seed)
    model = tunet.UNet(tunet.UNetConfig(**SETTINGS))
    model.load_state_dict(weights.state_dict_from_jax_params(params, state,
                                                             model.config))
    return ds, jds, jconfig, params, state, model


def _batch(ds, start, size=6):
    """``size - 1`` real samples and one zero-weight padding sample."""
    idx = np.arange(start, start + size) % len(ds)
    weights_ = np.ones(size, np.float32)
    weights_[-1] = 0.0
    return (ds.positions[idx], ds.pair_indices[idx], np.zeros((size, 4), np.int32),
            weights_)


def _jax_run(jds, jconfig, params, state, batches, name, wd, ema_decay=0.0,
             steps_per_call=1):
    tx = jbuild_optimizer(name, wd)
    jstate = jinit_state(params, state, tx, LR, ema=ema_decay > 0)
    spec = jpipe.batch_spec_for(jds)
    rasters = jpipe.device_put_dataset(jds)
    key = jax.random.PRNGKey(0)
    metrics = []
    if steps_per_call > 1:
        step = jmake_step(jconfig, spec, tx, donate=False, ema_decay=ema_decay,
                          steps_per_call=steps_per_call)
        stacked = [np.stack(a) for a in zip(*batches)]
        jstate, m = step(jstate, rasters, *stacked, key)
        return jstate, list(np.asarray(m))
    step = jmake_step(jconfig, spec, tx, donate=False, ema_decay=ema_decay)
    for batch in batches:
        jstate, m = step(jstate, rasters, *batch, key)
        metrics.append(float(m))
    return jstate, metrics


def _port_run(ds, model, batches, name, wd, ema_decay=0.0, state=None):
    state = state or init_train_state(model, name, LR, wd, ema=ema_decay > 0)
    rasters = tpipe.device_put_dataset(ds, "cpu", include_target=True)
    spec = tpipe.batch_spec_for(ds)
    generator = torch.Generator().manual_seed(0)
    step = make_train_step(spec, ema_decay=ema_decay)
    metrics = [float(step(state, rasters, *b, generator)) for b in batches]
    return state, metrics


def _assert_trees_close(got, want, rtol=1e-5, atol=1e-6):
    got, want = weights.flatten_keystr(got), weights.flatten_keystr(
        jax.tree_util.tree_map(np.asarray, want))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol,
                                   err_msg=key)


def _assert_moments_close(got, want):
    got, want = weights.flatten_keystr(got), weights.flatten_keystr(
        jax.tree_util.tree_map(np.asarray, want))
    assert got.keys() == want.keys()
    for key in want:
        assert _rel_l2(got[key], want[key]) <= 1e-4, key


def _adam_state(jstate, wd):
    """optax's ScaleByAdamState: second in the chain under weight decay."""
    return jstate.opt_state[1] if wd else jstate.opt_state


def _check_state(state, jstate, name, wd):
    trees = checkpoint_trees(state)
    params = trees["raw_params"] if state.ema_model is not None else trees["params"]
    _assert_trees_close(params, jstate.params)
    _assert_trees_close(trees["bn_state"], jstate.bn_state)
    if state.ema_model is not None:
        _assert_trees_close(trees["params"], jstate.ema_params)
    if name == "Adam":
        mu, nu, count = weights.adam_moments_to_jax(state.model, state.optimizer,
                                                    state.model.config)
        adam = _adam_state(jstate, wd)
        assert count == int(adam.count) == state.step
        _assert_moments_close(mu, adam.mu)
        _assert_moments_close(nu, adam.nu)


@pytest.mark.parametrize("name,wd,ema_decay", [
    ("Adam", 1e-5, 0.0), ("Adam", 0.0, 0.9), ("SGD", 1e-5, 0.0)],
    ids=["adam-wd", "adam-ema", "sgd-wd"])
def test_train_steps_match_jax(make_geotiff, name, wd, ema_decay):
    ds, jds, jconfig, params, state, model = _setup(make_geotiff)
    batches = [_batch(ds, 0), _batch(ds, 6)]
    jstate, jmetrics = _jax_run(jds, jconfig, params, state, batches, name, wd,
                                ema_decay)
    tstate, metrics = _port_run(ds, model, batches, name, wd, ema_decay)
    np.testing.assert_allclose(metrics, jmetrics, rtol=1e-5)
    assert tstate.step == 2
    _check_state(tstate, jstate, name, wd)


def test_steps_per_call_is_steps_in_sequence(make_geotiff):
    """JAX's scanned 3-step call (steps_per_call=3) equals three of the
    port's steps in sequence."""
    ds, jds, jconfig, params, state, model = _setup(make_geotiff, seed=1)
    batches = [_batch(ds, 6 * k) for k in range(3)]
    jstate, jmetrics = _jax_run(jds, jconfig, params, state, batches, "Adam",
                                1e-5, steps_per_call=3)
    tstate, metrics = _port_run(ds, model, batches, "Adam", 1e-5)
    np.testing.assert_allclose(metrics, jmetrics, rtol=1e-5)
    _check_state(tstate, jstate, "Adam", 1e-5)


@pytest.mark.parametrize("name,wd", [("Adam", 1e-5), ("Adam", 0.0), ("SGD", 1e-5)],
                         ids=["adam-chain", "adam-alone", "sgd"])
def test_port_checkpoint_restores_in_jax(make_geotiff, tmp_path, name, wd):
    """The port's .npz (EMA on, so raw_params too) loads in the JAX
    load_checkpoint with JAX templates, every leaf at the port's value."""
    ds, _, jconfig, params, state, model = _setup(make_geotiff, seed=2)
    tstate, _ = _port_run(ds, model, [_batch(ds, 0)], name, wd, ema_decay=0.5)
    path = str(tmp_path / "Model_last.npz")
    trees = checkpoint_trees(tstate)
    tckpt.save_checkpoint(path, epoch=4, lr=LR, loss_val=0.5, **trees)

    tx = jbuild_optimizer(name, wd)
    template = jinit_state(params, state, tx, LR)
    meta, jparams, jbn, jopt, jraw = jckpt.load_checkpoint(
        path, params_template=template.params, bn_template=template.bn_state,
        opt_template=template.opt_state, raw_template=template.params)
    assert meta["epoch"] == 4 and meta["loss_val"] == 0.5 and meta["format_version"] == 1
    _assert_trees_close(trees["params"], jparams, rtol=0, atol=0)
    _assert_trees_close(trees["bn_state"], jbn, rtol=0, atol=0)
    _assert_trees_close(trees["raw_params"], jraw, rtol=0, atol=0)
    assert (jax.tree_util.tree_structure(jopt)
            == jax.tree_util.tree_structure(template.opt_state))
    if name == "Adam":
        mu, nu, count = weights.adam_moments_to_jax(tstate.model, tstate.optimizer,
                                                    tstate.model.config)
        adam = jopt[1] if wd else jopt
        assert int(adam.count) == count == 1
        _assert_trees_close(mu, adam.mu, rtol=0, atol=0)
        _assert_trees_close(nu, adam.nu, rtol=0, atol=0)
    else:
        assert jax.tree_util.tree_leaves(jopt) == []
    # and back into the port
    loaded = tckpt.load_checkpoint(path)
    assert loaded["meta"] == meta
    _assert_trees_close(loaded["raw_params"], trees["raw_params"], rtol=0, atol=0)


def test_jax_checkpoint_resumes_in_port(make_geotiff, tmp_path):
    """JAX steps once and saves; the port restores the file (weights, BN,
    Adam state) and steps on the next batch to JAX's second step."""
    ds, jds, jconfig, params, state, _ = _setup(make_geotiff, seed=3)
    b1, b2 = _batch(ds, 0), _batch(ds, 6)
    jstate1, _ = _jax_run(jds, jconfig, params, state, [b1], "Adam", 1e-5)
    path = str(tmp_path / "Model_last.npz")
    jckpt.save_checkpoint(path, epoch=0, params=jstate1.params,
                          bn_state=jstate1.bn_state, opt_state=jstate1.opt_state,
                          lr=LR)
    jstate2, jmetrics = _jax_run(jds, jconfig, params, state, [b1, b2], "Adam", 1e-5)

    model = tunet.init_unet(tunet.UNetConfig(**SETTINGS), torch.Generator().manual_seed(0))
    tstate = init_train_state(model, "Adam", LR, 1e-5)
    meta = cli.restore(tstate, path, model.config, "Adam", _Logger())
    assert meta["epoch"] == 0
    _, metrics = _port_run(ds, model, [b2], "Adam", 1e-5, state=tstate)
    np.testing.assert_allclose(metrics, jmetrics[1:], rtol=1e-5)
    tstate.step = 2
    _check_state(tstate, jstate2, "Adam", 1e-5)


class _Logger:
    def info(self, message):
        pass


def test_reference_pth_warm_starts_with_adam_moments(tmp_path):
    """A reference .pth ({model_state_dict, optimizer_state_dict, ...}) from
    the torch oracle after one Adam step: the port restores the weights and
    the moments by parameter position, as the JAX importer reads them."""
    from resdepth_tpu.models import torch_import

    torch.manual_seed(0)
    oracle = TorchUNet(**SETTINGS)
    opt = torch.optim.Adam(oracle.parameters(), lr=LR, weight_decay=1e-5)
    x = torch.randn(2, 3, 16, 16)
    oracle(x).square().mean().backward()
    opt.step()
    path = str(tmp_path / "Model_best.pth")
    torch.save({"epoch": 7, "model_state_dict": oracle.state_dict(),
                "optimizer_state_dict": opt.state_dict(), "loss_val": 0.25,
                "scheduler_state_dict": {"last_epoch": 7, "_last_lr": [LR / 2],
                                         "base_lrs": [LR], "step_size": 5,
                                         "gamma": 0.5}}, path)

    model = tunet.UNet(tunet.UNetConfig(**SETTINGS))
    state = init_train_state(model, "Adam", LR, 1e-5)
    meta = cli.restore(state, path, model.config, "Adam", _Logger())
    for (name, p), q in zip(model.named_parameters(), oracle.parameters()):
        assert torch.equal(p, q), name
        entry = state.optimizer.state[p]
        assert torch.equal(entry["exp_avg"], opt.state[q]["exp_avg"]), name
        assert int(entry["step"]) == 1
    assert meta["epoch"] == 7 and meta["loss_val"] == 0.25 and meta["lr"] == LR
    assert meta["scheduler_state"]["lr"] == LR / 2

    jconfig = junet.UNetConfig(**SETTINGS)
    _, _, (jmu, jnu, jcount), jmeta = torch_import.load_reference_checkpoint(path, jconfig)
    mu, nu, count = weights.adam_moments_to_jax(model, state.optimizer, model.config)
    assert count == jcount == 1 and jmeta == meta
    _assert_trees_close(mu, jmu, rtol=0, atol=0)
    _assert_trees_close(nu, jnu, rtol=0, atol=0)


# ------------------------------ the slice end to end ----------------------- #

E2E_MODEL = dict(depth=2, start_kernel=4, max_filter_depth=8)


def _e2e_config(work, scene, root, init, **overrides):
    """Two epochs of 6 steps, augmentation and permutation off, warm-started
    from ``init`` so both trainers begin from the same weights."""
    sections = dict(
        n_samples=24, suffix="e2e",
        model={**E2E_MODEL, **({"pretrained_path": init} if init else {})},
        training={"tile_size": 16, "batch_size": 4, "n_epochs": 2, "augment": False},
        stereopair_settings={"use_all_stereo_pairs": True,
                             "permute_images_within_pair": False},
        optimizer={"name": "Adam", "learning_rate": LR},
        scheduler={"enabled": True, "name": "StepLR",
                   "settings": {"step_size": 1, "gamma": 0.5}},
        general={"save_model_rate": 2, "evaluate_rate": 1, "random_seed": 0},
        tpu={"data_parallel": False})
    sections.update(overrides)
    return chip_smoke.write_train_config(os.path.join(work, f"{os.path.basename(root)}.json"),
                                         scene["paths"], root, **sections)


def _val_maes(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return [(r["step"], r["value"]) for r in lines if r.get("tag") == "val/MAE_metric"]


def _listing(run_dir):
    return sorted(os.path.relpath(os.path.join(d, f), run_dir)
                  for d, _, files in os.walk(run_dir) for f in files
                  if not f.startswith("events."))


@pytest.fixture(scope="module")
def e2e_runs(tmp_path_factory):
    """The JAX train.py and the port's CLI on the same scene and config."""
    import train as jax_train
    from resdepth_tpu.config.schema import count_input_channels

    work = str(tmp_path_factory.mktemp("e2e"))
    scene = chip_smoke.write_scene(os.path.join(work, "scene"), 96, 96)
    jconfig = junet.UNetConfig(n_input_channels=count_input_channels("geom-stereo"),
                               bias_conv_layer=True, **E2E_MODEL)
    params, bn_state = junet.init_unet(jax.random.PRNGKey(5), jconfig)
    init = os.path.join(work, "init", "checkpoints", "init.npz")
    os.makedirs(os.path.dirname(init))
    jckpt.save_checkpoint(init, epoch=-1, params=params, bn_state=bn_state,
                          opt_state=jbuild_optimizer("Adam", 1e-5).init(params))
    runs = {}
    argv = sys.argv
    try:
        sys.argv = ["train.py", _e2e_config(work, scene, os.path.join(work, "jax"), init)]
        jax_train.main()
    finally:
        sys.argv = argv
    runs["jax"] = chip_smoke.run_dir_of(os.path.join(work, "jax"), "e2e")
    trainer = cli.main([_e2e_config(work, scene, os.path.join(work, "port"), init),
                        "--device", "cpu"])
    runs["port"] = chip_smoke.run_dir_of(os.path.join(work, "port"), "e2e")
    return {"work": work, "scene": scene, "runs": runs, "trainer": trainer}


def test_cli_trains_like_train_py(e2e_runs):
    """Same per-epoch val MAE and final weights as the JAX trainer."""
    runs = e2e_runs["runs"]
    want, got = _val_maes(runs["jax"]), _val_maes(runs["port"])
    assert [e for e, _ in got] == [e for e, _ in want] == [0, 1]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=0, atol=1e-4)
    assert e2e_runs["trainer"].val_history == got
    last = {name: tckpt.load_checkpoint(os.path.join(run, "checkpoints",
                                                     "Model_last.npz"))
            for name, run in runs.items()}
    assert last["port"]["meta"]["epoch"] == last["jax"]["meta"]["epoch"] == 1
    np.testing.assert_allclose(last["port"]["meta"]["lr"], last["jax"]["meta"]["lr"],
                               rtol=1e-6)
    assert last["port"]["meta"]["scheduler_state"] == last["jax"]["meta"]["scheduler_state"]
    for tree in ("params", "bn_state"):
        got_leaves = weights.flatten_keystr(last["port"][tree])
        want_leaves = weights.flatten_keystr(last["jax"][tree])
        assert got_leaves.keys() == want_leaves.keys()
        for key in want_leaves:
            assert _rel_l2(got_leaves[key], want_leaves[key]) <= 1e-4, key
    assert last["port"]["adam"][2] == last["jax"]["adam"][2] == 12


def test_cli_writes_the_train_py_artifacts(e2e_runs):
    runs = e2e_runs["runs"]
    assert _listing(runs["port"]) == _listing(runs["jax"])
    assert "checkpoints/Model_best.npz" in _listing(runs["port"])
    for name in ("config.json", "model_config.json"):
        with open(os.path.join(runs["port"], name)) as f:
            port = json.load(f)
        with open(os.path.join(runs["jax"], name)) as f:
            want = json.load(f)
        if name == "config.json":
            for cfg in (port, want):
                cfg["output"] = {k: v for k, v in cfg["output"].items()
                                 if k == "suffix"}
        assert port == want, name


def test_port_checkpoint_serves_in_both_clis(e2e_runs, monkeypatch):
    """The port's Model_best.npz refines the scene through the port's
    predict CLI and through test.py, to the same heights within
    ``SCENE_ULPS`` f32 ulps of the largest (2 measured, near 451 m)."""
    import test as jax_test
    from resdepth_tpu.geo.raster import open_raster

    work, scene = e2e_runs["work"], e2e_runs["scene"]
    model = chip_smoke.serving_model_artifacts(e2e_runs["runs"]["port"])
    out = {}
    for name in ("port", "jax"):
        out_dir = os.path.join(work, f"serve_{name}")
        config = chip_smoke.write_config(os.path.join(work, f"serve_{name}.json"),
                                         scene["paths"], model, out_dir,
                                         tile_size=16, batch_size=8)
        if name == "port":
            chip_smoke.run_cli(config, "cpu")
        else:
            monkeypatch.setattr(sys, "argv", ["test.py", config])
            jax_test.main()
        path = chip_smoke.output_paths(out_dir)["prediction"]
        out[name] = open_raster(path).band(1)
    assert np.isfinite(out["port"]).all() and out["port"].shape == (96, 96)
    np.testing.assert_allclose(out["port"], out["jax"], rtol=0,
                               atol=chip_smoke.ulps(out["jax"], SCENE_ULPS))


@pytest.mark.parametrize("overrides,raises", [
    (dict(tpu={"distributed": True}), None),
    (dict(tpu={"dcn_slices": 2}), (ValueError, "1 devices not divisible into 2 slices")),
    (dict(tpu={"profile_dir": "trace"}), None),
    (dict(tpu={"max_device_pixels": 2048}), None)],
    ids=["distributed", "dcn_slices", "profile_dir", "max_device_pixels"])
def test_not_ported_knobs_raise(e2e_runs, tmp_path, monkeypatch, overrides, raises):
    """The ``tpu`` knobs of ROADMAP.md's items 7, 10 and 11, ported.
    ``tpu.profile_dir`` (item 11) trains, writes a trace of the first
    epoch with one ``train#N`` annotation a step, and leaves
    ``Model_last.npz`` bitwise its untraced twin's. The multi-process knobs are item 10:
    ``tpu.distributed`` joins the process group through torchrun's
    ``env://`` variables (here a world of one process over gloo, every
    collective a copy) and trains; ``tpu.dcn_slices`` 2 over one process
    raises as ``train.py``'s mesh does. Under ``tpu.max_device_pixels``
    (item 7, ported) every region over the budget trains with banded
    residency and the run writes its checkpoints."""
    root = str(tmp_path / "runs")
    if "profile_dir" in overrides["tpu"]:
        overrides = dict(tpu={"profile_dir": str(tmp_path / "trace")})
    config = _e2e_config(str(tmp_path), e2e_runs["scene"], root, None, **overrides)
    if "profile_dir" in overrides["tpu"]:
        traced = cli.main([config, "--device", "cpu"])
        twin_root = str(tmp_path / "twin")
        twin = cli.main([_e2e_config(str(tmp_path), e2e_runs["scene"], twin_root, None),
                         "--device", "cpu"])
        traces = os.listdir(tmp_path / "trace")
        assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
        with open(tmp_path / "trace" / traces[0]) as f:
            names = [e["name"] for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "user_annotation" and e["name"].startswith("train#")]
        assert sorted(names, key=lambda n: int(n.split("#")[1])) == [
            f"train#{i}" for i in range(6)]    # epoch 0's 6 steps
        assert traced.val_history == twin.val_history
        last = [tckpt.load_checkpoint(os.path.join(chip_smoke.run_dir_of(r, "e2e"),
                                                   "checkpoints", "Model_last.npz"))
                for r in (root, twin_root)]
        for tree in ("params", "bn_state"):
            a, b = (weights.flatten_keystr(c[tree]) for c in last)
            assert a.keys() == b.keys()
            assert all(np.array_equal(a[k], b[k]) for k in a), tree
        return
    if raises is not None:
        with pytest.raises(raises[0], match=raises[1]):
            cli.main([config, "--device", "cpu"])
        return
    if "distributed" in overrides["tpu"]:
        for name, value in (("MASTER_ADDR", "localhost"), ("RANK", "0"),
                            ("WORLD_SIZE", "1"),
                            ("MASTER_PORT", str(bootstrap.free_port()))):
            monkeypatch.setenv(name, value)
        try:
            trainer = cli.main([config, "--device", "cpu"])
            assert torch.distributed.get_world_size() == 1
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
        run = chip_smoke.run_dir_of(root, "e2e")
        with open(os.path.join(run, "run.log")) as f:
            assert "Data-parallel mesh: {'data': 1}" in f.read()
        assert os.path.exists(os.path.join(run, "checkpoints", "Model_last.npz"))
        assert [e for e, _ in trainer.val_history] == [0, 1]
        assert np.isfinite([v for _, v in trainer.val_history]).all()
        return
    trainer = cli.main([config, "--device", "cpu"])
    run = chip_smoke.run_dir_of(root, "e2e")
    with open(os.path.join(run, "run.log")) as f:
        log = f.read()
    bands = [int(n) for n in re.findall(r"banded residency, (\d+) bands", log)]
    assert re.search(r"train region 0: [\d,]+ px > budget", log) and min(bands) > 1
    assert trainer.group_chunks_by_loader
    assert len(trainer.train_loaders) == bands[0]
    assert all(p.source._resident is None for p, _ in trainer.train_loaders)
    for name in ("Model_best.npz", "Model_last.npz"):
        assert os.path.exists(os.path.join(run, "checkpoints", name))
    assert [e for e, _ in trainer.val_history] == [0, 1]
    assert np.isfinite([v for _, v in trainer.val_history]).all()


def test_device_is_checked_before_training(e2e_runs, tmp_path, monkeypatch):
    """``--device cuda`` without CUDA raises; with 2 visible GPUs a plain
    launch hands the CLI to one process per GPU (``launch_per_gpu``,
    recorded here, not run); ``RESDEPTH_DISTRIBUTED=1`` on the CPU joins
    over gloo through ``env://`` before it trains (refused here)."""
    config = _e2e_config(str(tmp_path), e2e_runs["scene"], str(tmp_path / "runs"),
                         None, tpu={"data_parallel": True})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([config])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    launches = []
    monkeypatch.setattr(bootstrap, "launch_per_gpu", lambda *args: launches.append(args))
    assert cli.main([config, "--device", "cuda"]) is None
    assert launches == [("resdepth_tpu_torch.train.cli", [config, "--device", "cuda"], 2)]
    monkeypatch.setenv("RESDEPTH_DISTRIBUTED", "1")
    inits = []

    def refuse(backend, **kwargs):
        inits.append((backend, kwargs["init_method"]))
        raise RuntimeError("no torchrun cluster here")

    monkeypatch.setattr(torch.distributed, "init_process_group", refuse)
    with pytest.raises(RuntimeError, match="no torchrun cluster here"):
        cli.main([config, "--device", "cpu"])
    assert inits == [("gloo", "env://")]


def test_cli_auto_resumes_from_model_last(e2e_runs, tmp_path):
    """``general.auto_resume`` continues from the newest ``Model_last.npz``
    under the output root: epoch numbering goes on at 2, the resumed model
    carries the first run's Model_best and its best loss."""
    import shutil

    root = str(tmp_path / "runs")
    shutil.copytree(e2e_runs["runs"]["port"],
                    os.path.join(root, os.path.basename(e2e_runs["runs"]["port"])))
    config = _e2e_config(str(tmp_path), e2e_runs["scene"], root, None,
                         suffix="resumed",
                         training={"tile_size": 16, "batch_size": 4, "n_epochs": 1,
                                   "augment": False},
                         general={"save_model_rate": 2, "evaluate_rate": 1,
                                  "random_seed": 0, "auto_resume": True})
    trainer = cli.main([config, "--device", "cpu"])
    first = e2e_runs["trainer"]
    assert trainer.start_epoch == 2 and [e for e, _ in trainer.val_history] == [2]
    assert trainer.best_loss == min(first.best_loss, trainer.val_history[0][1])
    resumed = chip_smoke.run_dir_of(root, "resumed")
    assert os.path.exists(os.path.join(resumed, "checkpoints", "Model_best.npz"))
    meta = tckpt.load_meta(os.path.join(resumed, "checkpoints", "Model_last.npz"))
    assert meta["epoch"] == 2
    # StepLR(step_size 1, gamma 0.5) stepped once more after the resume
    assert meta["scheduler_state"]["n_steps"] == 3


# ---- the host random streams against JAX's (ROADMAP section 3's open fault) ---- #

@pytest.mark.parametrize("channels,pairs,kwargs", [
    ("geom-stereo", ((2, 1), (0, 1)), dict(use_all_stereo_pairs=True)),
    ("geom-stereo", ((2, 1), (0, 1), (0, 2)), {}),
    ("geom", (), {}),
], ids=["stereo-cross-product", "stereo-random-pairs", "geom"])
def test_training_positions_match_jax(make_geotiff, channels, pairs, kwargs):
    """The 'train' TileDataset's chosen positions and pair draws
    (``resdepth_tpu/data/dataset.py:196``) for the same seed."""
    paths = _training_scene(make_geotiff)
    got = _training_dataset(paths, channels, "train", pairs=pairs, augment=True, **kwargs)
    want = _training_dataset(paths, channels, "train", pairs=pairs, augment=True,
                             cls=JTileDataset, **kwargs)
    np.testing.assert_array_equal(got.positions, want.positions)
    np.testing.assert_array_equal(got.pair_indices, want.pair_indices)


@pytest.mark.parametrize("grouped", [False, True], ids=["shuffled", "grouped-by-loader"])
def test_epoch_sample_order_matches_jax(make_geotiff, grouped):
    """Each epoch's batches, padding and weights (``BatchIndexIterator``,
    ``resdepth_tpu/data/pipeline.py:292-302``) and the trainer's chunk
    order (``_epoch_chunks``, the epoch rng of
    ``resdepth_tpu/train/trainer.py:105``) over 3 epochs of two loaders
    with a padded last batch, for the seeds the train CLIs give them."""
    from types import SimpleNamespace

    from resdepth_tpu.train.trainer import Trainer as JTrainer
    from resdepth_tpu_torch.data.dataset import TileDataset as TTileDataset
    from resdepth_tpu_torch.train.trainer import Trainer as TTrainer

    paths = _training_scene(make_geotiff)
    seed = 7

    def run(pipe, dataset_cls, trainer_cls):
        loaders = [(None, pipe.BatchIndexIterator(
            _training_dataset(paths, "geom-stereo", "train", cls=dataset_cls, augment=True),
            5, shuffle=True, seed=seed + 1000 + i)) for i in range(2)]
        trainer = SimpleNamespace(epoch_rng=np.random.default_rng(seed), steps_per_call=2,
                                  group_chunks_by_loader=grouped)
        return [trainer_cls._epoch_chunks(trainer, loaders) for _ in range(3)]

    got = run(tpipe, TTileDataset, TTrainer)
    want = run(jpipe, JTileDataset, JTrainer)
    for got_epoch, want_epoch in zip(got, want):
        assert [loader for loader, _ in got_epoch] == [loader for loader, _ in want_epoch]
        for (_, got_chunk), (_, want_chunk) in zip(got_epoch, want_epoch):
            assert len(got_chunk) == len(want_chunk)
            for got_batch, want_batch in zip(got_chunk, want_chunk):
                for g, w in zip(got_batch, want_batch):   # positions, pairs, bounds, weights
                    np.testing.assert_array_equal(g, w)
    weights = [b[3] for _, chunk in got[0] for b in chunk]
    assert any(w.min() == 0 for w in weights)   # a padded last batch was compared


def test_augment_draws_each_symmetry_at_one_eighth():
    """The port's ``_augment`` hits each of the square's 8 symmetries with
    probability 1/8 over 64k draws, within 4 sigma, as JAX's ``_augment``
    (``resdepth_tpu/data/pipeline.py:158-180``) does on the same count."""
    n = 65536
    base = torch.arange(4, dtype=torch.float32).reshape(1, 1, 2, 2)
    # the 8 images of [[0, 1], [2, 3]] under the dihedral group, by pixel order
    symmetries = {tuple(t.flatten().tolist()) for t in (
        torch.rot90(base, k, (2, 3)).flip(f) if f else torch.rot90(base, k, (2, 3))
        for k in range(4) for f in ((), (3,)))}
    assert len(symmetries) == 8

    def freqs(images):
        keys = [tuple(row) for row in images.reshape(n, 4).tolist()]
        return {s: keys.count(s) / n for s in symmetries}, set(keys)

    generator = torch.Generator().manual_seed(0)
    port, seen = freqs(tpipe._augment(base.expand(n, 1, 2, 2), generator).numpy())
    jax_images = np.asarray(jpipe._augment(
        jax.numpy.broadcast_to(jax.numpy.arange(4.0).reshape(1, 2, 2, 1), (n, 2, 2, 1)),
        jax.random.PRNGKey(0)))
    jax_freqs, jax_seen = freqs(jax_images)
    sigma = (0.125 * 0.875 / n) ** 0.5
    assert seen == symmetries == jax_seen
    for s in symmetries:
        assert abs(port[s] - 0.125) <= 4 * sigma, (s, port[s])
        assert abs(jax_freqs[s] - 0.125) <= 4 * sigma, (s, jax_freqs[s])
