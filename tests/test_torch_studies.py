"""The port's studies (``resdepth_tpu_torch.studies``) on the CPU, beside the
JAX package's scripts.

* ``convergence_study gen`` writes GeoTIFFs byte for byte the JAX script's
  ``generate_scene`` at scene seed 3 (toy size), and the same lists.
* ``convergence_study port`` at 2 epochs of 40 samples on the CPU trains
  and serves through the port's CLIs and writes a result with the JAX arm's
  keys, which ``report`` prints beside the JAX anchors.
* ``channel_modes_study`` runs each of the five channel modes at the smoke
  model (depth 2, start 4, 32-px tiles, 8 steps), and the cache it writes
  loads in the JAX package's ``load_checkpoint`` with the study's key.
* For ``geom``, a ``--state-cache-dir`` written by the JAX study loads in the
  port, whose float32 refined MAE and ``balanced16`` deviation then match
  the JAX study's within 1e-4 m and 1e-3 cm (the JAX study rounds them to
  1e-4 m and 1e-3 cm, the port does not).
* ``models/unet.py``'s ``analytic_flops``, ``param_count`` and
  ``describe_unet`` equal the JAX package's, as integers and as text.
* ``precision_study --state-cache``: a JAX-written cache loads in the port
  (at 'default', the precision JAX trains at), the port's in JAX's
  ``load_checkpoint``, and a cache of another ``study_key`` is refused.
  ``--attrib``'s all-HIGH reference forward equals JAX's within rtol 1e-5;
  XLA:CPU runs every precision as exact f32, so the demoted layer is held
  instead to a float64 sum of its 1-pass products (bf16-rounded operands),
  within 1e-5 of the largest output.
* The stride, TTA (mode B) and TTA x stride studies from one JAX-written
  cache: each cell's refined MAE within 1e-4 m of JAX's
  ``predict_linear_blend`` on the same scene at float32, and within 1e-3 cm
  at ``balanced16``; TTA mode A re-serves a convergence run's checkpoint.
* ``bilinear_study`` and ``ema_study`` write the JAX studies' result keys;
  ``train_roofline``'s traffic model equals JAX's byte for byte, with the
  H100's constants in its bounds; ``train_throughput_study`` runs a cell;
  ``config_smoke`` runs 2 sampled cases through the port's CLIs.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from resdepth_tpu.models import unet as junet
from resdepth_tpu.train import checkpoint as jckpt
from resdepth_tpu_torch.models import unet as tunet
from resdepth_tpu_torch.studies import (bilinear_study, channel_modes_study, config_smoke,
                                        convergence_study, ema_study, precision_study,
                                        stride_study, train_roofline,
                                        train_throughput_study, tta_stride_study, tta_study)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The result keys of the JAX script's arm (scripts/convergence_study.py::run_jax).
JAX_ARM_KEYS = {"side", "tag", "seed", "scene_seed", "epochs", "scheduler", "precision",
                "batch", "lr", "remat", "backend", "val_curve", "lr_curve",
                "best_val_mae", "best_epoch", "final_lr", "refined_test_mae",
                "initial_test_mae", "train_wall_time_s"}
SMOKE = ["--smoke-model", "--tile", "32", "--steps", "8", "--rows", "96", "--cols", "128",
         "--dev-rows", "64", "--bench-batch", "2", "--iters", "1"]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_gen_writes_the_jax_scene(tmp_path):
    jax_study = _jax_script("convergence_study")
    want = jax_study.generate_scene(str(tmp_path / "jax"), 3)
    got = convergence_study.generate_scene(str(tmp_path / "port"), 3)
    assert got["paths"].keys() == want["paths"].keys()
    for key, path in want["paths"].items():
        with open(path, "rb") as f, open(got["paths"][key], "rb") as g:
            assert f.read() == g.read(), key
    for name in ("imagelist.txt", "pairlist.txt", "scene.json"):
        with open(tmp_path / "jax" / name) as f, open(tmp_path / "port" / name) as g:
            assert f.read().replace("/jax/", "/port/") == g.read(), name


def test_port_arm_writes_the_jax_arms_keys(tmp_path, capsys):
    out = str(tmp_path / "study")
    convergence_study.main(["gen", "--out", out])
    convergence_study.main(["port", "--out", out, "--epochs", "2", "--samples", "40",
                            "--device", "cpu"])
    with open(os.path.join(out, "results", "port_seed0_steplr_balanced16.json")) as f:
        result = json.load(f)
    assert set(result) == JAX_ARM_KEYS
    assert result["side"] == "resdepth-tpu-torch" and result["backend"] == "cpu"
    assert [e for e, _ in result["val_curve"]] == [0, 1]
    assert result["final_lr"] == 2e-4 and result["batch"] == 20
    assert np.isfinite([result["refined_test_mae"], result["initial_test_mae"]]).all()
    capsys.readouterr()
    convergence_study.main(["report", "--out", out])
    printed = capsys.readouterr().out
    assert "| resdepth-tpu-torch seed0_steplr_balanced16 (balanced16) | cpu |" in printed
    assert f"{result['refined_test_mae']:.4f}" in printed
    assert "balanced16: 0.1603 ± 0.0074 m" in printed


@pytest.mark.parametrize("mode", sorted(channel_modes_study.MODE_PAIRS))
def test_channel_modes_study_runs_each_mode(tmp_path, mode):
    cache = str(tmp_path / "cache")
    results = channel_modes_study.main(["--device", "cpu", "--modes", mode,
                                        "--state-cache-dir", cache, *SMOKE])
    assert results["device"] == "cpu"
    for key in ("f32_tiles_s", "balanced16_tiles_s", "balanced16_dev_cm",
                "bfloat16_dev_cm"):
        assert np.isfinite(results[f"{mode}_{key}"]) and results[f"{mode}_{key}"] >= 0
    assert np.isfinite(list(results[f"{mode}_dev_scene_mae"].values())).all()
    # The reverse of the JAX cache test: the port's cache in the JAX loader.
    path = os.path.join(cache, f"{mode}.npz")
    assert jckpt.load_meta(path)["study_key"] == {
        "scene_seed": 3, "steps": 8, "rows": 96, "cols": 128, "batch": 20, "tile": 32,
        "mode": mode, "smoke": True}
    config = channel_modes_study.mode_config(mode, smoke=True)
    jconfig = junet.UNetConfig(n_input_channels=config.n_input_channels, depth=2,
                               start_kernel=4, max_filter_depth=8,
                               outer_skip=config.outer_skip)
    params, bn = junet.init_unet(jax.random.PRNGKey(0), jconfig)
    _, loaded, _, _ = jckpt.load_checkpoint(path, params_template=params, bn_template=bn)
    assert np.isfinite(np.asarray(loaded["encoder"][0]["conv"]["kernel"])).all()


def test_jax_cache_loads_in_the_port_geom(tmp_path):
    cache, want_json = str(tmp_path / "cache"), str(tmp_path / "jax.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu", RESDEPTH_COMPILATION_CACHE="off")
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "channel_modes_study.py"),
                    "--modes", "geom", "--state-cache-dir", cache, "--json", want_json,
                    *SMOKE], env=env, cwd=REPO, check=True, capture_output=True,
                   timeout=600)
    with open(want_json) as f:
        want = json.load(f)
    written = os.path.getmtime(os.path.join(cache, "geom.npz"))
    got = channel_modes_study.main(["--device", "cpu", "--modes", "geom",
                                    "--state-cache-dir", cache, *SMOKE])
    assert os.path.getmtime(os.path.join(cache, "geom.npz")) == written   # loaded, not trained
    assert abs(got["geom_dev_scene_mae"]["refined_f32"]
               - want["geom_dev_scene_mae"]["refined_f32"]) <= 1e-4
    assert abs(got["geom_dev_scene_mae"]["input"] - want["geom_dev_scene_mae"]["input"]) <= 1e-4
    assert abs(got["geom_balanced16_dev_cm"] - want["geom_balanced16_dev_cm"]) <= 1e-3


# ------------------------------ model helpers ------------------------------ #

HELPER_CONFIGS = {
    "flagship": {},
    "smoke-bilinear-prelu": dict(depth=2, start_kernel=4, max_filter_depth=8,
                                 up_mode="bilinear", act_fn_encoder="prelu"),
    "narrow-outer-skip-bn-no-bn": dict(depth=3, start_kernel=8, max_filter_depth=16,
                                       outer_skip_BN=True, do_BN=False),
}


@pytest.mark.parametrize("name", sorted(HELPER_CONFIGS))
def test_model_helpers_equal_jax(name):
    import torch

    fields = dict(n_input_channels=3, **HELPER_CONFIGS[name])
    config, jconfig = tunet.UNetConfig(**fields), junet.UNetConfig(**fields)
    for tile in (64, 256):
        for composed in (False, True):
            assert tunet.analytic_flops(config, tile, composed_top=composed) == \
                junet.analytic_flops(jconfig, tile, composed_top=composed)
    from resdepth_tpu_torch.models.weights import jax_params_from_state_dict

    model = tunet.init_unet(config, torch.Generator().manual_seed(0))
    # the JAX functions on the same weights in the JAX layout (the layout
    # itself is held to JAX's init by the checkpoint tests)
    params, _ = jax_params_from_state_dict(model.state_dict(), config)
    assert tunet.param_count(model) == junet.param_count(params)
    for tile in (None, 64):
        assert tunet.describe_unet(model, tile) == junet.describe_unet(jconfig, params, tile)


# ------------------------ the precision study's cache ---------------------- #

SMALL = ["--device", "cpu", "--steps", "2", "--batch", "2", "--rows", "64", "--cols", "96",
         "--tile", "32", "--depth", "2", "--start-kernel", "4", "--seeds", "3"]
JAX_KEY = {"scene_seed": 3, "steps": 2, "rows": 64, "cols": 96, "batch": 2}
CITY = 128          # the serving studies' scene, square


def _jax_smoke_config():
    return junet.UNetConfig(n_input_channels=3, depth=2, start_kernel=4, max_filter_depth=32)


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    """A state cache the JAX package wrote: its checkpoint layout and the
    JAX study's five-field key, for the smoke model; BatchNorm statistics
    moved off the identity so that the fold has work to do."""
    path = str(tmp_path_factory.mktemp("jax_cache") / "s3.npz")
    params, bn = junet.init_unet(jax.random.PRNGKey(0), _jax_smoke_config())
    rng = np.random.default_rng(5)
    bn = jax.tree_util.tree_map(
        lambda leaf: np.asarray(leaf) * rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        + rng.normal(0, 0.1, leaf.shape).astype(np.float32), bn)
    jckpt.save_checkpoint(path, epoch=0, params=params, bn_state=bn,
                          extra={"study_key": dict(JAX_KEY)})
    return path, params, bn


def test_jax_cache_loads_in_the_port(jax_cache):
    path, params, _ = jax_cache
    written = os.path.getmtime(path)
    got = precision_study.main([*SMALL, "--bench-batch", "2", "--train-precision", "default",
                                "--state-cache", path])
    assert os.path.getmtime(path) == written   # loaded, not trained
    assert {r["mode"] for r in got} == set(precision_study.MODES[1:])
    config = precision_study.study_config(2, 4)
    import torch
    model, meta = precision_study.load_state_cache(path, config, torch.device("cpu"))
    assert meta["study_key"] == JAX_KEY
    np.testing.assert_array_equal(model.encoder[0][0][0].weight.detach().numpy(),
                                  np.asarray(params["encoder"][0]["conv"]["kernel"])
                                  .transpose(3, 2, 0, 1))


def test_port_cache_loads_in_jax_and_reads_back(tmp_path):
    path = str(tmp_path / "s3.npz")
    precision_study.main([*SMALL, "--state-cache", path, "--attrib"])
    key = {**JAX_KEY, "train_precision": "high"}
    assert jckpt.load_meta(path)["study_key"] == key
    template, bn = junet.init_unet(jax.random.PRNGKey(1), _jax_smoke_config())
    _, loaded, loaded_bn, _ = jckpt.load_checkpoint(path, params_template=template,
                                                    bn_template=bn)
    import torch
    model, _ = precision_study.load_state_cache(path, precision_study.study_config(2, 4),
                                                torch.device("cpu"), key)
    np.testing.assert_array_equal(model.last_layer.weight.detach().numpy(),
                                  np.asarray(loaded["last"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        model.encoder[0][0][1].running_var.numpy(),
        np.asarray(loaded_bn["encoder"][0]["bn"]["var"]))


@pytest.mark.parametrize("args", [["--train-precision", "high"], ["--steps", "3"]],
                         ids=["precision", "steps"])
def test_mismatched_study_key_is_refused(jax_cache, args):
    path = jax_cache[0]
    argv = [*SMALL, "--state-cache", path, "--attrib"]
    for flag, value in zip(args[::2], args[1::2]):
        if flag in argv:
            argv[argv.index(flag) + 1] = value
        else:
            argv += [flag, value]
    with pytest.raises(SystemExit, match="refusing to mix scenes/protocols"):
        precision_study.main(argv)


def test_attrib_matches_jax_and_float64(jax_cache, tmp_path):
    """``--attrib`` against JAX and float64. XLA:CPU runs every precision as
    exact f32 (``resdepth_tpu/models/unet.py:263-274``), so JAX's all-HIGH
    forward is exact f32 here and the port's 3-pass reference sits about
    1.5e-4 from it: the port's graph at HIGHEST (IEEE f32) is held to JAX's
    all-HIGH forward within rtol 1e-5, and every conv of the attribution to
    a float64 sum of its passes' products (bf16 hi/lo operands; 3 passes
    hi*hi + hi*lo + lo*hi, 1 pass hi*hi) within 1e-5 of its largest output.
    Each solo-demoted run demotes that layer alone."""
    import dataclasses
    from unittest import mock

    import jax.numpy as jnp
    import torch

    from resdepth_tpu.data import pipeline as jpipe
    from resdepth_tpu.data.dataset import TileDataset as JTileDataset
    from resdepth_tpu_torch.data.pipeline import build_batch, device_put_dataset
    from resdepth_tpu_torch.infer.tiled import _inference_spec, serving_model
    from resdepth_tpu_torch.ops import passes as pass_ops

    path, params, bn = jax_cache
    device = torch.device("cpu")
    model, _ = precision_study.load_state_cache(path, precision_study.study_config(2, 4),
                                                device)
    _, _, test_ds = precision_study._scene(str(tmp_path), 64, 96, 3, 32)

    calls = []
    k3 = tunet.conv3x3_bias_act

    def record(x, kernel, bias=None, act_param=None, *, act_fn="relu", passes=None):
        y = k3(x, kernel, bias, act_param, act_fn=act_fn, passes=passes)
        calls.append((passes, x, kernel, bias, act_fn, y))
        return y

    with mock.patch.object(tunet, "conv3x3_bias_act", record):
        result = precision_study.run_attribution(model, test_ds, test_ds.dsm_std, device)
    layers = precision_study.attribution_layers(2)
    assert result["ranked"] and set(result["solo_cm"]) == set(layers)

    # 3x3 convs a forward: encoder0, encoder1, bottleneck, decoder0 and the
    # composed top's two; the reference and all-DEFAULT runs, then each layer.
    per_forward = 6
    runs = [calls[i:i + per_forward] for i in range(0, len(calls), per_forward)]
    assert len(runs) == 2 + len(layers)
    names = ["encoder0", "encoder1", "bottleneck", "decoder0", "last", "last"]
    assert [c[0] for c in runs[0]] == [3] * per_forward
    assert [c[0] for c in runs[1]] == [1] * per_forward
    for layer, run in zip(layers, runs[2:]):
        assert [c[0] for c in run] == [1 if n == layer else 3 for n in names], layer
    for passes, x, kernel, bias, act_fn, y in calls[:2 * per_forward]:
        (x_hi, x_lo), (w_hi, w_lo) = pass_ops.split(x), pass_ops.split(kernel.detach())
        pairs = [(x_hi, w_hi)] + ([(x_hi, w_lo), (x_lo, w_hi)] if passes == 3 else [])
        ref = sum(torch.nn.functional.conv2d(a.double().permute(0, 3, 1, 2),
                                             b.double().permute(3, 2, 0, 1), padding=1)
                  for a, b in pairs).permute(0, 2, 3, 1)
        if bias is not None:
            ref = ref + bias.detach().double()
        if act_fn == "relu":
            ref = torch.relu(ref)
        err = float((y.double() - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), (passes, tuple(x.shape), err)

    from resdepth_tpu.geo.allocation import entire_area_defn

    work = str(tmp_path)
    entry = {"name": "study", "raster_in": os.path.join(work, "dsm.tif"),
             "image_list": [os.path.join(work, f"ortho_{j}.tif") for j in range(3)],
             "image_pairs": [(0, 1)],
             "area_defn": entire_area_defn(os.path.join(work, "dsm.tif"))}
    jds = JTileDataset(entry, "geom-stereo", 32, "test", dsm_std=test_ds.dsm_std,
                       ortho_mean=test_ds.ortho_mean, ortho_std=test_ds.ortho_std, seed=0)
    np.testing.assert_array_equal(jds.positions, test_ds.positions)
    fcfg, fparams, fstate = junet.fold_serving(_jax_smoke_config(), params, bn)
    spec = dataclasses.replace(jpipe.batch_spec_for(jds), use_bounds=False,
                               has_target=False)
    n = len(test_ds.positions)
    batch = jpipe.build_batch(jpipe.device_put_dataset(jds),
                              jnp.asarray(test_ds.positions.astype(np.int32)),
                              jnp.asarray(test_ds.pair_indices.astype(np.int32)),
                              jnp.zeros((n, 4), jnp.int32), jax.random.PRNGKey(0), spec)
    want, _ = junet.apply_unet(fcfg, fparams, fstate, batch["input"], train=False,
                               precision=jax.lax.Precision.HIGH)
    # the graph on JAX's batch: the two assemble the input in another sum
    # order (1.3e-4 apart here)
    served = serving_model(model, device, torch.float32)
    x = build_batch(device_put_dataset(test_ds, device),
                    torch.from_numpy(test_ds.positions.astype(np.int32)),
                    torch.from_numpy(test_ds.pair_indices.astype(np.int64)),
                    _inference_spec(test_ds))["input"]
    np.testing.assert_allclose(x.numpy(), np.asarray(batch["input"]), rtol=0, atol=1e-3)
    with torch.inference_mode():
        got = tunet.apply_unet(served, torch.from_numpy(np.array(batch["input"])),
                               precision=tunet.Precision.HIGHEST).numpy()
        ours = tunet.apply_unet(served, x, precision=tunet.Precision.HIGHEST).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    assert float(np.abs(result["y_ref"] - ours).max()) <= 1e-3 * float(np.abs(ours).max())



# ------------------------ the state cache's serving studies ----------------- #

def _jax_scene_maes(tmp_path, params, bn, cells, mode):
    """JAX's ``predict_linear_blend`` over the studies' city for each
    (stride, tta) cell: ``{cell: (refined MAE, scene)}``."""
    import jax.numpy as jnp

    from resdepth_tpu.data.dataset import TileDataset as JTileDataset
    from resdepth_tpu.infer.tiled import predict_linear_blend as jpredict

    city = precision_study.make_city(str(tmp_path), CITY, CITY, 3)
    valid = city["gt"] != -9999.0
    dtype = jnp.float32 if mode == "float32" else mode
    out = {}
    for stride, tta in cells:
        jds = JTileDataset(city["entry"], "geom-stereo", 32, "test", stride=stride, seed=0,
                           **city["norm"])
        pred = np.asarray(jpredict(_jax_smoke_config(), params, bn, jds, batch_size=128,
                                   compute_dtype=dtype, tta=tta))
        out[(stride, tta)] = (float(np.abs(pred - city["gt"])[valid].mean()), pred)
    return out


def _city_valid(tmp_path):
    work = tmp_path / "valid"
    work.mkdir()
    return precision_study.make_city(str(work), CITY, CITY, 3)["gt"] != -9999.0


SERVING = ["--device", "cpu", "--tile", "32", "--depth", "2", "--start-kernel", "4",
           "--rows", str(CITY), "--cols", str(CITY)]


def test_stride_study_matches_jax(jax_cache, tmp_path):
    path, params, bn = jax_cache
    got = stride_study.main(["--state-cache", path, *SERVING, "--mode", "float32",
                             "--strides", "16", "24", "32"])
    want = _jax_scene_maes(tmp_path, params, bn, [(16, 1), (24, 1), (32, 1)], "float32")
    assert [c["stride"] for c in got["cells"]] == [16, 24, 32]
    valid = _city_valid(tmp_path)
    for cell in got["cells"]:
        mae, pred = want[(cell["stride"], 1)]
        assert abs(cell["mae_m"] - mae) <= 1e-4, cell
        dev_cm = 100 * float(np.abs(pred - want[(16, 1)][1])[valid].mean())
        assert abs(cell["dev_vs_base_cm"] - dev_cm) <= 1e-3, (cell, dev_cm)
        assert cell["host_s"] > 0 and "device_s" not in cell


def test_tta_study_flagship_mode_matches_jax(jax_cache, tmp_path):
    path, params, bn = jax_cache
    got = tta_study.main(["--state-cache", path, *SERVING, "--mode", "float32"])
    want = _jax_scene_maes(tmp_path, params, bn, [(16, t) for t in tta_study.TTA_COUNTS],
                           "float32")
    valid = _city_valid(tmp_path)
    assert [c["tta"] for c in got["cells"]] == list(tta_study.TTA_COUNTS)
    for cell in got["cells"]:
        mae, pred = want[(16, cell["tta"])]
        assert abs(cell["mae_m"] - mae) <= 1e-4, cell
        dev_cm = 100 * float(np.abs(pred - want[(16, 1)][1])[valid].mean())
        assert abs(cell["dev_vs_1_cm"] - dev_cm) <= 1e-3, (cell, dev_cm)


def test_tta_stride_study_balanced16_matches_jax(jax_cache, tmp_path):
    path, params, bn = jax_cache
    out = str(tmp_path / "grid.json")
    got = tta_stride_study.main(["--state-cache", path, *SERVING, "--strides", "16", "24",
                                 "--ttas", "1", "4", "--json", out])
    cells = [(c["stride"], c["tta"]) for c in got["cells"]]
    assert cells == [(16, 1), (16, 4), (24, 1), (24, 4)] and got["base_cell"] == [16, 1]
    want = _jax_scene_maes(tmp_path, params, bn, cells, "balanced16")
    for cell in got["cells"]:
        assert abs(cell["mae_m"] - want[(cell["stride"], cell["tta"])][0]) <= 1e-5, cell
    with open(out) as f:
        assert json.load(f)["cells"][1]["model_passes"] == 4 * got["cells"][1]["tiles"]


def test_stale_scene_seed_is_refused(jax_cache):
    with pytest.raises(SystemExit, match="scene seed 3, not --scene-seed 4"):
        stride_study.main(["--state-cache", jax_cache[0], *SERVING, "--scene-seed", "4"])


# ------------------------------ the other studies --------------------------- #

def test_bilinear_study_writes_the_jax_keys(tmp_path):
    """The JAX study's result keys; the bilinear model serves unfolded
    (``fold_top_decoder`` is a no-op for it), its ``balanced16`` forward
    hands K3's wrapper encoder0 and the last conv at 3 passes; the cache
    reads back under its key."""
    from unittest import mock

    import torch

    from resdepth_tpu_torch.infer.tiled import serving_model

    cache, out = str(tmp_path / "bilinear.npz"), str(tmp_path / "bilinear.json")
    argv = ["--device", "cpu", "--steps", "2", "--batch", "2", "--rows", "64", "--cols", "96",
            "--dev-rows", "64", "--tile", "32", "--depth", "2", "--start-kernel", "4",
            "--bench-batch", "2", "--iters", "1", "--state-cache", cache, "--json", out]
    got = bilinear_study.main(argv)
    with open(out) as f:
        written = json.load(f)
    jax_keys = {"bilinear_f32_tiles_s", "transpose_f32_tiles_s", "bilinear_balanced16_tiles_s",
                "transpose_balanced16_tiles_s", "bilinear_balanced16_dev_cm",
                "bilinear_bfloat16_dev_cm", "dev_scene_input_mae", "dev_scene_refined_mae_f32"}
    assert set(written) == jax_keys | {"device"} and written == got
    assert np.isfinite([got[k] for k in jax_keys]).all()
    assert jckpt.load_meta(cache)["study_key"] == {**JAX_KEY, "train_precision": "default",
                                                   "up_mode": "bilinear"}
    written_at = os.path.getmtime(cache)
    assert bilinear_study.main(argv)["bilinear_balanced16_dev_cm"] == \
        got["bilinear_balanced16_dev_cm"]
    assert os.path.getmtime(cache) == written_at   # loaded, not trained

    import dataclasses
    config = dataclasses.replace(precision_study.study_config(2, 4), up_mode="bilinear")
    model, _ = precision_study.load_state_cache(cache, config, torch.device("cpu"))
    served = serving_model(model, torch.device("cpu"), "balanced16")
    assert served.top_composed is None and tunet.fold_top_decoder(model) is model
    passes = []
    k3 = tunet.conv3x3_bias_act

    def record(x, kernel, *args, passes=None, **kwargs):
        record.calls.append((kernel.shape[2:], passes))
        return k3(x, kernel, *args, passes=passes, **kwargs)

    record.calls = passes
    with mock.patch.object(tunet, "conv3x3_bias_act", record), torch.inference_mode():
        tunet.apply_unet(served, torch.zeros(1, 32, 32, 3),
                         **tunet.serving_precision("balanced16").apply_kwargs())
    assert passes == [((3, 4), 3), ((4, 1), 3)]


@pytest.fixture(scope="module")
def ema_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ema") / "study")
    convergence_study.main(["gen", "--out", out])
    results = ema_study.main(["--conv-dir", out, "--seeds", "0", "--decay", "0.99",
                              "--epochs", "2", "--samples", "40", "--device", "cpu"])
    return out, results


def test_ema_study_writes_the_jax_keys(ema_run):
    out, results = ema_run
    tag = "seed0_steplr_balanced16_ema99"
    with open(os.path.join(out, "results", f"port_{tag}.json")) as f:
        result = json.load(f)
    assert set(result) == JAX_ARM_KEYS | {"ema_decay"} and result == results[0]
    assert result["ema_decay"] == 0.99 and result["tag"] == tag
    with open(os.path.join(out, "runs_port", tag, "config_train.json")) as f:
        assert json.load(f)["training_settings"]["ema_decay"] == 0.99
    assert np.isfinite([result["refined_test_mae"], result["best_val_mae"]]).all()


def test_tta_study_conv_mode_reserves_a_port_run(ema_run, tmp_path, capsys, monkeypatch):
    """Mode A re-serves the EMA study's run at each tta; the predict CLI
    runs in this process (its child's command line is checked)."""
    import subprocess

    from resdepth_tpu_torch import predict

    def run(cmd, **kwargs):
        assert cmd[1:3] == ["-m", "resdepth_tpu_torch.predict"] and cmd[-2:] == ["--device",
                                                                                 "cpu"]
        predict.main(cmd[3:])
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(tta_study.subprocess, "run", run)
    out, results = ema_run
    tag = results[0]["tag"]
    got = tta_study.main(["--conv-dir", out, "--out", str(tmp_path / "tta"), "--tags", tag,
                          "--device", "cpu"])
    assert set(got["table"][tag]) == set(tta_study.TTA_COUNTS)
    assert abs(got["table"][tag][1] - results[0]["refined_test_mae"]) <= 1e-6
    assert got["torch_refined_maes"] and np.isfinite(list(got["table"][tag].values())).all()
    with open(tmp_path / "tta" / "tta_conv_results.json") as f:
        assert json.load(f)["table"][tag]["8"] == got["table"][tag][8]
    assert "torch reference (mean of 3)" in capsys.readouterr().out


@pytest.mark.parametrize("batch", [20, 32])
def test_train_roofline_traffic_model_equals_jax(batch):
    jax_roofline = _jax_script("train_roofline")
    jconfig = junet.flagship_config("geom-stereo")
    config = tunet.flagship_config("geom-stereo")
    for act_bytes in (2, 4):
        assert train_roofline.traffic_model(config, 256, batch, act_bytes) == \
            jax_roofline.traffic_model(jconfig, 256, batch, act_bytes)
    assert train_roofline.materialized_activations(config, 256) == \
        jax_roofline.materialized_activations(jconfig, 256)
    plan = train_roofline.layer_plan(config, 256, "balanced16")
    assert sum(layer["flops"] for layer in plan) == tunet.analytic_flops(config, 256)
    for mode in train_roofline.MODES:
        r = train_roofline.roofline(config, 256, batch, mode)
        assert r["t_hbm_ms"] == pytest.approx(1e3 * r["total_bytes"] / 3.35e12)
        peak, work = ((67e12, r["flops_per_step"]) if mode == "high"
                      else (989e12, r["tensor_pass_flops_per_step"]))
        assert r["t_ops_ms"] == pytest.approx(1e3 * work / peak)
        assert r["xla_cost_analysis"] is None and r["achievable_samples_per_s"] is None
    balanced16 = train_roofline.roofline(config, 256, batch, "balanced16")
    hifi = sum(layer["flops"] for layer in plan if layer["name"] in ("encoder0", "last"))
    assert balanced16["tensor_pass_flops_per_step"] == \
        3 * batch * (tunet.analytic_flops(config, 256) + 2 * hifi)
    assert train_roofline.PEAK_BF16 == 989e12 and train_roofline.HBM_BW == 3.35e12


def test_train_throughput_study_runs_a_cell():
    rows = train_throughput_study.main(["--device", "cpu", "--modes", "balanced16",
                                        "--batches", "2", "-K", "2", "--windows", "1",
                                        "--tile", "32", "--depth", "2",
                                        "--start-kernel", "4"])
    assert len(rows) == 1 and rows[0]["clock"] == "host" and rows[0]["samples_per_sec"] > 0
    assert "compile_s" not in rows[0]


def test_config_smoke_runs_two_cases(tmp_path):
    # in process: the CLIs' mains (the child runner adds a torch import a CLI)
    result = config_smoke.run_cases(0, 2, str(tmp_path / "smoke"), "cpu",
                                    run=config_smoke.run_in_process)
    assert result["fails"] == 0 and [c["ok"] for c in result["cases"]] == [True, True]
    first = result["cases"][0]["train"]
    assert first["model"]["start_kernel"] == 4 and first["model"]["max_filter_depth"] == 8
    assert first["training_settings"]["tile_size"] in (16, 32)
