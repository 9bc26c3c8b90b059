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
from resdepth_tpu_torch.studies import channel_modes_study, convergence_study

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
