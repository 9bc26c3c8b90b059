"""The port's CLIs in worlds of 2 processes over gloo on the CPU.

* ``python -m resdepth_tpu_torch.train`` under ``RESDEPTH_DIST_*`` for 2
  epochs (batch 4, 2 a rank, augmentation off): only the chief writes the
  run directory, whose files are the 1-process run's; per-epoch val MAE
  rtol 2e-4 and the final weights and BatchNorm statistics rtol 1e-3, atol
  2e-5 of the 1-process run (``tests/test_train.py``'s mesh bars). The
  1-process run has ``RESDEPTH_DISTRIBUTED=" Off "``, a falsy spelling.
* ``python -m resdepth_tpu_torch.predict`` serving that run's
  ``Model_best.npz``: under ``RESDEPTH_DIST_*`` (tiles shared over the
  ranks), in the over-budget branch (``MAX_DEVICE_PIXELS`` lowered: row
  bands shared over the ranks, ``predict_linear_blend_scene_sharded``) and
  as a plain launch hands it to one process per GPU
  (``parallel.bootstrap.launch_per_gpu``, here with ``--device cpu``): one
  set of GeoTIFFs each, within 1e-4 m of the 1-process run's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from resdepth_tpu_torch import predict
from resdepth_tpu_torch.geo.raster import open_raster
from resdepth_tpu_torch.train import checkpoint as tckpt
from resdepth_tpu_torch.train import cli
from resdepth_tpu_torch.models import weights
from test_torch_parallel import WORLD_TIMEOUT, run_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(depth=2, start_kernel=4, max_filter_depth=8)
LOW_BUDGET = 32 * 96 * 3          # 32-row windows of the 96^2 scene's 3 planes


def _train_config(work, scene, root):
    return chip_smoke.write_train_config(
        os.path.join(work, f"{os.path.basename(root)}.json"), scene["paths"], root,
        n_samples=24, suffix="dp", model=MODEL,
        training={"tile_size": 16, "batch_size": 4, "n_epochs": 2, "augment": False},
        stereopair_settings={"use_all_stereo_pairs": True,
                             "permute_images_within_pair": False},
        optimizer={"name": "Adam", "learning_rate": 1e-3},
        scheduler={"enabled": True, "name": "StepLR",
                   "settings": {"step_size": 1, "gamma": 0.5}},
        general={"save_model_rate": 2, "evaluate_rate": 1, "random_seed": 0},
        tpu={"data_parallel": True})


def _listing(run_dir):
    return sorted(os.path.relpath(os.path.join(d, f), run_dir)
                  for d, _, files in os.walk(run_dir) for f in files
                  if not f.startswith("events."))


def _val_maes(run_dir):
    import json

    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return [(r["step"], r["value"]) for r in lines if r.get("tag") == "val/MAE_metric"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The train CLI in one process and in a world of 2."""
    work = str(tmp_path_factory.mktemp("dp_cli"))
    scene = chip_smoke.write_scene(os.path.join(work, "scene"), 96, 96)
    roots = {name: os.path.join(work, name) for name in ("one", "world")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RESDEPTH_DISTRIBUTED", " Off ")
        trainer = cli.main([_train_config(work, scene, roots["one"]), "--device", "cpu"])
    outputs = run_world([sys.executable, "-m", "resdepth_tpu_torch.train",
                         _train_config(work, scene, roots["world"]), "--device", "cpu"],
                        cwd=REPO)
    return {"work": work, "scene": scene, "roots": roots, "trainer": trainer,
            "outputs": outputs}


def test_train_cli_world_of_two_matches_one_process(runs):
    roots = runs["roots"]
    assert len(os.listdir(roots["world"])) == 1       # one run directory, the chief's
    one = chip_smoke.run_dir_of(roots["one"], "dp")
    world = chip_smoke.run_dir_of(roots["world"], "dp")
    assert _listing(world) == _listing(one)
    assert "checkpoints/Model_best.npz" in _listing(world)
    want, got = _val_maes(one), _val_maes(world)
    assert [e for e, _ in got] == [e for e, _ in want] == [0, 1]
    assert runs["trainer"].val_history == want
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=2e-4)
    with open(os.path.join(world, "run.log")) as f:
        log = f.read()
    assert "Data-parallel mesh: {'data': 2}" in log
    with open(os.path.join(one, "run.log")) as f:
        assert "Data-parallel mesh: {'data': 1}" in f.read()
    last = {name: tckpt.load_checkpoint(os.path.join(run, "checkpoints", "Model_last.npz"))
            for name, run in (("one", one), ("world", world))}
    assert last["world"]["meta"]["epoch"] == last["one"]["meta"]["epoch"] == 1
    assert last["world"]["adam"][2] == last["one"]["adam"][2] == 12
    for tree in ("params", "bn_state"):
        got_leaves = weights.flatten_keystr(last["world"][tree])
        want_leaves = weights.flatten_keystr(last["one"][tree])
        assert got_leaves.keys() == want_leaves.keys()
        for key in want_leaves:
            np.testing.assert_allclose(got_leaves[key], want_leaves[key], rtol=1e-3,
                                       atol=2e-5, err_msg=key)
    # rank 1 printed no training lines: it logs warnings and errors alone
    chief, other = ("".join(output) for output in runs["outputs"])
    assert "MAE_metric" in chief and "MAE_metric" not in other


def _serve(runs, name, argv_of):
    """Serve the 1-process run's Model_best.npz into ``work/name``; returns
    the prediction raster."""
    work = runs["work"]
    model = chip_smoke.serving_model_artifacts(chip_smoke.run_dir_of(runs["roots"]["one"],
                                                                     "dp"))
    out_dir = os.path.join(work, name)
    config = chip_smoke.write_config(os.path.join(work, f"{name}.json"),
                                     runs["scene"]["paths"], model, out_dir,
                                     tile_size=16, batch_size=8)
    argv_of(config)
    assert sorted(os.listdir(out_dir)) == ["run.log", "smoke_city"]
    return out_dir, open_raster(chip_smoke.output_paths(out_dir)["prediction"]).band(1)


def _in_world(config, budget=None):
    code = ("import sys; from resdepth_tpu_torch import predict; "
            + (f"predict.MAX_DEVICE_PIXELS = {budget}; " if budget else "")
            + "predict.main(sys.argv[1:])")
    return run_world([sys.executable, "-c", code, config, "--device", "cpu"], cwd=REPO)


@pytest.fixture(scope="module")
def one_process_scene(runs):
    return _serve(runs, "serve_one", lambda cfg: predict.main([cfg, "--device", "cpu"]))


@pytest.mark.parametrize("route", ["tile-sharded", "scene-sharded", "plain-launch"])
def test_predict_cli_world_of_two_matches_one_process(runs, one_process_scene, route):
    one_dir, want = one_process_scene
    if route == "plain-launch":
        def argv_of(config):
            code = ("import sys; from resdepth_tpu_torch.parallel import bootstrap; "
                    "bootstrap.launch_per_gpu('resdepth_tpu_torch.predict', "
                    "sys.argv[1:], 2)")
            env = {**os.environ, "OMP_NUM_THREADS": "2"}
            env.pop("RESDEPTH_DISTRIBUTED", None)
            result = subprocess.run([sys.executable, "-c", code, config, "--device", "cpu"],
                                    cwd=REPO, env=env, capture_output=True, text=True,
                                    timeout=WORLD_TIMEOUT)
            assert result.returncode == 0, result.stderr[-5000:]
    else:
        def argv_of(config):
            _in_world(config, LOW_BUDGET if route == "scene-sharded" else None)
    out_dir, got = _serve(runs, f"serve_{route}", argv_of)
    assert got.shape == (96, 96) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    with open(os.path.join(out_dir, "run.log")) as f:
        log = f.read()
    assert "Inference mesh: {'data': 2}" in log
    assert ("sharding row bands over 2 processes" in log) == (route == "scene-sharded")
    assert sorted(os.listdir(os.path.join(out_dir, "smoke_city", "Stereopair_0_1"))) == \
        sorted(os.listdir(os.path.join(one_dir, "smoke_city", "Stereopair_0_1")))
