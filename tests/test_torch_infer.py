"""The port's whole slice on the CPU: full-scene refinement against JAX,
the inference CLI against the committed goldens, and the import boundary.

* ``predict_linear_blend(device="cpu")`` against the JAX
  ``predict_linear_blend(use_pallas=False)`` (its own plain reference) on
  the same weights: tta in {1, 2, 4, 8} x {mean, median}, strides T/2 and
  3T/4, within ``SCENE_ULPS`` f32 ulps of the largest height.
* ``python -m resdepth_tpu_torch.predict cfg --device cpu`` serving the
  ``Model_best.npz`` that the JAX ``train.py`` writes on the golden scene
  matches ``tests/goldens/``: ``SCENE_ULPS`` f32 ulps of the largest height
  on the refined DSM (``test_demo_goldens.py`` holds JAX to 1e-4 m), 5e-3
  on the statistics.
* With ``jax``, ``jaxlib`` and the JAX package blocked from importing, the
  port's CLIs and ``chip_smoke.py``'s helpers import, refine a small scene
  and train on another.
"""

import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import chip_smoke
from resdepth_tpu.data.dataset import TileDataset as JTileDataset
from resdepth_tpu.geo.raster import open_raster
from resdepth_tpu.infer import tiled as jtiled
from resdepth_tpu.models import unet as junet
from resdepth_tpu_torch import predict
from resdepth_tpu_torch.data.dataset import TileDataset
from resdepth_tpu_torch.infer import tiled as ttiled
from resdepth_tpu_torch.models import unet as tunet
from resdepth_tpu_torch.models import weights
from test_torch_unet import _jax_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
TILE = 16
# The scene bars in f32 ulps of the reference's largest height
# (``chip_smoke.ulps``): the gaps measured 1-2 ulps on every scene here
# (heights 422-452 m, an ulp 3.05e-5 m), so 3 keeps an ulp of margin; in
# metres that is 9.2e-5 m here, and it scales with the scene's heights.
SCENE_ULPS = 3

# Installed first in a child interpreter: any import of JAX or of the JAX
# package fails loudly.
BLOCK_JAX = textwrap.dedent("""
    import sys

    class _BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "resdepth_tpu"):
                raise ImportError(f"{name}: the port must not import JAX")
            return None

    sys.meta_path.insert(0, _BlockJax())
""")


def _scene_datasets(make_geotiff, stride):
    """The port's and the JAX package's TileDataset over the same files."""
    rows, cols = 48, 64
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float32)
    dsm = (410.0 + 6.0 * np.sin(yy / 7.0) + 5.0 * np.cos(xx / 9.0)
           + rng.normal(0.0, 0.8, (rows, cols))).astype(np.float32)
    images = rng.normal(120.0, 25.0, (2, rows, cols)).astype(np.float32)
    entry = {"raster_in": make_geotiff("dsm.tif", dsm),
             "image_list": [make_geotiff(f"img{j}.tif", images[j]) for j in range(2)],
             "image_pairs": [(0, 1)],
             # off-grid region: edge-shifted tiles and clipped ramps
             "area_defn": {"x_extent": [(3, 60)], "y_extent": [(1, 46)]}}
    return [cls(entry, input_channels="geom-stereo", tile_size=TILE,
                sampling_strategy="test", stride=stride, dsm_std=5.0,
                ortho_mean=None, ortho_std=25.0)
            for cls in (TileDataset, JTileDataset)]


def _small_scene_models():
    """The JAX UNet's config and seeded weights, and the port's UNet
    holding the same weights."""
    settings = dict(n_input_channels=3, start_kernel=4, max_filter_depth=8, depth=2)
    jconfig = junet.UNetConfig(**settings)
    params, state = _jax_weights(jconfig, seed=5)
    model = tunet.UNet(tunet.UNetConfig(**settings))
    model.load_state_dict(weights.state_dict_from_jax_params(params, state, model.config))
    return jconfig, params, state, model


@pytest.mark.parametrize("stride", [TILE // 2, 3 * TILE // 4], ids=["T/2", "3T/4"])
@pytest.mark.parametrize("tta_merge", ["mean", "median"])
@pytest.mark.parametrize("tta", [1, 2, 4, 8])
def test_scene_matches_jax(make_geotiff, tta, tta_merge, stride):
    ds, jds = _scene_datasets(make_geotiff, stride)
    jconfig, params, state, model = _small_scene_models()

    want = jtiled.predict_linear_blend(jconfig, params, state, jds, batch_size=5,
                                       use_pallas=False, tta=tta,
                                       tta_merge=tta_merge)
    got = ttiled.predict_linear_blend(model, ds, device="cpu", batch_size=5,
                                      tta=tta, tta_merge=tta_merge)
    assert got.shape == ds.dsm_input.shape and got.dtype == np.float32
    assert np.abs(got[1:47, 3:61]).min() > 350.0      # every region pixel stitched
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=chip_smoke.ulps(np.asarray(want), SCENE_ULPS))


@pytest.mark.parametrize("batch_size", [6, 8])
def test_padding_at_the_last_tile_keeps_the_scene(make_geotiff, monkeypatch,
                                                  batch_size):
    """The last batch's zero-weight padding sits on its real tiles; the
    scene is bitwise the one that padding at (0, 0), as the JAX package
    pads, gives, and within 2 ulps of the JAX scene (35 tiles: 1 and 5
    padding tiles)."""
    ds, jds = _scene_datasets(make_geotiff, TILE // 2)
    assert len(ds.positions) % batch_size
    jconfig, params, state, model = _small_scene_models()
    got = ttiled.predict_linear_blend(model, ds, device="cpu", batch_size=batch_size)
    with monkeypatch.context() as patch:
        patch.setattr(ttiled, "_pad_positions",
                      lambda positions, n, _: ttiled._pad_round_up(positions, n))
        at_origin = ttiled.predict_linear_blend(model, ds, device="cpu",
                                                batch_size=batch_size)
    np.testing.assert_array_equal(got, at_origin)
    want = np.asarray(jtiled.predict_linear_blend(jconfig, params, state, jds,
                                                  batch_size=batch_size,
                                                  use_pallas=False))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * float(np.spacing(np.abs(want).max())))


def test_last_batch_box_is_the_real_tiles(make_geotiff, monkeypatch):
    """Every batch's stitch gets the box of its real tiles (the box K2
    launches over), the padded last batch included, whose padding tiles
    take its real tiles' origins in turn."""
    ds, _ = _scene_datasets(make_geotiff, TILE // 2)
    _, _, _, model = _small_scene_models()
    calls = []
    stitch_tiles = ttiled.stitch.stitch_tiles

    def record(canvas, tiles, positions, wy, wx, means, sigma, **kwargs):
        calls.append((positions.numpy().copy(), kwargs["bounds"]))
        return stitch_tiles(canvas, tiles, positions, wy, wx, means, sigma, **kwargs)

    monkeypatch.setattr(ttiled.stitch, "stitch_tiles", record)
    batch_size = 8
    ttiled.predict_linear_blend(model, ds, device="cpu", batch_size=batch_size)
    n = len(ds.positions)
    assert len(calls) == -(-n // batch_size)
    for index, (positions, bounds) in enumerate(calls):
        real = ds.positions[index * batch_size:(index + 1) * batch_size]
        assert bounds == (real[:, 0].min(), real[:, 1].min(),
                          real[:, 0].max() + TILE, real[:, 1].max() + TILE)
        np.testing.assert_array_equal(
            positions[len(real):], np.resize(real, (batch_size - len(real), 2)))
    assert len(calls[-1][0]) - len(real) == -n % batch_size > 0


def test_chip_smoke_pads_as_the_main_path():
    """chip_smoke's scene batches carry the main path's padding and box."""
    batches = chip_smoke.grid_batches(101, 99, tile=16, batch=7)
    last = batches[-1]
    positions = np.concatenate([b["positions"].numpy() for b in batches])
    n = len(positions) - last["n_pad"]
    np.testing.assert_array_equal(
        positions, ttiled._pad_positions(positions[:n], len(positions), 7))
    real = last["positions"].numpy()[:7 - last["n_pad"]]
    assert last["bounds"] == ttiled.stitch.batch_bounds(real, 16)
    assert chip_smoke.repadded(last, "origin")["bounds"][:2] == (0, 0)
    on_one = chip_smoke.repadded(last, "last_tile")
    assert on_one["bounds"] == last["bounds"]
    assert (on_one["positions"][len(real):] == torch.from_numpy(real[-1])).all()


RUN_CLI = ("import runpy; "
           "runpy.run_module('resdepth_tpu_torch.predict', run_name='__main__')")


@pytest.mark.skipif(not os.path.exists(os.path.join(GOLDEN_DIR,
                                                    "demo_refined_dsm.tif")),
                    reason="goldens not generated")
def test_cli_serves_jax_checkpoint_to_goldens(tmp_path):
    """The golden pipeline's steps (scripts/make_demo_goldens.py) with the
    port's CLI in place of test.py, run in an interpreter that cannot
    import JAX."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_demo_data import fill_golden_test_config, write_golden_scene
    from make_demo_goldens import hermetic_env
    from test_demo_goldens import _stat_numbers

    cfgs = write_golden_scene(str(tmp_path))
    env = hermetic_env()
    subprocess.run([sys.executable, os.path.join(REPO, "train.py"), cfgs["train"]],
                   env=env, check=True, stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL)
    run_dir = max(glob.glob(os.path.join(cfgs["out"], "runs", "*")),
                  key=os.path.getmtime)
    fill_golden_test_config(cfgs["test"], run_dir)
    result = subprocess.run(
        [sys.executable, "-c", BLOCK_JAX + RUN_CLI, cfgs["test"], "--device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True)
    assert result.returncode == 0, result.stdout[-4000:] + result.stderr[-4000:]

    pair_dir = os.path.join(cfgs["out"], "eval", "golden_city", "Stereopair_0_1")
    got = open_raster(os.path.join(pair_dir, "initial_DSM_prediction_test_area.tif"))
    want = open_raster(os.path.join(GOLDEN_DIR, "demo_refined_dsm.tif"))
    np.testing.assert_allclose(got.band(1), want.band(1), rtol=0,
                               atol=chip_smoke.ulps(want.band(1), SCENE_ULPS))
    assert got.geotransform == want.geotransform
    assert got.nodata == want.nodata
    with open(os.path.join(pair_dir,
                           "initial_DSM_prediction_test_area_statistics.txt")) as f:
        got_stats = _stat_numbers(f.read())
    with open(os.path.join(GOLDEN_DIR, "demo_statistics.txt")) as f:
        want_stats = _stat_numbers(f.read())
    np.testing.assert_allclose(got_stats, want_stats, rtol=0, atol=5e-3)


def _small_artifacts(work, size=64):
    """chip_smoke's seeded scene and artifacts at a CPU-test size."""
    scene = chip_smoke.write_scene(os.path.join(work, "scene"), size, size)
    config = tunet.UNetConfig(n_input_channels=3, start_kernel=4,
                              max_filter_depth=8, depth=2)
    model = chip_smoke.write_model_artifacts(
        os.path.join(work, "model"), config, "geom-stereo",
        scene["image_mean"], scene["image_std"])
    return scene, config, model


def test_port_runs_without_jax(tmp_path):
    """A child interpreter that cannot import JAX imports the CLI modules and
    chip_smoke.py, refines a small scene on the CPU and trains on another
    through the train CLI."""
    script = BLOCK_JAX + textwrap.dedent(f"""
        import os
        sys.path.insert(0, {REPO!r})
        import numpy as np
        import chip_smoke
        from resdepth_tpu_torch import predict  # noqa: F401
        from resdepth_tpu_torch import train
        from resdepth_tpu_torch.infer.tiled import predict_linear_blend
        from resdepth_tpu_torch.models.unet import UNetConfig

        scene = chip_smoke.write_scene({str(tmp_path)!r}, 48, 48)
        ds = chip_smoke._tile_dataset(scene["paths"], 48, scene["image_mean"],
                                      scene["image_std"], tile=16)
        config = UNetConfig(n_input_channels=3, start_kernel=4,
                            max_filter_depth=8, depth=2)
        model = chip_smoke.random_model(config)
        out = predict_linear_blend(model, ds, device="cpu", batch_size=4)
        assert out.shape == (48, 48) and np.isfinite(out).all()

        work = os.path.join({str(tmp_path)!r}, "train")
        scene = chip_smoke.write_scene(os.path.join(work, "scene"), 96, 96)
        cfg = chip_smoke.write_train_config(
            os.path.join(work, "cfg.json"), scene["paths"], os.path.join(work, "runs"),
            n_samples=8, suffix="nojax",
            model=dict(depth=2, start_kernel=4, max_filter_depth=8),
            training=dict(tile_size=16, batch_size=4, n_epochs=1),
            scheduler=dict(enabled=False))
        trainer = train.main([cfg, "--device", "cpu"])
        run = chip_smoke.run_dir_of(os.path.join(work, "runs"), "nojax")
        assert os.path.exists(os.path.join(run, "checkpoints", "Model_last.npz"))
        assert np.isfinite(trainer.val_history[0][1])
        assert not any(name.split(".")[0] in ("jax", "jaxlib", "resdepth_tpu")
                       for name in sys.modules)
        print("ok", float(np.abs(out - ds.dsm_input).mean()))
    """)
    result = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                            capture_output=True, text=True)
    assert result.returncode == 0, result.stderr[-4000:]
    assert result.stdout.rstrip().splitlines()[-1].startswith("ok")


def test_cli_preset_matches_library_call(tmp_path):
    """The CLI on the CPU (chip_smoke's scene at 64 px, serving_preset
    'accuracy': stride 3T/4 and TTA-4) writes the scene that
    ``predict_linear_blend`` computes for the same settings."""
    scene, config, model = _small_artifacts(str(tmp_path))
    out_dir = str(tmp_path / "eval")
    cfg = chip_smoke.write_config(str(tmp_path / "cfg.json"), scene["paths"], model,
                                  out_dir, tile_size=TILE, batch_size=4,
                                  serving_preset="accuracy")
    chip_smoke.run_cli(cfg, "cpu")
    paths = chip_smoke.output_paths(out_dir)
    assert os.path.exists(paths["statistics"])
    got = open_raster(paths["prediction"]).band(1)

    ds = chip_smoke._tile_dataset(scene["paths"], 64, scene["image_mean"],
                                  scene["image_std"], tile=TILE,
                                  stride=3 * TILE // 4)
    net = tunet.UNet(config)
    net.load_state_dict(weights.load_state_dict(model["weights"], config))
    want = ttiled.predict_linear_blend(net, ds, device="cpu", batch_size=4, tta=4)
    np.testing.assert_array_equal(got, want)


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """Above ``MAX_DEVICE_PIXELS`` (lowered to 64 x 64 px: 7 row bands of the
    64^2 scene's 3 raster planes) the CLI streams row bands and writes the
    resident run's raster, bitwise."""
    scene, _, model = _small_artifacts(str(tmp_path))
    rasters = {}
    for name, budget in (("resident", predict.MAX_DEVICE_PIXELS), ("streamed", 64 * 64)):
        out_dir = str(tmp_path / name)
        cfg = chip_smoke.write_config(str(tmp_path / f"{name}.json"), scene["paths"],
                                      model, out_dir, tile_size=TILE)
        monkeypatch.setattr(predict, "MAX_DEVICE_PIXELS", budget)
        predict.main([cfg, "--device", "cpu"])
        with open(os.path.join(out_dir, "run.log")) as f:
            assert ("streaming row bands" in f.read()) == (name == "streamed")
        rasters[name] = open_raster(chip_smoke.output_paths(out_dir)["prediction"]).band(1)
    assert np.isfinite(rasters["streamed"]).all()
    np.testing.assert_array_equal(rasters["streamed"], rasters["resident"])

    assert predict.select_compute_dtype("bfloat16", torch.device("cpu")) is torch.bfloat16
    assert predict.select_compute_dtype(None, torch.device("cpu")) is torch.float32


def test_cuda_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.resolve_device("cuda")
    assert predict.resolve_device("cpu") == torch.device("cpu")
    # more than one GPU: this process's card, the one its rank bound
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert predict.resolve_device("cuda") == torch.device("cuda", 1)
