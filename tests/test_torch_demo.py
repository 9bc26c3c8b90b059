"""The port's demo flow on the CPU, beside the JAX package's scripts.

* ``resdepth_tpu_torch/make_demo_data.py`` writes the demo scene's and the
  golden scene's GeoTIFFs and lists byte for byte as
  ``scripts/make_demo_data.py`` does, and the same JSON configs up to the
  directory they name.
* ``resdepth_tpu_torch/make_demo_goldens.py --out`` runs the golden
  pipeline through the port's CLIs. Its statistics report's initial-DSM
  numbers equal the JAX package's committed report (``tests/goldens/``,
  within its 5e-3 print rounding) and its refined-DSM overall MAE, RMSE
  and NMAD sit within 0.25 m of them: the golden config trains 4 epochs with
  augmentation, whose random streams differ between the packages (the
  port measured 0.145 m on the MAE, 0.188 on the RMSE and 0.115 on the
  NMAD), so the refined DSM cannot match to 1e-4 m. ``tests/goldens/`` is
  unchanged by the run.
* ``resdepth_tpu_torch/run_demo.sh`` parses, and drives the port's CLIs
  (on the card unless ``--cpu``).
"""

import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np

from resdepth_tpu_torch import make_demo_data, make_demo_goldens

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")


def _jax_make_demo_data():
    path = os.path.join(REPO, "scripts", "make_demo_data.py")
    spec = importlib.util.spec_from_file_location("jax_make_demo_data", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _same_tree(jax_dir, port_dir):
    """Every file of the two directories: GeoTIFFs and lists bytewise, the
    JSON configs and lists up to the directory name."""
    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(port_dir))
    for name in names:
        with open(os.path.join(jax_dir, name), "rb") as f, \
                open(os.path.join(port_dir, name), "rb") as g:
            want, got = f.read(), g.read()
        if name.endswith(".tif"):
            assert want == got, name
        else:
            assert want.replace(jax_dir.encode(), port_dir.encode()) == got, name
    return names


def test_demo_scene_matches_the_jax_script(tmp_path):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    module = _jax_make_demo_data()
    argv = sys.argv
    try:
        sys.argv = ["make_demo_data.py", jax_dir]
        module.main()
    finally:
        sys.argv = argv
    make_demo_data.main([port_dir])
    names = _same_tree(jax_dir, port_dir)
    assert {"config_train.json", "config_test.json", "ortho_45.tif",
            "pairlist_stereo.txt"} <= set(names)
    with open(os.path.join(port_dir, "config_test.json")) as f:
        assert json.load(f)["general"]["compute_dtype"] == "balanced16"


def test_golden_scene_matches_the_jax_script(tmp_path):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = _jax_make_demo_data().write_golden_scene(jax_dir)
    got = make_demo_data.write_golden_scene(port_dir)
    assert set(got) == set(want)
    _same_tree(jax_dir, port_dir)
    run_dir = os.path.join(port_dir, "runs", "x")
    make_demo_data.fill_golden_test_config(got["test"], run_dir)
    _jax_make_demo_data().fill_golden_test_config(want["test"], run_dir)
    with open(got["test"]) as f, open(want["test"]) as g:
        assert json.load(f)["model"] == json.load(g)["model"]


def _stat_numbers(text: str, section: str) -> list:
    """The numbers of one section of a statistics report."""
    block = text.split(section)[1].split("STATISTICS")[0]
    return [float(v) for v in re.findall(r"-?\d+\.\d+", block)]


def _digest(directory):
    return {name: hashlib.sha256(open(os.path.join(directory, name), "rb").read()).hexdigest()
            for name in sorted(os.listdir(directory))}


def test_golden_pipeline_on_the_port(tmp_path):
    before = _digest(GOLDEN_DIR)
    out = str(tmp_path / "out")
    written = make_demo_goldens.main(["--out", out, "--device", "cpu"])
    assert _digest(GOLDEN_DIR) == before
    with open(written["statistics"]) as f:
        got = f.read()
    with open(os.path.join(GOLDEN_DIR, "demo_statistics.txt")) as f:
        want = f.read()
    for section in ("OVERALL: INITIAL DSM", "BUILDING PIXELS: INITIAL DSM",
                    "TERRAIN PIXELS: INITIAL DSM"):
        np.testing.assert_allclose(_stat_numbers(got, section),
                                   _stat_numbers(want, section), rtol=0, atol=5e-3)
    # MAE, RMSE and NMAD of the refined DSM (the extremes and the median of
    # the residuals swing by a metre between two trainings of 4 epochs)
    refined = [np.take(_stat_numbers(text, "OVERALL: REFINED DSM"), [2, 3, 6])
               for text in (got, want)]
    np.testing.assert_allclose(*refined, rtol=0, atol=0.25)
    from resdepth_tpu_torch.geo.raster import open_raster

    pred, golden = (open_raster(written["prediction"]),
                    open_raster(os.path.join(GOLDEN_DIR, "demo_refined_dsm.tif")))
    assert pred.geotransform == golden.geotransform and pred.nodata == golden.nodata
    assert pred.band(1).shape == golden.band(1).shape
    assert np.isfinite(pred.band(1)).all()


def test_run_demo_script_drives_the_port():
    script = os.path.join(REPO, "resdepth_tpu_torch", "run_demo.sh")
    subprocess.run(["bash", "-n", script], check=True)
    with open(script) as f:
        text = f.read()
    for command in ("python -m resdepth_tpu_torch.make_demo_data",
                    "python -m resdepth_tpu_torch.train",
                    "python -m resdepth_tpu_torch.predict"):
        assert command in text
    assert '--cpu) DEVICE="cpu"' in text and 'DEVICE="cuda"' in text
    assert "train.py" not in text and "test.py" not in text
