"""The port's own host layer against the JAX package's, on the CPU.

The port keeps copies of the JAX package's framework-free modules (config
validators, GeoTIFF codec, grids and allocation, ``TileDataset``,
normalization, blend weights, LR schedulers, evaluation, orchestration,
logging and fs helpers) so that it imports nothing of ``resdepth_tpu``.

* An import guard: an AST scan of every ``.py`` under
  ``resdepth_tpu_torch/`` and of ``chip_smoke.py`` finds no import of
  ``jax``, ``jaxlib`` or ``resdepth_tpu``.
* Side by side on the same inputs, each copy gives what its original
  gives: the validators on every ``configs/*.json`` (merged configs and the
  allocation and dataset configuration built from them, and the rejection
  of an unknown key), GeoTIFFs written by one package and read by the
  other bit for bit (none, deflate, lzw; native and pure-Python codec),
  grids, allocation, blend weights, evaluation statistics, LR sequences,
  ``TileDataset`` tiles and the normalization pickles. Everything here is
  exact: the copies run the same numpy code, but for the statistics, which
  the port takes by exact selection and holds bitwise to the masked sorts.
"""

import ast
import copy
import json
import os
import pickle
import sys

import numpy as np
import pytest

from resdepth_tpu import orchestration as j_orch
from resdepth_tpu.config import io as j_io
from resdepth_tpu.config import validate_infer as j_vinfer
from resdepth_tpu.config import validate_train as j_vtrain
from resdepth_tpu.config.defaults import default_cfg as j_default_cfg
from resdepth_tpu.data import control_files as j_control
from resdepth_tpu.data import normalization as j_norm
from resdepth_tpu.data.dataset import TileDataset as JTileDataset
from resdepth_tpu.evaluation import evaluate_performance as j_evaluate
from resdepth_tpu.evaluation import get_statistics as j_stats
from resdepth_tpu.geo import _native as j_native
from resdepth_tpu.geo import allocation as j_alloc
from resdepth_tpu.geo import grid as j_grid
from resdepth_tpu.geo import raster as j_raster
from resdepth_tpu.geo import tiff as j_tiff
from resdepth_tpu.ops import blend as j_blend
from resdepth_tpu.train.schedulers import build_scheduler as j_build_scheduler
from resdepth_tpu_torch import orchestration as t_orch
from resdepth_tpu_torch.config import io as t_io
from resdepth_tpu_torch.config import validate_infer as t_vinfer
from resdepth_tpu_torch.config import validate_train as t_vtrain
from resdepth_tpu_torch.config.defaults import default_cfg as t_default_cfg
from resdepth_tpu_torch.data import control_files as t_control
from resdepth_tpu_torch.data import normalization as t_norm
from resdepth_tpu_torch.data.dataset import TileDataset
from resdepth_tpu_torch.evaluation import evaluate_performance as t_evaluate
from resdepth_tpu_torch.evaluation import get_statistics as t_stats
from resdepth_tpu_torch.geo import _native as t_native
from resdepth_tpu_torch.geo import allocation as t_alloc
from resdepth_tpu_torch.geo import grid as t_grid
from resdepth_tpu_torch.geo import raster as t_raster
from resdepth_tpu_torch.geo import tiff as t_tiff
from resdepth_tpu_torch.ops import blend as t_blend
from resdepth_tpu_torch.ops.build import BUILD_DIR
from resdepth_tpu_torch.train.schedulers import build_scheduler as t_build_scheduler
from resdepth_tpu_torch.utils import synth
from test_config_templates import _downsize, _scene
from test_end_to_end import _write_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATES = sorted(f for f in os.listdir(os.path.join(REPO, "configs"))
                   if f.endswith(".json"))
PORT_FILES = sorted(
    [os.path.relpath(os.path.join(root, f), REPO)
     for root, _, files in os.walk(os.path.join(REPO, "resdepth_tpu_torch"))
     for f in files if f.endswith(".py")] + ["chip_smoke.py"])
FORBIDDEN = ("jax", "jaxlib", "resdepth_tpu")


def _plain(tree):
    """AttrDicts, tuples and numpy scalars as plain JSON values."""
    return json.loads(json.dumps(tree, default=float))


# ------------------------------ import guard -------------------------------- #

@pytest.mark.parametrize("path", PORT_FILES)
def test_port_imports_no_jax(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        found += [f"line {node.lineno}: {n}" for n in names
                  if n.split(".")[0] in FORBIDDEN]
    assert not found, f"{path} imports JAX or the JAX package: {found}"


def test_import_guard_sees_every_port_module():
    """The guard's file list holds the host-layer copies and the kernels'
    wrappers, so a new module cannot slip past it."""
    for path in ("chip_smoke.py", "resdepth_tpu_torch/geo/tiff.py",
                 "resdepth_tpu_torch/config/validate_train.py",
                 "resdepth_tpu_torch/data/dataset.py", "resdepth_tpu_torch/ops/conv.py",
                 "resdepth_tpu_torch/utils/synth.py", "resdepth_tpu_torch/utils/profiler.py",
                 "resdepth_tpu_torch/export_torch.py",
                 "resdepth_tpu_torch/studies/convergence_study.py",
                 "resdepth_tpu_torch/studies/channel_modes_study.py",
                 "resdepth_tpu_torch/studies/stride_study.py",
                 "resdepth_tpu_torch/studies/tta_study.py",
                 "resdepth_tpu_torch/studies/tta_stride_study.py",
                 "resdepth_tpu_torch/studies/bilinear_study.py",
                 "resdepth_tpu_torch/studies/ema_study.py",
                 "resdepth_tpu_torch/studies/train_throughput_study.py",
                 "resdepth_tpu_torch/studies/train_roofline.py",
                 "resdepth_tpu_torch/studies/config_smoke.py",
                 "resdepth_tpu_torch/make_demo_data.py",
                 "resdepth_tpu_torch/make_demo_goldens.py",
                 "resdepth_tpu_torch/graft_entry.py",
                 "resdepth_tpu_torch/data/pipeline.py",
                 "resdepth_tpu_torch/train/trainer.py",
                 "resdepth_tpu_torch/studies/golden_spread.py",
                 "resdepth_tpu_torch/studies/narrow_ablation.py"):
        assert path in PORT_FILES


# ------------------------------- validators --------------------------------- #

def _template(name, make_geotiff, tmp_path):
    """A shipped template with its placeholder paths on a synthetic scene
    and its sizes cut, as ``test_config_templates.py`` prepares it."""
    cfg = json.load(open(os.path.join(REPO, "configs", name)))
    scenes = [_scene(make_geotiff, tmp_path, f"ds{i}")
              for i in range(len(cfg["datasets"]))]
    return _downsize(cfg, scenes, str(tmp_path / "runs"), mono="mono" in name), scenes


def _train_side(cfg_user, vtrain, io, default_cfg, orch):
    if not vtrain.validate_cfg_file(copy.deepcopy(cfg_user)):
        return False, None
    cfg_user = io.merge({}, cfg_user)
    vtrain.augment_dataset_args(cfg_user)
    cfg = io.merge(default_cfg(), cfg_user)
    if cfg.model.input_channels != "geom":
        assert orch.read_image_pairs(cfg) is not False
    orch.allocate_area(cfg)
    phases = {p: _plain(orch.prepare_dataset_configuration(cfg, p)) for p in ("train", "val")}
    return True, {"cfg": _plain(cfg), "phases": phases}


@pytest.mark.parametrize("bad_key", [False, True], ids=["valid", "unknown-key"])
@pytest.mark.parametrize("template", TEMPLATES)
def test_validate_train_matches_jax(make_geotiff, tmp_path, template, bad_key):
    cfg, _ = _template(template, make_geotiff, tmp_path)
    if bad_key:
        cfg["model"]["not_a_model_key"] = 1
    want = _train_side(cfg, j_vtrain, j_io, j_default_cfg, j_orch)
    got = _train_side(cfg, t_vtrain, t_io, t_default_cfg, t_orch)
    assert got[0] is (not bad_key) and got == want


def _inference_config(template, make_geotiff, tmp_path):
    """An inference config over the template's first dataset, with the
    artifacts a training run of that template writes."""
    cfg, scenes = _template(template, make_geotiff, tmp_path)
    channels = cfg["model"]["input_channels"]
    train_ds, scene = cfg["datasets"][0], scenes[0]
    dataset = {"name": "eval", "raster_in": scene["raster_in"],
               "raster_gt": scene["raster_gt"], "area_type": "test",
               "allocation_strategy": "5-crossval_vertical", "test_stripe": 2}
    if "path_image_list" in train_ds:
        dataset.update(path_image_list=train_ds["path_image_list"],
                       path_pairlist=train_ds["path_pairlist_validation"])
    weights = tmp_path / "Model_best.npz"
    weights.write_bytes(b"")
    architecture = tmp_path / "model_config.json"
    architecture.write_text(json.dumps({"name": "ResDepth", "input_channels": channels,
                                        "settings": cfg["model"]}))
    model = {"weights": str(weights), "architecture": str(architecture)}
    for key, mean in (("normalization_geom", None), ("normalization_image", 120.0)):
        path = str(tmp_path / f"{key}.p")
        j_control.write_normalization_params_to_file(path, mean, 5.0)
        model[key] = path
    return {"datasets": [dataset], "model": model,
            "general": {"tile_size": 16, "batch_size": 4},
            "output": {"directory": str(tmp_path / "eval")}}


@pytest.mark.parametrize("bad_key", [False, True], ids=["valid", "unknown-key"])
@pytest.mark.parametrize("template", TEMPLATES)
def test_validate_infer_matches_jax(make_geotiff, tmp_path, template, bad_key):
    cfg = _inference_config(template, make_geotiff, tmp_path)
    if bad_key:
        cfg["general"]["not_a_general_key"] = 1
    results = []
    for vinfer, orch in ((j_vinfer, j_orch), (t_vinfer, t_orch)):
        out = vinfer.validate_and_update_cfg_file(copy.deepcopy(cfg))
        phases = None
        if out.status:
            if out.cfg.model.input_channels != "geom":
                assert orch.read_image_pairs(out.cfg) is not False
            orch.allocate_area(out.cfg)
            phases = _plain(orch.prepare_dataset_configuration(out.cfg, "test"))
        results.append((out.status, _plain(out.cfg), phases))
    assert results[1][0] is (not bad_key) and results[1] == results[0]


# -------------------------------- GeoTIFF ----------------------------------- #

@pytest.fixture(params=["native", "python"])
def codec(request, monkeypatch):
    """The native codec (built by each package) or, with its entry points
    failing, the pure-Python one in both packages."""
    if request.param == "python":
        def refuse(*args, **kwargs):
            raise RuntimeError("native codec switched off for this test")
        for module in (j_native, t_native):
            for name in ("lzw_decode", "lzw_encode", "packbits_decode"):
                monkeypatch.setattr(module, name, refuse)
    return request.param


@pytest.mark.parametrize("compress", ["none", "deflate", "lzw"])
def test_geotiff_bitwise_across_packages(tmp_path, codec, compress):
    """Each package writes the same bytes for the same raster, and each
    reads the other's file back bit for bit."""
    rng = np.random.default_rng(4)
    data = (400.0 + rng.normal(0.0, 3.0, (37, 29))).astype(np.float32)
    data[3:7, 5:9] = -9999.0
    geotransform = (465000.0, 0.25, 0.0, 5247000.0, 0.0, -0.25)
    paths = {}
    for name, tiff in (("jax", j_tiff), ("port", t_tiff)):
        paths[name] = str(tmp_path / f"{name}.tif")
        tiff.write(paths[name], data, geotransform=geotransform, nodata=-9999.0,
                   compress=compress)
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    for writer, reader in (("jax", t_raster), ("port", j_raster)):
        raster = reader.open_raster(paths[writer])
        assert raster.band(1).tobytes() == data.tobytes()
        assert raster.geotransform == geotransform and raster.nodata == -9999.0
    if codec == "native" and compress == "lzw":
        assert t_native._SO.startswith(BUILD_DIR) and os.path.exists(t_native._SO)


# ---------------------------- grids and blending ---------------------------- #

@pytest.mark.parametrize("tile,stride", [(16, 8), (16, 12), (32, None), (8, 3)])
def test_grid_and_blend_weights_match_jax(tile, stride):
    area = {"x_extent": [(3, 60), (70, 99)], "y_extent": [(1, 46), (0, 40)]}
    want = j_grid.create_regular_grid(area, tile, stride)
    got = t_grid.create_regular_grid(area, tile, stride)
    assert got == want
    np.testing.assert_array_equal(t_grid.positions_as_array(got[0]),
                                  j_grid.positions_as_array(want[0]))
    assert t_grid.indices_from_area_defn(area, tile) == j_grid.indices_from_area_defn(area, tile)
    step = stride or tile // 2
    for j, t in zip(j_blend.weight_table(tile, step, want[1]),
                    t_blend.weight_table(tile, step, got[1])):
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("strategy,stripe,crossval", [
    ("5-crossval_vertical", 1, False), ("5-crossval_vertical", 4, True),
    ("5-crossval_horizontal", 0, False), ("5-crossval_horizontal", 3, True)])
def test_allocation_matches_jax(make_geotiff, strategy, stripe, crossval):
    path = make_geotiff("alloc.tif", np.zeros((83, 101), np.float32))
    assert (t_alloc.allocate_data(path, strategy, stripe, crossval)
            == j_alloc.allocate_data(path, strategy, stripe, crossval))
    assert t_alloc.entire_area_defn(path) == j_alloc.entire_area_defn(path)


# ------------------------------- evaluation --------------------------------- #

@pytest.mark.parametrize("threshold", [None, 2.0])
def test_evaluate_performance_matches_jax(make_geotiff, tmp_path, threshold):
    """Residual maps per class and their statistics on a seeded residual,
    with building and water masks and nodata in the truth."""
    rng = np.random.default_rng(12)
    gt = (400.0 + rng.normal(0.0, 2.0, (48, 64))).astype(np.float32)
    gt[10:14, 20:30] = -9999.0
    initial = (gt + rng.normal(0.0, 1.0, gt.shape)).astype(np.float32)
    prediction = gt + rng.normal(0.0, 0.4, gt.shape) + rng.standard_t(2, gt.shape) * 0.1
    building = (rng.random(gt.shape) < 0.2).astype(np.uint8)
    water = np.zeros(gt.shape, np.uint8)
    water[30:34] = 1
    paths = dict(raster_in=make_geotiff("in.tif", initial),
                 raster_gt=make_geotiff("gt.tif", gt),
                 building=make_geotiff("b.tif", building, nodata=255),
                 water=make_geotiff("w.tif", water, nodata=255))
    area = {"x_extent": [(2, 61)], "y_extent": [(0, 47)]}
    results = []
    for evaluate, stats in ((j_evaluate, j_stats), (t_evaluate, t_stats)):
        maps = evaluate(prediction, paths["raster_in"], paths["raster_gt"],
                        area_defn=area, path_building_mask=paths["building"],
                        path_water_mask=paths["water"], residual_threshold=threshold)
        results.append({k: (np.ma.getdata(v).tobytes(), np.ma.getmaskarray(v).tobytes(),
                            _plain(stats(v, residual_threshold=threshold)))
                        for k, v in maps.items()})
    assert results[1].keys() == results[0].keys() and len(results[0]) > 2
    assert results[1] == results[0]


def _statistics_case(case):
    """Residuals of one shape of input that ``get_statistics`` is given."""
    rng = np.random.default_rng(31)
    data = rng.normal(0.0, 1.5, (257, 263)) + rng.standard_t(2, (257, 263)) * 0.2
    mask = rng.random(data.shape) < 0.3
    data[1, 1:3], mask[1, 1:3] = (2.0, -2.0), False  # on the truncation's threshold
    if case in ("odd", "even"):
        if np.count_nonzero(~mask) % 2 != (case == "odd"):
            mask[0, 0] = not mask[0, 0]
        return np.ma.masked_array(data, mask=mask)
    if case == "nomask":
        return np.ma.masked_array(data)
    if case == "all-masked":
        return np.ma.masked_array(data, mask=np.ones(data.shape, bool))
    if case == "one-pixel":
        one = np.ones(data.shape, bool)
        one[100, 7] = False
        data[100, 7] = 3.5
        return np.ma.masked_array(data, mask=one)
    if case in ("nan", "overflow"):  # an unmasked NaN, or a square past float64
        data[5, 9] = np.nan if case == "nan" else -1e200
        mask[5, 9] = False
        return np.ma.masked_array(data, mask=mask)
    flat = data.ravel()  # "pooled": a 1-D aggregate over image pairs
    flat[::97] = np.nan
    flat[::89] = np.inf
    return np.ma.masked_invalid(flat)


def _bits(tree):
    """Statistics as their types and bytes, ``np.ma.masked`` by name."""
    if isinstance(tree, dict):
        return {k: _bits(v) for k, v in tree.items()}
    if tree is np.ma.masked:
        return "masked"
    return type(tree).__name__, np.asarray(tree).tobytes()


@pytest.mark.parametrize("nmad_center", ["medae", "median"])
@pytest.mark.parametrize("threshold", [None, 2.0])
@pytest.mark.parametrize("case", ["odd", "even", "nomask", "all-masked", "one-pixel",
                                  "nan", "overflow", "pooled"])
def test_get_statistics_bitwise_matches_jax(case, threshold, nmad_center):
    """The port's statistics by exact selection against the JAX package's masked
    sorts: every value, its type and key order, and the input left as it was."""
    residuals = _statistics_case(case)
    before = (np.ma.getdata(residuals).tobytes(), np.ma.getmaskarray(residuals).tobytes())
    if case == "nan" and threshold:
        # The truncated set's deviations are all NaN and outnumbered by its masked
        # pixels: np.ma.median's NaN check then writes into np.ma.masked and raises.
        # Selection gives the NaN that the check means; the rest is as np.ma has it.
        with pytest.raises(ValueError, match="read-only"):
            j_stats(residuals, threshold, nmad_center)
        got = t_stats(residuals, threshold, nmad_center)
        truncated = got.pop("truncated")
        assert np.isnan([truncated.absolute_median, truncated.median, truncated.NMAD]).all()
        expected = _bits(j_stats(residuals, None, nmad_center))
        assert _bits(got) == dict(expected, truncation=_bits(True))
    else:
        expected = _bits(j_stats(residuals, threshold, nmad_center))
        got = _bits(t_stats(residuals, threshold, nmad_center))
        assert list(got) == list(expected)
        assert got == expected
    assert (np.ma.getdata(residuals).tobytes(),
            np.ma.getmaskarray(residuals).tobytes()) == before


# -------------------------------- schedulers -------------------------------- #

@pytest.mark.parametrize("cfg", [
    {"enabled": True, "name": "StepLR", "settings": {"step_size": 3, "gamma": 0.5}},
    {"enabled": True, "name": "ExponentialLR", "settings": {"gamma": 0.9}},
    {"enabled": True, "name": "ReduceLROnPlateau",
     "settings": {"factor": 0.5, "patience": 2, "cooldown": 1, "min_lr": 1e-5}},
    {"enabled": False}], ids=["StepLR", "ExponentialLR", "ReduceLROnPlateau", "off"])
def test_scheduler_lr_sequences_match_jax(cfg):
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.8, 0.81, 0.82, 0.83, 0.84, 0.85, 0.7]
    sequences = []
    for build in (j_build_scheduler, t_build_scheduler):
        scheduler = build(copy.deepcopy(cfg), 2e-4)
        if scheduler is None:
            sequences.append(None)
            continue
        lrs = [scheduler.step(m) for m in metrics]
        state = scheduler.state_dict()
        sequences.append((lrs, _plain(state)))
    assert sequences[1] == sequences[0]
    if cfg["enabled"]:
        assert len(set(sequences[0][0])) > 1


# ------------------------ TileDataset and normalization ---------------------- #

@pytest.mark.parametrize("channels,strategy", [
    ("geom", "train"), ("geom-stereo", "train"), ("geom-stereo", "val"),
    ("stereo", "test"), ("geom-multiview", "val")])
def test_tile_dataset_matches_jax(make_geotiff, tmp_path, channels, strategy):
    """The same files and seed give the same tiles in both packages: the
    sampled positions, pair indices, bounds, rasters and loss masks."""
    paths, _, _ = _write_scene(make_geotiff, tmp_path)
    pairlist = {"test": paths["pairlist_single"]}.get(strategy, paths["pairlist"])
    if channels == "geom-multiview":
        pairlist = str(tmp_path / "triples.txt")
    if channels == "geom-multiview":
        with open(pairlist, "w") as f:
            f.write("ortho_0, ortho_1, ortho_2\n")
    entry = {"raster_in": paths["raster_in"], "raster_gt": paths["raster_gt"],
             "area_defn": {"x_extent": [(0, 59), (70, 99)], "y_extent": [(0, 79), (5, 70)]},
             "n_samples": 17}
    if channels != "geom":
        image_list, pairs = j_control.read_pairlist_from_file(paths["imagelist"], pairlist)
        assert t_control.read_pairlist_from_file(paths["imagelist"], pairlist) == (
            image_list, pairs)
        entry.update(image_list=image_list, image_pairs=pairs)
    kwargs = dict(input_channels=channels, tile_size=16, sampling_strategy=strategy,
                  dsm_std=5.0, ortho_mean=None, ortho_std=25.0, seed=5,
                  use_all_stereo_pairs=strategy != "train")
    datasets = [cls(copy.deepcopy(entry), **kwargs) for cls in (JTileDataset, TileDataset)]
    want, got = datasets
    assert len(got) == len(want) > 0
    for name in ("positions", "pair_indices", "valid_bounds", "dsm_input", "dsm_target",
                 "orthos", "pairs_array", "nodata"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(got.gather_input_patches(), want.gather_input_patches())
    for i in range(len(got)):
        np.testing.assert_array_equal(got.loss_mask_host(i), want.loss_mask_host(i))


def test_normalization_pickles_match_jax(make_geotiff, tmp_path):
    """The train CLI's sigma pass and image statistics, written as the
    reference pickles, byte for byte."""
    paths, _, _ = _write_scene(make_geotiff, tmp_path)
    image_list, pairs = j_control.read_pairlist_from_file(paths["imagelist"],
                                                          paths["pairlist"])
    cfg_data = [{"raster_in": paths["raster_in"], "raster_gt": paths["raster_gt"],
                 "image_list": image_list, "image_pairs": pairs, "n_samples": 40,
                 "area_defn": {"x_extent": [(0, 59)], "y_extent": [(0, 79)]}}]
    blobs = []
    for name, norm, control, cls in (("jax", j_norm, j_control, JTileDataset),
                                     ("port", t_norm, t_control, TileDataset)):
        ds = cls(copy.deepcopy(cfg_data[0]), input_channels="geom", tile_size=16,
                 sampling_strategy="train", dsm_std=1.0, seed=3)
        sigma = norm.robust_mean_std(norm.patch_stds_from_positions(
            ds.dsm_input, ds.nodata, ds.positions, ds.tile_size))
        exact = norm.sigma_from_positions(ds.dsm_input, ds.nodata, ds.positions, 16,
                                          exact=True)
        mean, std = norm.compute_satellite_image_normalization(copy.deepcopy(cfg_data))
        files = []
        for role, values in (("dsm", (None, sigma)), ("image", (mean, std))):
            path = str(tmp_path / f"{name}_{role}.p")
            control.write_normalization_params_to_file(path, *values)
            with open(path, "rb") as f:
                files.append(f.read())
        blobs.append((files, exact))
    assert blobs[1] == blobs[0]
    assert pickle.loads(blobs[1][0][0])["std"] > 0


def test_synth_city_matches_the_demo_script():
    """``utils/synth.py`` makes the same seeded scene as
    ``scripts/make_demo_data.py``, so chip runs stay comparable."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import make_demo_data

    for got, want in zip(synth.synth_city(96, 128, seed=3),
                         make_demo_data.synth_city(96, 128, seed=3)):
        np.testing.assert_array_equal(got, want)
    gt = synth.synth_city(64, 64)[0]
    np.testing.assert_array_equal(synth.hillshade(gt, 135),
                                  make_demo_data.hillshade(gt, 135))
    assert (synth.GSD, synth.NODATA) == (make_demo_data.GSD, make_demo_data.NODATA)
