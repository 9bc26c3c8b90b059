"""The port's data parallelism (``resdepth_tpu_torch/parallel``) on the CPU.

Worlds of 2 processes over gloo (``_torch_parallel_worker.py``, which
cannot import JAX), held against the port's 1-process runs and the JAX
package's 2-device mesh (conftest's virtual CPU devices), on the same
weights and inputs:

* Three Adam steps of ``make_train_step(group=...)`` at batch 8 (4 a rank),
  augmentation off, at float32 'high' and 'balanced16', and at batch 6
  padded to 8 with zero-weight samples (all padding on rank 1). Bars of
  ``tests/test_train.py``'s mesh tests: float32 metric rtol 2e-4, weights
  and BatchNorm running statistics rtol 1e-3, atol 2e-5; balanced16 rtol
  5e-3, atol 1e-4 on the metric and running statistics (its weights: see
  the test).
* BatchNorm's statistics all-reduce carries gradients: the 2-rank dx is the
  1-process dx (rtol 1e-5); one whose backward skips the all-reduce is not.
* Tile-sharded ``predict_linear_blend`` (tta 2, median merge), the streamed
  scene (9 bands) and ``predict_linear_blend_scene_sharded`` (9 bands in
  waves of 2) under the group: within ``SCENE_ULPS`` = 2 f32 ulps of the
  largest height (K1's bar, ``chip_smoke.ulps``) of the 1-process scene
  and of JAX's mesh scene; the scene-sharded one within
  ``tests/test_pipeline.py``'s bar (rtol 1e-5, atol 1e-4) of JAX's and
  bitwise the 1-process streamed scene off the rows two bands share.
* The bootstrap's triggers, case by case against JAX's decision, with no
  process group made.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from resdepth_tpu.data import pipeline as jpipe
from resdepth_tpu.data.dataset import TileDataset as JTileDataset
from resdepth_tpu.geo import tiff as jtiff
from resdepth_tpu.infer import tiled as jtiled
from resdepth_tpu.models import unet as junet
from resdepth_tpu.parallel import bootstrap as jbootstrap
from resdepth_tpu.parallel.mesh import data_mesh as jdata_mesh
from resdepth_tpu.train.optim import build_optimizer as jbuild_optimizer
from resdepth_tpu.train.step import init_train_state as jinit_state
from resdepth_tpu.train.step import make_train_step as jmake_step
from resdepth_tpu_torch.data.dataset import TileDataset
from resdepth_tpu_torch.infer import tiled
from resdepth_tpu_torch.models import unet
from resdepth_tpu_torch.models import weights
from resdepth_tpu_torch.parallel import bootstrap, mesh
from resdepth_tpu_torch.train.step import init_train_state, make_train_step
from test_torch_unet import _jax_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
RANKS = 2
WORLD_TIMEOUT = 150          # seconds for a whole world; each collective waits 60
SCENE_ULPS = 2
LR = 1e-3
STEPS = 3
TOY_TILE = 16
TOY = dict(n_input_channels=1, start_kernel=4, max_filter_depth=8, depth=2)
SCENE = dict(n_input_channels=3, start_kernel=8, max_filter_depth=16, depth=2)
ROWS, COLS, TILE = 144, 64, 16
BUDGET = 32 * COLS * 4           # 32-row windows of the DSM and 3 orthos: 9 bands
BAR_F32 = dict(metric=2e-4, rtol=1e-3, atol=2e-5)
BAR_B16 = dict(metric=5e-3, rtol=5e-3, atol=1e-4)
# (policy, global batch, real samples): batch 6 padded to 8 puts its two
# zero-weight samples on rank 1
TRAIN_CASES = {"high-b8": ("high", 8, 8), "high-b6-emit8": ("high", 8, 6),
               "balanced16-b8": ("balanced16", 8, 8)}


def run_world(argv: list, cwd: str, **kwargs) -> list:
    """``parallel.bootstrap.run_world`` for the tests: ``RANKS`` ranks of
    2 threads each under ``WORLD_TIMEOUT``; returns their outputs."""
    return bootstrap.run_world(argv, kwargs.pop("n", RANKS),
                               timeout=kwargs.pop("timeout", WORLD_TIMEOUT), cwd=cwd,
                               env={**os.environ, "OMP_NUM_THREADS": "2"}, **kwargs)


# ------------------------------- the inputs --------------------------------- #

def _toy(batch: int = 8):
    """``tests/test_train.py::_toy_setup``'s scene and batch, as numpy."""
    rng = np.random.default_rng(0)
    rows = cols = 48
    gt = rng.normal(100.0, 3.0, (rows, cols)).astype(np.float32)
    dsm = gt + rng.normal(0.0, 1.0, (rows, cols)).astype(np.float32)
    positions = rng.integers(0, rows - TOY_TILE, (batch, 2)).astype(np.int32)
    return dsm, gt, positions


def _state_arrays(model: unet.UNet) -> dict:
    return {f"state.{k}": v.numpy() for k, v in model.state_dict().items()}


def _train_inputs(case: str, params, bn_state) -> dict:
    _, batch, real = TRAIN_CASES[case]
    dsm, gt, positions = _toy(batch)
    sample_weights = (np.arange(batch) < real).astype(np.float32)
    model = unet.UNet(unet.UNetConfig(**TOY))
    model.load_state_dict(weights.state_dict_from_jax_params(params, bn_state, model.config))
    return {"dsm": dsm, "gt": gt, "positions": positions, "weights": sample_weights,
            **_state_arrays(model)}


def _scene_entry(work: str) -> dict:
    """``tests/test_pipeline.py::_scene``'s scene at 144 x 64 px."""
    rng = np.random.default_rng(0)
    gt = rng.normal(400.0, 8.0, (ROWS, COLS)).astype(np.float32)
    dsm = gt + rng.normal(0.0, 1.0, (ROWS, COLS)).astype(np.float32)
    dsm[5:8, 5:8] = -9999.0
    images = rng.normal(120.0, 25.0, (ROWS, COLS, 3)).astype(np.float32)
    geotransform = (1000.0, 0.25, 0.0, 2000.0, 0.0, -0.25)

    def write(name, data):
        path = os.path.join(work, name)
        jtiff.write(path, data, geotransform=geotransform, nodata=-9999.0)
        return path

    return {"raster_in": write("dsm.tif", dsm),
            "image_list": [write(f"img{j}.tif", images[..., j]) for j in range(3)],
            "image_pairs": [(0, 1)],
            "area_defn": {"x_extent": [(0, COLS - 1)], "y_extent": [(0, ROWS - 1)]}}


def _scene_datasets(entry):
    return [cls(entry, input_channels="geom-stereo", tile_size=TILE,
                sampling_strategy="test", dsm_std=5.0, ortho_mean=120.0, ortho_std=25.0)
            for cls in (TileDataset, JTileDataset)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every task of this file in one world of 2 ranks: the train cases,
    the BatchNorm gradient and the three scene paths."""
    work = str(tmp_path_factory.mktemp("parallel"))
    toy = junet.UNetConfig(**TOY)
    toy_params, toy_state = jax.tree_util.tree_map(   # test_train.py's weights
        np.asarray, junet.init_unet(jax.random.PRNGKey(0), toy))
    scene = junet.UNetConfig(**SCENE)
    scene_params, scene_state = _jax_weights(scene, seed=4)
    entry = _scene_entry(work)
    rng = np.random.default_rng(7)
    bn_inputs = {"x": rng.normal(2.0, 3.0, (8, 5, 6, 7)).astype(np.float32),
                 "g": rng.normal(0.0, 1.0, (8, 5, 6, 7)).astype(np.float32),
                 "weights": np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)}
    scene_model = unet.UNet(unet.UNetConfig(**SCENE))
    scene_model.load_state_dict(weights.state_dict_from_jax_params(
        scene_params, scene_state, scene_model.config))

    tasks, inputs = [], {}
    for case, (policy, _, _) in TRAIN_CASES.items():
        inputs[case] = _train_inputs(case, toy_params, toy_state)
        tasks.append({"kind": "train", "settings": TOY, "policy": policy, "tile": TOY_TILE,
                      "lr": LR, "steps": STEPS})
    inputs["bn"] = bn_inputs
    tasks.append({"kind": "bn"})
    inputs["infer"] = _state_arrays(scene_model)
    tasks.append({"kind": "infer", "settings": SCENE, "entry": entry, "tile": TILE,
                  "batch_size": 4, "budget": BUDGET, "sharded_budget": BUDGET})
    for task, name in zip(tasks, inputs):
        task["inputs"] = os.path.join(work, f"{name}.in.npz")
        task["out"] = os.path.join(work, name)
        np.savez(task["inputs"], **inputs[name])
    plan = os.path.join(work, "plan.json")
    with open(plan, "w") as f:
        json.dump({"tasks": tasks}, f)
    run_world([sys.executable, WORKER, plan], cwd=work)
    results = {name: [dict(np.load(f"{os.path.join(work, name)}.r{r}.npz"))
                      for r in range(RANKS)] for name in inputs}
    return {"results": results, "inputs": inputs, "entry": entry,
            "toy": (toy, toy_params, toy_state),
            "scene": (scene, scene_params, scene_state, scene_model)}


# ------------------------------ the train step ------------------------------ #

def _toy_rasters(arrays):
    from resdepth_tpu_torch.data.pipeline import DeviceRasters
    return DeviceRasters(torch.from_numpy(arrays["dsm"]), torch.from_numpy(arrays["gt"]),
                         None, torch.zeros((1, 0), dtype=torch.int64), -9999.0)


def _one_process(arrays, policy, real):
    """The port's steps in this process, no group, on the real samples."""
    from resdepth_tpu_torch.data.pipeline import BatchSpec, GeneratorDraws
    from resdepth_tpu_torch.train.step import select_train_precision

    model = unet.UNet(unet.UNetConfig(**TOY))
    model.load_state_dict({k[6:]: torch.from_numpy(v) for k, v in arrays.items()
                           if k.startswith("state.")})
    kwargs, dtype = select_train_precision(policy, None, torch.device("cpu"))
    state = init_train_state(model, "Adam", LR, 1e-5)
    step = make_train_step(BatchSpec(input_channels="geom", tile_size=TOY_TILE, dsm_std=3.0),
                           weighted_bn=True, compute_dtype=dtype, **kwargs)
    batch = (arrays["positions"][:real], np.zeros(real, np.int32),
             np.zeros((real, 4), np.int32), np.ones(real, np.float32))
    metrics = [float(step(state, _toy_rasters(arrays), *batch,
                          GeneratorDraws(torch.Generator().manual_seed(0))))
               for _ in range(STEPS)]
    return metrics, {k: v.numpy() for k, v in model.state_dict().items()}


def _jax_mesh(arrays, toy, policy):
    """JAX's ``make_train_step(mesh=data_mesh(2))`` on the global batch."""
    config, params, bn_state = toy
    kwargs = ({} if policy == "high"
              else junet.serving_precision(policy).apply_kwargs())
    tx = jbuild_optimizer("Adam", 1e-5)
    state = jinit_state(params, bn_state, tx, LR)
    step = jmake_step(config, jpipe.BatchSpec(input_channels="geom", tile_size=TOY_TILE,
                                              dsm_std=3.0),
                      tx, mesh=jdata_mesh(RANKS), donate=False, **kwargs)
    rasters = jpipe.DeviceRasters(jnp.asarray(arrays["dsm"]), jnp.asarray(arrays["gt"]),
                                  None, jnp.zeros((1, 0), jnp.int32),
                                  jnp.asarray(-9999.0, jnp.float32))
    batch = len(arrays["positions"])
    metrics = []
    for _ in range(STEPS):
        state, metric = step(state, rasters, arrays["positions"], np.zeros(batch, np.int32),
                             np.zeros((batch, 4), np.int32), arrays["weights"],
                             jax.random.PRNGKey(1))
        metrics.append(float(metric))
    model = unet.UNet(unet.UNetConfig(**TOY))
    sd = weights.state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, state.params),
                                            jax.tree_util.tree_map(np.asarray,
                                                                   state.bn_state),
                                            model.config)
    return metrics, {k: np.asarray(v) for k, v in sd.items()}


def _assert_states_close(got: dict, want: dict, bar: dict, what: str) -> None:
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    assert keys and set(keys) <= set(got)
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=bar["rtol"], atol=bar["atol"],
                                   err_msg=f"{what}: {key}")


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _update_gap(got: dict, want: dict, start: dict) -> float:
    """Relative L2 between two runs' weight updates, over every weight."""
    keys = [k for k in want if not k.endswith(("running_mean", "running_var",
                                                "num_batches_tracked"))]
    return _rel_l2(np.concatenate([(got[k] - start[k]).ravel() for k in keys]),
                   np.concatenate([(want[k] - start[k]).ravel() for k in keys]))


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step_matches_one_process_and_jax_mesh(world, case):
    """float32: every weight and running statistic at ``BAR_F32`` of the
    port's one process and of JAX's mesh (measured: 6e-8 and 1.2e-6 at
    most). balanced16 rounds its trunk to bf16, and the ranks' regrouped
    BatchNorm sums move a few roundings, which a gradient near zero carries
    into Adam's first steps as a flipped sign (a weight moves by 2 lr):
    measured after 3 steps, the weights 2.0e-3 from one process at most
    (updates 3.3e-2 relative L2) and the running statistics within
    ``BAR_B16``; from JAX's mesh 5.9e-3 and 0.18, as far as the port's one
    process is from it (5.5e-3 and 0.18, the frameworks' bf16 gap of
    ``test_torch_train_precision.py``). So balanced16 holds the metric at
    ``BAR_B16``, every weight within 2 lr a step of both, the updates within
    0.1 relative L2 of one process and no further from JAX's than one
    process is (x1.25), the running statistics at ``BAR_B16`` of one
    process and within ``BF16_STEP_BARS['bn']`` relative L2 of JAX's."""
    from test_torch_train_precision import BF16_STEP_BARS

    policy, _, real = TRAIN_CASES[case]
    ranks = world["results"][case]
    arrays = world["inputs"][case]
    bar = BAR_F32 if policy == "high" else BAR_B16
    got_metrics = ranks[0]["metrics"]
    got = {k[6:]: v for k, v in ranks[0].items() if k.startswith("state.")}
    start = {k[6:]: v for k, v in arrays.items() if k.startswith("state.")}
    assert np.isfinite(got_metrics).all() and len(got_metrics) == STEPS
    for other in ranks[1:]:   # every rank steps to the same weights
        np.testing.assert_array_equal(other["metrics"], got_metrics)
        for key, value in got.items():
            np.testing.assert_array_equal(other[f"state.{key}"], value)
    refs = {"one process": _one_process(arrays, policy, real),
            "JAX mesh(2)": _jax_mesh(arrays, world["toy"], policy)}
    for name, (metrics, want) in refs.items():
        np.testing.assert_allclose(got_metrics, metrics, rtol=bar["metric"], err_msg=name)
        if policy == "high":
            _assert_states_close(got, want, bar, name)
            continue
        stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
        if name == "one process":
            _assert_states_close(got, {k: want[k] for k in stats}, bar, name)
            assert _update_gap(got, want, start) <= 0.1
        else:
            assert max(_rel_l2(got[k], want[k]) for k in stats) <= BF16_STEP_BARS["bn"]
            one = refs["one process"][1]
            assert _update_gap(got, want, start) <= 1.25 * _update_gap(one, want, start)
        assert max(np.abs(got[k] - want[k]).max() for k in want
                   if k not in stats) <= 2 * LR * STEPS * (1 + 1e-3), name
    # the steps moved the running statistics
    assert max(np.abs(got[k] - start[k]).max() for k in start
               if k.endswith("running_mean")) > 1e-4


def test_batchnorm_statistics_carry_gradients(world):
    """dx through BatchNorm's cross-rank statistics (batch 8, its last two
    samples zero-weight) is the 1-process dx; without the all-reduce in
    the backward each rank misses the other's share."""
    arrays = world["inputs"]["bn"]
    bn = torch.nn.BatchNorm2d(arrays["x"].shape[1])
    x = torch.from_numpy(arrays["x"]).requires_grad_(True)
    y, _, _ = unet.batch_norm_train(bn, x, torch.from_numpy(arrays["weights"]))
    (y * torch.from_numpy(arrays["g"])).sum().backward()
    want = x.grad.numpy()
    ranks = world["results"]["bn"]
    got = np.concatenate([r["dx.port"] for r in ranks])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    local = np.concatenate([r["dx.local_grad"] for r in ranks])
    assert _rel_l2(local, want) > 1e3 * max(_rel_l2(got, want), 1e-7)


# ------------------------------- inference ---------------------------------- #

def _port_scene(world, fn, **kwargs):
    ds, _ = _scene_datasets(world["entry"])
    return fn(world["scene"][3], ds, device="cpu", batch_size=4, **kwargs)


def _seam_rows(ds) -> np.ndarray:
    """Rows that tiles of more than one band cover."""
    covered = np.zeros(ROWS, np.int32)
    for window, _, positions in tiled._iter_bands(ds, tiled._rows_budget(ds, BUDGET)):
        rows = np.zeros(ROWS, bool)
        for y in positions[:, 0] + window.start:
            rows[y:y + TILE] = True
        covered += rows
    return covered > 1


def test_tile_sharded_scene_matches_one_process_and_jax_mesh(world):
    config, params, state, _ = world["scene"]
    ranks = [r["tiled"] for r in world["results"]["infer"]]
    np.testing.assert_array_equal(ranks[1], ranks[0])   # every rank holds the scene
    got = ranks[0]
    _, jds = _scene_datasets(world["entry"])
    jax_mesh = np.asarray(jtiled.predict_linear_blend(
        config, params, state, jds, batch_size=4, mesh=jdata_mesh(RANKS),
        use_pallas=False, tta=2, tta_merge="median"))
    one = _port_scene(world, tiled.predict_linear_blend, tta=2, tta_merge="median")
    assert got.shape == (ROWS, COLS) and np.isfinite(got).all() and (got != 0).all()
    for want in (one, jax_mesh):
        np.testing.assert_allclose(got, want, rtol=0, atol=chip_smoke.ulps(want, SCENE_ULPS))


def test_streaming_under_a_group_matches_the_resident_scene(world):
    """Each band's tiles shared over the ranks and its canvas summed, the
    band above's sums carried on the chief alone (counted twice, they
    would double the shared rows)."""
    ds, _ = _scene_datasets(world["entry"])
    bands = list(tiled._iter_bands(ds, tiled._rows_budget(ds, BUDGET)))
    assert len(bands) >= 3
    ranks = [r["streamed"] for r in world["results"]["infer"]]
    np.testing.assert_array_equal(ranks[1], ranks[0])
    resident = _port_scene(world, tiled.predict_linear_blend)
    np.testing.assert_allclose(ranks[0], resident, rtol=0,
                               atol=chip_smoke.ulps(resident, SCENE_ULPS))


def test_scene_sharded_matches_jax_and_the_streamed_scene(world):
    config, params, state, _ = world["scene"]
    results = world["results"]["infer"]
    assert not results[0]["sharded_is_none"] and results[1]["sharded_is_none"]
    assert "sharded" not in results[1]              # only the chief holds the scene
    got = results[0]["sharded"]
    ds, jds = _scene_datasets(world["entry"])
    assert len(list(tiled._iter_bands(ds, tiled._rows_budget(ds, BUDGET)))) > RANKS
    want = jtiled.predict_linear_blend_scene_sharded(
        config, params, state, jds, batch_size=4, max_device_pixels=BUDGET,
        devices=jax.devices()[:RANKS], use_pallas=False)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    resident = _port_scene(world, tiled.predict_linear_blend)
    np.testing.assert_allclose(got, resident, rtol=1e-5, atol=1e-4)
    streamed = _port_scene(world, tiled.predict_linear_blend_streaming,
                           max_device_pixels=BUDGET)
    seams = _seam_rows(ds)
    assert 0 < seams.sum() < ROWS
    np.testing.assert_array_equal(got[~seams], streamed[~seams])
    np.testing.assert_allclose(got[seams], streamed[seams], rtol=0,
                               atol=chip_smoke.ulps(streamed, SCENE_ULPS))


def test_scene_sharded_without_a_group_runs_every_band(world):
    """One process takes every band in turn (waves of one)."""
    ds, _ = _scene_datasets(world["entry"])
    got = _port_scene(world, tiled.predict_linear_blend_scene_sharded,
                      max_device_pixels=BUDGET)
    np.testing.assert_array_equal(got, world["results"]["infer"][0]["sharded"])


# ------------------------------- the bootstrap ------------------------------ #

COORDINATOR = {"RESDEPTH_DIST_COORDINATOR": "localhost:29123",
               "RESDEPTH_DIST_NUM_PROCESSES": "4", "RESDEPTH_DIST_PROCESS_ID": "3"}
TRIGGERS = {
    "nothing": ({}, None),
    **{f"env-off-{v!r}": ({"RESDEPTH_DISTRIBUTED": v}, None)
       for v in ("", "0", "false", "False", " no ", "off", "OFF", " Off ")},
    **{f"env-on-{v!r}": ({"RESDEPTH_DISTRIBUTED": v}, None)
       for v in ("1", "true", "True", "yes")},
    "config-on": ({}, {"distributed": True}),
    "config-off": ({}, {"distributed": False}),
    "config-on-env-off": ({"RESDEPTH_DISTRIBUTED": "off"}, {"distributed": True}),
    "coordinator": (COORDINATOR, None),
    "coordinator-over-env": ({**COORDINATOR, "RESDEPTH_DISTRIBUTED": "1"}, None),
}


@pytest.mark.parametrize("case", list(TRIGGERS))
def test_bootstrap_triggers_as_jax(monkeypatch, case):
    """The same env and config start the same kind of launch as JAX's
    ``maybe_initialize_distributed`` (its ``jax.distributed.initialize``
    and the port's ``init_process_group`` recorded, not run)."""
    env, tpu = TRIGGERS[case]
    for name in ("RESDEPTH_DISTRIBUTED", *COORDINATOR):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    jcalls, tcalls = [], []
    monkeypatch.setattr(jbootstrap, "_initialized", False)
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: jcalls.append(kw))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: tcalls.append((backend, kw)))
    want = jbootstrap.maybe_initialize_distributed(tpu)
    got = bootstrap.maybe_initialize_distributed(tpu, device="cpu")
    assert got == want and len(tcalls) == len(jcalls) == int(want)
    if not want:
        assert bootstrap.is_chief() and jbootstrap.is_chief()
        return
    backend, kwargs = tcalls[0]
    assert backend == "gloo" and kwargs["timeout"] == bootstrap.TIMEOUT
    if jcalls[0]:
        assert jcalls[0] == {"coordinator_address": "localhost:29123",
                             "num_processes": 4, "process_id": 3}
        assert (kwargs["init_method"], kwargs["world_size"], kwargs["rank"]) == (
            "tcp://localhost:29123", 4, 3)
    else:
        assert kwargs == {"init_method": "env://", "timeout": bootstrap.TIMEOUT}


@pytest.mark.parametrize("local_rank,rank,backend,want", [
    (None, "3", None, (1, "nccl")), ("0", "3", None, (0, "nccl")),
    (None, "2", "gloo", (0, "gloo"))], ids=["rank-mod-cards", "local-rank", "gloo-by-argument"])
def test_bootstrap_binds_the_card_first(monkeypatch, local_rank, rank, backend, want):
    """On CUDA the rank binds its card before the group forms (LOCAL_RANK,
    else the rank modulo the visible cards) and takes NCCL, unless the
    caller passes gloo."""
    order = []
    monkeypatch.setenv("RESDEPTH_DISTRIBUTED", "1")
    monkeypatch.setenv("RANK", rank)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: order.append(("card", i)))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda b, **kw: order.append(("init", b)))
    assert bootstrap.maybe_initialize_distributed(device="cuda", backend=backend)
    assert order == [("card", want[0]), ("init", want[1])]


def test_mesh_without_a_group():
    assert mesh.device_count() == 1 and mesh.data_mesh() is None
    assert mesh.size(None) == 1 and mesh.rank(None) == 0
    assert mesh.pad_to_multiple(6, 4) == 8 and mesh.pad_to_multiple(8, 4) == 8
    with pytest.raises(ValueError, match="1 devices not divisible into 2 slices"):
        mesh.data_mesh_2d(2)
    with pytest.raises(ValueError, match="a group of 2 ranks in a world of 1"):
        mesh.data_mesh(2)
    t = torch.ones(3, requires_grad=True)
    assert mesh.all_reduce_sum(t, None) is t and mesh.all_reduce_(t, None) is t
