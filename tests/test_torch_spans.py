"""The program's spans (``resdepth_tpu_torch.utils.profiler.span``) on the
CPU.

* With no profiler on, a span records nothing and makes no torch call.
* Under ``torch.profiler`` spans nest (``parent``), appear in the Chrome
  trace as ``user_annotation`` events on the store's clock, and a span open
  when the profiler stops is still recorded whole; ``trace`` empties the
  store when its block ends.
* A 256² scene through ``predict_linear_blend`` records one ``scene`` with
  its weight table, each batch's gather and forward, and the fetch under
  it, while the module attributes the benchmark swaps are still the ones
  called; a three-step ``Trainer.train_one_epoch`` records its steps, which
  the benchmark's step arithmetic (``benchmark/spans.py``) reads.
"""

import json
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import spans as bench_spans
from resdepth_tpu_torch.data.dataset import TileDataset
from resdepth_tpu_torch.data.pipeline import (BatchIndexIterator, batch_spec_for,
                                              device_put_dataset)
from resdepth_tpu_torch.infer import tiled
from resdepth_tpu_torch.models import unet as tunet
from resdepth_tpu_torch.ops import blend, stitch
from resdepth_tpu_torch.train.step import init_train_state, make_train_step
from resdepth_tpu_torch.train.trainer import Trainer
from resdepth_tpu_torch.utils import profiler
from test_banded import COLS, ROWS, _scene

SETTINGS = dict(n_input_channels=3, start_kernel=4, max_filter_depth=8, depth=2)


@pytest.fixture(autouse=True)
def empty_store():
    profiler.clear()
    yield
    profiler.clear()


def _profiled():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    return prof


def _by_name(records):
    out = {}
    for i, r in enumerate(records):
        out.setdefault(r["name"], []).append((i, r))
    return out


def test_span_without_a_profiler_records_nothing():
    with mock.patch("torch.profiler.record_function") as record_function, \
            mock.patch("torch.cuda.Event") as event, \
            mock.patch.object(profiler.time, "time_ns") as clock:
        with profiler.span("scene", device=torch.device("cuda", 0)):
            with profiler.step_annotation("train", 4):
                pass
    assert not record_function.called and not event.called and not clock.called
    assert profiler.spans() == []


def test_spans_nest_and_reach_the_chrome_trace(tmp_path):
    prof = _profiled()
    with profiler.span("scene"):
        with profiler.span("scene.gather"):
            torch.ones(32, 32) @ torch.ones(32, 32)
        with profiler.span("scene.forward"):
            with profiler.span("inner"):
                pass
    with profiler.span("scene"):
        pass
    prof.stop()
    records = profiler.spans()
    assert [r["name"] for r in records] == ["scene", "scene.gather", "scene.forward",
                                           "inner", "scene"]
    assert [r["parent"] for r in records] == [None, 0, 0, 2, None]
    assert not any(r["outlived_profile"] for r in records)
    for r in records:
        assert r["start_ns"] <= r["end_ns"]
    assert records[0]["start_ns"] <= records[1]["start_ns"] <= records[3]["end_ns"] \
        <= records[0]["end_ns"]

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    events = [e for e in trace["traceEvents"] if e.get("cat") == "user_annotation"]
    assert sorted(e["name"] for e in events) == sorted(r["name"] for r in records)
    for r in records:
        nearest = min(abs(r["start_ns"] / 1e3 - (e["ts"] + base_us))
                      for e in events if e["name"] == r["name"])
        assert nearest < 5e3, (r["name"], nearest)


def test_span_open_at_the_profilers_stop_is_recorded():
    with profiler.span("before"):        # opened with the profiler off
        prof = _profiled()
    with profiler.span("step") as step:
        with profiler.span("inside"):
            pass
        prof.stop()
    with profiler.span("after"):
        pass
    records = profiler.spans()
    assert [r["name"] for r in records] == ["step", "inside"]
    assert step is not None and all(r["end_ns"] is not None for r in records)
    assert [r["outlived_profile"] for r in records] == [True, False]
    assert records[1]["parent"] == 0


def test_trace_empties_the_store_when_its_block_ends(tmp_path):
    with profiler.trace(str(tmp_path)):
        with profiler.span("scene"):
            pass
        assert [r["name"] for r in profiler.spans()] == ["scene"]
    assert profiler.spans() == []
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert names == ["scene"]


def test_scene_records_its_spans(make_geotiff):
    rows = cols = 256
    rng = np.random.default_rng(2)
    dsm = (400.0 + rng.normal(0.0, 3.0, (rows, cols))).astype(np.float32)
    images = rng.normal(120.0, 25.0, (2, rows, cols)).astype(np.float32)
    entry = {"raster_in": make_geotiff("dsm.tif", dsm),
             "image_list": [make_geotiff(f"img{j}.tif", images[j]) for j in range(2)],
             "image_pairs": [(0, 1)],
             "area_defn": {"x_extent": [(0, cols - 1)], "y_extent": [(0, rows - 1)]}}
    ds = TileDataset(entry, input_channels="geom-stereo", tile_size=64,
                     sampling_strategy="test", dsm_std=5.0, ortho_mean=None,
                     ortho_std=25.0)
    model = tunet.init_unet(tunet.UNetConfig(**SETTINGS), torch.Generator().manual_seed(0))
    n, batch = len(ds.positions), 16
    batches = -(-n // batch)
    assert n == 49 and batches == 4

    calls = {}

    def counted(module, name):
        fn = getattr(module, name)

        def call(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return call

    with mock.patch.multiple(tiled, build_batch=counted(tiled, "build_batch"),
                             apply_unet=counted(tiled, "apply_unet"),
                             _predict_tiles=counted(tiled, "_predict_tiles")), \
            mock.patch.object(blend, "weight_table", counted(blend, "weight_table")), \
            mock.patch.object(stitch, "stitch_tiles", counted(stitch, "stitch_tiles")):
        untraced = tiled.predict_linear_blend(model, ds, device="cpu", batch_size=batch)
        assert profiler.spans() == []
        prof = _profiled()
        traced = tiled.predict_linear_blend(model, ds, device="cpu", batch_size=batch)
        prof.stop()
    np.testing.assert_array_equal(traced, untraced)
    assert calls == {"build_batch": 2 * batches, "apply_unet": 2 * batches,
                     "_predict_tiles": 2, "weight_table": 2, "stitch_tiles": 2 * batches}

    records = profiler.spans()
    named = _by_name(records)
    assert [len(named[k]) for k in ("scene", "scene.weight_table", "scene.gather",
                                    "scene.forward", "scene.fetch")] \
        == [1, 1, batches, batches, 1]
    assert len(records) == 3 + 2 * batches
    (root, scene), = named["scene"]
    assert all(r["parent"] == root for r in records if r is not scene)
    assert "device_ms" not in scene      # a CPU scene has no device events
    (sums,) = bench_spans.totals(records, "scene")
    assert set(sums) == {"scene", "scene.weight_table", "scene.gather", "scene.forward",
                         "scene.fetch"}
    assert sum(v for k, v in sums.items() if k != "scene") <= sums["scene"]


def test_train_epoch_records_its_steps(make_geotiff, tmp_path):
    paths = _scene(make_geotiff)
    ds = TileDataset({"raster_in": paths["raster_in"], "raster_gt": paths["raster_gt"],
                      "image_list": paths["image_list"], "image_pairs": [(0, 1)],
                      "area_defn": {"x_extent": [(0, COLS - 1)],
                                    "y_extent": [(0, ROWS - 1)]},
                      "n_samples": 12},
                     input_channels="geom-stereo", tile_size=16, sampling_strategy="train",
                     dsm_std=5.0, ortho_mean=120.0, ortho_std=25.0, seed=3)
    model = tunet.init_unet(tunet.UNetConfig(**SETTINGS), torch.Generator().manual_seed(0))
    trainer = Trainer(state=init_train_state(model, "Adam", 1e-3, 1e-5),
                      train_step=make_train_step(batch_spec_for(ds)), eval_step=None,
                      train_loaders=[(device_put_dataset(ds, "cpu", include_target=True),
                                      BatchIndexIterator(ds, 4, shuffle=True, seed=1))],
                      val_loaders=[], n_epochs=1, freq_average_train_loss=2,
                      checkpoint_dir=str(tmp_path / "run"), rng_seed=5)
    prof = _profiled()
    meter = trainer.train_one_epoch(2)
    prof.stop()
    assert meter.count == 1     # step 3's metric, drained after the loop
    records = profiler.spans()
    assert [r["name"] for r in records] == ["train#6", "train#7", "train#8"]
    assert all(r["parent"] is None and not r["outlived_profile"] for r in records)
    steps = bench_spans.steps(records)
    assert [s["name"] for s in steps] == ["train#6", "train#7", "train#8"]
    gaps = [(b["start_ns"] - a["end_ns"]) / 1e6 for a, b in zip(steps, steps[1:])]
    assert min(gaps) >= 0
    assert bench_spans.step_gap_ms(records) == pytest.approx(sum(gaps) / 2)
    assert bench_spans.step_launch_ms(records) == pytest.approx(
        sum(bench_spans.host_ms(s) for s in steps) / 3)
