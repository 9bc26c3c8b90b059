"""The readers of the program's spans (``benchmark/spans.py`` and the nine
metrics over it) on hand-made span stores: each reader's value, and None
on an empty store and on a program without ``profiler.spans``."""

import os

import pytest

from benchmark import run, spans

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READERS = ("scene_weight_table_ms", "scene_gather_ms", "scene_forward_ms",
           "scene_fetch_ms", "step_launch_ms", "step_gap_ms", "cli_read_s",
           "cli_model_s", "cli_infer_s")


def reader(name):
    return run.load_file(os.path.join(BENCH, "metrics", f"{name}.py"), f"test_{name}")


class Store:
    """Records as ``profiler.spans`` gives them, in entry order."""

    def __init__(self):
        self.records = []

    def add(self, name, start_ms, end_ms, parent=None, device_ms=None,
            outlived=False):
        index = len(self.records)
        record = {"name": name, "start_ns": int(start_ms * 1e6),
                  "end_ns": None if end_ms is None else int(end_ms * 1e6),
                  "parent": parent, "outlived_profile": outlived}
        if device_ms is not None:
            record["device_ms"] = device_ms
        self.records.append(record)
        return index


def scenes() -> Store:
    """Two scenes of two batches, then an open scene and a stray gather."""
    s = Store()
    for t0, table, gathers, forwards, fetch in (
            (0, 30.0, (4.0, 6.0), (100.0, 120.0), 31.0),
            (300, 20.0, (8.0, 2.0), (110.0, 130.0), 29.0)):
        root = s.add("scene", t0, t0 + 280)
        s.add("scene.weight_table", t0, t0 + table, root)
        for g, f in zip(gathers, forwards):
            s.add("scene.gather", t0 + 40, t0 + 41, root, device_ms=g)
            s.add("scene.forward", t0 + 41, t0 + 42, root, device_ms=f)
        s.add("scene.fetch", t0 + 200, t0 + 240, root, device_ms=fetch)
    open_root = s.add("scene", 700, None)
    s.add("scene.weight_table", 700, 800, open_root)
    s.add("scene.gather", 900, 901, device_ms=1e3)
    return s


def steps() -> Store:
    """Steps 1-3; the profiler stopped inside step 3."""
    s = Store()
    s.add("train#1", 0, 40)
    s.add("train#2", 50, 85)
    s.add("train#3", 95, 1095, outlived=True)
    return s


def cli_runs() -> Store:
    """Two CLI runs, a scene's spans under the inference of each."""
    s = Store()
    for t0, read, model, infer, fetch in ((0, (100, 200), 300, 500, 100),
                                          (20000, (150, 250), 500, 700, 100)):
        root = s.add("cli.run", t0, t0 + 12000)
        s.add("cli.read", t0 + 10, t0 + 10 + read[0], root)
        s.add("cli.model", t0 + 1000, t0 + 1000 + model, root)
        s.add("cli.read", t0 + 2000, t0 + 2000 + read[1], root)
        inf = s.add("cli.infer", t0 + 3000, t0 + 3000 + infer, root)
        scene = s.add("scene", t0 + 3000, t0 + 3000 + infer - 1, inf)
        s.add("scene.weight_table", t0 + 3000, t0 + 3030, scene)
        s.add("cli.fetch", t0 + 4000, t0 + 4000 + fetch, root)
    return s


CASES = {"scene_weight_table_ms": (scenes, 25.0),
         "scene_gather_ms": (scenes, 10.0),
         "scene_forward_ms": (scenes, 230.0),
         "scene_fetch_ms": (scenes, 30.0),
         "step_launch_ms": (steps, 37.5),
         "step_gap_ms": (steps, 10.0),
         "cli_read_s": (cli_runs, 0.35),
         "cli_model_s": (cli_runs, 0.4),
         "cli_infer_s": (cli_runs, 0.7)}


@pytest.fixture
def store(monkeypatch):
    from resdepth_tpu_torch.utils import profiler

    held = []
    monkeypatch.setattr(profiler, "spans", lambda: list(held))
    return held


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_its_spans(store, name):
    make, want = CASES[name]
    store.extend(make().records)
    assert reader(name).read({}) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_in_an_empty_store(store, name):
    assert reader(name).read({}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_in_a_program_without_spans(monkeypatch, name):
    from resdepth_tpu_torch.utils import profiler

    monkeypatch.delattr(profiler, "spans")
    assert spans.records() == []
    assert reader(name).read({}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_in_another_layers_spans(store, name):
    """A cell's store holds its own layer's spans: the serving readers find
    nothing among steps, the step readers nothing among scenes."""
    other = {scenes: steps, steps: cli_runs, cli_runs: steps}[CASES[name][0]]
    store.extend(other().records)
    assert reader(name).read({}) is None


def test_totals_sum_by_name_under_each_closed_root():
    records = scenes().records
    host = spans.totals(records, "scene")
    assert len(host) == 2 and host[0]["scene.weight_table"] == pytest.approx(30.0)
    assert host[0]["scene"] == pytest.approx(280.0)
    device = spans.totals(records, "scene", device=True)
    assert device[1] == pytest.approx({"scene.gather": 10.0, "scene.forward": 240.0,
                                       "scene.fetch": 29.0})
    under_cli = spans.totals(cli_runs().records, "cli.run")
    assert under_cli[0]["scene.weight_table"] == pytest.approx(30.0)
    assert under_cli[1]["cli.read"] == pytest.approx(400.0)
