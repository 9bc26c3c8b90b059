"""A run's ``correct`` on the CPU at tiny sizes: true for the program as
it is, false with each fault of ``faults.py`` the cell can have planted
underneath its timed path. The harness's look for a card is skipped: the
drivers run on the CPU, where the port runs its kernels' plain versions.

The limits here are the tiny size's, not the cells': set from sound tiny
runs (serving mean gap 0.8 mm, widest 9 mm; the CLI's 1.4e-5 and 9.2e-5
m, statistics 3.1e-5 m; training loss gaps 2.8e-4 and 2.5e-4, input 0,
gradient 0.025, change 0.048, BatchNorm statistics 2.6e-4) with room
above, and far below what each fault reads."""

import copy
import time

import pytest
import torch

from benchmark import faults, harness, run

TINY_MODEL = dict(depth=3, start_kernel=8, max_filter_depth=16)
TINY_LIMITS = {
    "serve_resident": {"mean_dev_m": 3e-3, "max_dev_m": 3e-2},
    "cli_scene": {"mean_dev_m": 1e-4, "max_dev_m": 1e-3, "residual_max_dev_m": 1e-3,
                  "stats_max_dev_m": 1e-3},
    "train_epochs": {"loss_gap.2": 1e-3, "loss_gap.3": 1e-3,
                     "input_max_gap": 1e-4,
                     "grad_gap": 0.05, "change_gap": 0.2, "bn_stats_gap": 0.05},
}
CELLS = ["stereo.serve.balanced16", "zero.serve.balanced", "stereo.train.balanced16",
         "stereo.cli.float32"]


def tiny_run(cell: str, fault: str | None = None) -> dict:
    plan = run.cell_plan(run.read_json(f"{run.ROOT}/BENCHMARK.json"), cell)
    config = copy.deepcopy(plan["config"])
    config["model"].update(TINY_MODEL)
    config["general"].update(tile_size=32, tile_stride=16)
    config["training_settings"].update(tile_size=32, batch_size=4, n_training_samples=20)
    traffic = dict(plan["traffic"], scene=96, batch=4, profile_steps=2)
    driver = traffic["driver"]
    module = run.driver_of(plan)
    ctx = harness.Context(config=config, traffic=traffic,
                          limits=TINY_LIMITS[driver], seed=2 ** 31 + 99, seconds=0.5,
                          trace=False, device=torch.device("cpu"),
                          started=time.perf_counter())
    if fault is None:
        return module.run(ctx)
    with faults.planted(driver, fault):
        return module.run(ctx)


def correct(record: dict) -> bool:
    return run.result_line(record, {}, {})["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    record = tiny_run(cell)
    assert correct(record), record["checks"]


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in CELLS
    for fault in faults.OF_DRIVER[run.cell_plan(run.read_json(f"{run.ROOT}/BENCHMARK.json"),
                                                cell)["traffic"]["driver"]]])
def test_fault_is_caught(cell, fault):
    record = tiny_run(cell, fault)
    assert not correct(record), (fault, record["checks"])
