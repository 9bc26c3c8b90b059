"""A data-parallel training run stopped and resumed under ``auto_resume``
is the run that was never stopped, bit for bit (CPU, gloo).

Three worlds of 2 processes of ``python -m resdepth_tpu_torch.train``
(``parallel.bootstrap.run_world``, its launch and timeout), augmentation
and view permutation on, a checkpoint after every epoch from the third on
(``save_model_rate`` 1, as the reference trainer saves
``Model_after_{N}_epochs.npz``):

* 4 epochs without interruption;
* its twin, stopped once the chief has written ``Model_after_3_epochs.npz``
  (the file is the stop point), while it trains epoch 3;
* the twin again with ``general.auto_resume`` for the one epoch left. It
  continues from the stopped run's newest checkpoint: weights, BatchNorm
  statistics, Adam moments and count, the scheduler, the best loss, the
  host streams replayed to epoch 3 and the per-epoch augmentation seeds.

Its ``Model_last.npz`` equals the uninterrupted run's bitwise (weights,
BatchNorm statistics, Adam moments and count, learning rate and scheduler
state, losses), and so do the val MAE of each epoch.
"""

import glob
import json
import os
import sys

import numpy as np

import chip_smoke
from resdepth_tpu_torch.models import weights
from resdepth_tpu_torch.train import checkpoint as tckpt
from test_torch_parallel import run_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = [sys.executable, "-m", "resdepth_tpu_torch.train"]
EPOCHS = 4
STEPS = 24                   # an epoch: 96 samples at batch 4


def _config(work, scene, root, suffix, n_epochs, auto_resume=False):
    return chip_smoke.write_train_config(
        os.path.join(work, f"{os.path.basename(root)}_{suffix}.json"), scene["paths"], root,
        n_samples=96, suffix=suffix, model=dict(depth=2, start_kernel=4, max_filter_depth=8),
        training={"tile_size": 16, "batch_size": 4, "n_epochs": n_epochs, "augment": True},
        stereopair_settings={"use_all_stereo_pairs": True,
                             "permute_images_within_pair": True},
        optimizer={"name": "Adam", "learning_rate": 1e-3},
        scheduler={"enabled": True, "name": "StepLR",
                   "settings": {"step_size": 1, "gamma": 0.5}},
        general={"save_model_rate": 1, "evaluate_rate": 1, "random_seed": 3,
                 "auto_resume": auto_resume},
        tpu={"data_parallel": True})


def _val(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return [(r["step"], r["value"]) for r in lines if r.get("tag") == "val/MAE_metric"]


def _stopped_after(config: str, root: str, epochs: int) -> str:
    """Run a world of ``config`` and stop its ranks as soon as the chief
    has written ``Model_after_{epochs}_epochs.npz``; returns the run
    directory."""
    pattern = os.path.join(root, "*", "checkpoints", f"Model_after_{epochs}_epochs.npz")
    run_world(TRAIN + [config, "--device", "cpu"], cwd=REPO,
              until=lambda: bool(glob.glob(pattern)))
    run_dir = os.path.dirname(os.path.dirname(glob.glob(pattern)[0]))
    assert not os.path.exists(os.path.join(run_dir, "checkpoints", "Model_last.npz"))
    return run_dir


def test_resumed_world_is_the_uninterrupted_world(tmp_path):
    work = str(tmp_path)
    scene = chip_smoke.write_scene(os.path.join(work, "scene"), 96, 96)
    whole_root, twin_root = os.path.join(work, "whole"), os.path.join(work, "twin")
    run_world(TRAIN + [_config(work, scene, whole_root, "dp", EPOCHS), "--device", "cpu"],
              cwd=REPO)
    whole = chip_smoke.run_dir_of(whole_root, "dp")
    stopped = _stopped_after(_config(work, scene, twin_root, "dp", EPOCHS), twin_root,
                             EPOCHS - 1)
    outputs = run_world(TRAIN + [_config(work, scene, twin_root, "resumed", 1,
                                         auto_resume=True), "--device", "cpu"], cwd=REPO)
    resumed = chip_smoke.run_dir_of(twin_root, "resumed")
    assert (f"auto_resume: continuing from "
            f"{os.path.join(stopped, 'checkpoints', f'Model_after_{EPOCHS - 1}_epochs.npz')}"
            in outputs[0])

    assert _val(whole) == _val(stopped)[:EPOCHS - 1] + _val(resumed)
    assert [e for e, _ in _val(whole)] == list(range(EPOCHS))
    got, want = (tckpt.load_checkpoint(os.path.join(run, "checkpoints", "Model_last.npz"))
                 for run in (resumed, whole))
    assert got["meta"] == want["meta"] and want["meta"]["epoch"] == EPOCHS - 1
    assert got["meta"]["scheduler_state"]["n_steps"] == EPOCHS
    for tree in ("params", "bn_state"):
        a, b = weights.flatten_keystr(got[tree]), weights.flatten_keystr(want[tree])
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{tree}{key}")
    (got_mu, got_nu, got_count), (mu, nu, count) = got["adam"], want["adam"]
    assert got_count == count == EPOCHS * STEPS
    for got_tree, want_tree in ((got_mu, mu), (got_nu, nu)):
        a, b = weights.flatten_keystr(got_tree), weights.flatten_keystr(want_tree)
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
