"""Long-horizon convergence study on the port (the port's copy of
``scripts/convergence_study.py``, its JAX arm).

    python -m resdepth_tpu_torch.studies.convergence_study gen --out DIR
        [--scene-seed 3] [--flagship]
    python -m resdepth_tpu_torch.studies.convergence_study port --out DIR
        [--seed 0] [--precision balanced16|high|default|balanced]
        [--scheduler steplr|plateau] [--epochs 300] [--samples N] [--batch N]
        [--lr X] [--remat] [--device cuda|cpu] [--flagship] [--tag TAG]
        [--init NPZ]
    python -m resdepth_tpu_torch.studies.convergence_study report --out DIR
        [--flagship]

``gen`` writes a synthetic multi-region city (``utils/synth.py``) as
GeoTIFFs, with its image and pair lists. ``port`` trains on it at the
reference hyperparameters (batch 20, Adam 2e-4 with weight decay 1e-5,
the denormalised masked L1, StepLR(200, 0.1) stepped once per validation,
validation every epoch) through ``python -m resdepth_tpu_torch.train``,
refines the test stripe with ``python -m resdepth_tpu_torch.predict``
from ``Model_best.npz``, and writes ``DIR/results/port_<tag>.json`` with
the JAX arm's keys: the val-MAE and learning-rate curves, the best val
MAE and its epoch, the final lr and the refined and initial test-stripe
MAE. ``report`` prints a markdown row per result beside the JAX
package's refined-test-MAE anchors (``ANCHORS``). ``port --init NPZ``
starts from the weights of an epoch -1 checkpoint (``model.pretrained_path``)
instead of the port's seeded init: with the JAX package's init
(``tests/_jax_draws.py init`` writes it) the two packages' runs differ in
their augmentation draws and their arithmetic.

Two protocols, the JAX script's: the toy one (depth-4 UNet, start 16, cap
128, 64-px tiles, a 256x400 scene of 5 vertical 80-px stripes, 320
samples an epoch: 16 steps) and, with ``--flagship``, the reference
operating point (depth 5, start 64, cap 512, 256-px tiles, a 1024x1280
scene, 2000 samples an epoch: 100 steps). Stripe 0 is the test stripe,
stripe 1 validates, the rest train. Pass ``--flagship`` to every command
on a directory, or none.

The JAX script's other arm trains the reference torch stack, loaded from
a checkout outside this repository; the port leaves it out.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NODATA = -9999.0
GSD = 0.25
BATCH = 20
N_EPOCHS = 300
LR, WD = 2e-4, 1e-5
STEP_SIZE, GAMMA = 200, 0.1    # fires at epoch 200 with EVALUATE_RATE 1
PLATEAU = dict(factor=0.5, patience=15, min_lr=1e-6)
EVALUATE_RATE = 1
TEST_STRIPE = 0                # test = stripe 0, val = stripe 1, train = the rest

# The JAX package's refined test-stripe MAE (m) on its TPU at these
# protocols, scene seed 3, StepLR, mean ± sample std over seeds 0-2
# (docs/CONVERGENCE.md:130-147 for the flagship; BASELINE.md:905-915 for
# the toy protocol), and the reference torch stack's toy score
# (BASELINE.md:760). A model the port trains should land inside the spread.
ANCHORS = {
    "toy": {"balanced16": (0.1603, 0.0074), "torch reference": (0.1624, None)},
    "flagship": {"balanced16": (0.0543, 0.0008), "high": (0.0540, None)},
}


@dataclasses.dataclass(frozen=True)
class Protocol:
    name: str
    rows: int
    cols: int
    tile: int
    model: dict
    n_samples: int


TOY = Protocol("toy", 256, 400, 64,
               dict(input_channels="geom-stereo", depth=4, start_kernel=16,
                    max_filter_depth=128), 320)
FLAGSHIP = Protocol("flagship", 1024, 1280, 256,
                    dict(input_channels="geom-stereo", depth=5, start_kernel=64,
                         max_filter_depth=512), 2000)


def generate_scene(out_dir: str, scene_seed: int, protocol: Protocol = TOY) -> dict:
    """The synthetic city as GeoTIFFs, its image and pair lists and
    ``scene.json`` (the JAX script's ``generate_scene``)."""
    from resdepth_tpu_torch.geo import tiff
    from resdepth_tpu_torch.utils.synth import hillshade, synth_city

    os.makedirs(out_dir, exist_ok=True)
    gt, dsm, _, _ = synth_city(protocol.rows, protocol.cols, seed=scene_seed)
    geot = (465000.0, GSD, 0.0, 5247000.0, 0.0, -GSD)

    def write(name, data):
        path = os.path.abspath(os.path.join(out_dir, name))
        tiff.write(path, data, geotransform=geot, nodata=NODATA)
        return path

    paths = {"gt": write("ground_truth_DSM.tif", gt),
             "dsm": write("initial_DSM.tif", dsm),
             "ortho_315": write("ortho_315.tif", hillshade(gt, 315)),
             "ortho_135": write("ortho_135.tif", hillshade(gt, 135))}
    with open(os.path.join(out_dir, "imagelist.txt"), "w") as f:
        f.write(paths["ortho_315"] + "\n" + paths["ortho_135"] + "\n")
    with open(os.path.join(out_dir, "pairlist.txt"), "w") as f:
        f.write("ortho_315, ortho_135\n")
    meta = {"scene_seed": scene_seed, "rows": protocol.rows, "cols": protocol.cols,
            "flagship": protocol is FLAGSHIP, "tile": protocol.tile, "paths": paths,
            "imagelist": os.path.abspath(os.path.join(out_dir, "imagelist.txt")),
            "pairlist": os.path.abspath(os.path.join(out_dir, "pairlist.txt"))}
    with open(os.path.join(out_dir, "scene.json"), "w") as f:
        json.dump(meta, f, indent=1)
    os.makedirs(os.path.join(out_dir, "results"), exist_ok=True)
    print(f"scene written to {out_dir} (seed {scene_seed})")
    return meta


def _load_scene(out_dir: str, protocol: Protocol) -> dict:
    with open(os.path.join(out_dir, "scene.json")) as f:
        scene = json.load(f)
    if scene.get("flagship", False) != (protocol is FLAGSHIP):
        raise SystemExit(f"scene at {out_dir} was generated with flagship="
                         f"{scene.get('flagship', False)}; pass --flagship "
                         "consistently for every command on this directory.")
    return scene


def refined_test_mae(pred: np.ndarray, pred_origin_col: int, gt: np.ndarray,
                     test_x: tuple) -> float:
    """Masked MAE (m) over the test stripe, whose inclusive column extent is
    ``test_x``; ``pred`` covers the scene from column ``pred_origin_col``."""
    x0, x1 = int(test_x[0]), int(test_x[1])
    gt_crop = gt[:, x0:x1 + 1].astype(np.float64)
    pred_crop = pred[:, x0 - pred_origin_col:x1 + 1 - pred_origin_col]
    valid = gt_crop != NODATA
    return float(np.abs(pred_crop[valid] - gt_crop[valid]).mean())


def stripe_maes(scene: dict, eval_dir: str) -> tuple:
    """``(refined, initial)`` test-stripe MAE (m): the predict CLI's
    ``*prediction_test_area.tif`` under ``eval_dir`` and the scene's input
    DSM, each against the ground truth over the test stripe."""
    from resdepth_tpu_torch.geo import raster as geo_raster

    pred_path = None
    for root, _dirs, files in os.walk(eval_dir):
        for name in files:
            if name.endswith("prediction_test_area.tif"):
                pred_path = os.path.join(root, name)
    if pred_path is None:
        raise RuntimeError(f"no *prediction_test_area.tif under {eval_dir}")
    pred_r = geo_raster.open_raster(pred_path)
    gt_r = geo_raster.open_raster(scene["paths"]["gt"])
    origin_col = int(round((pred_r.geotransform[0] - gt_r.geotransform[0]) / GSD))
    stripe = scene["cols"] // 5
    test_x = (TEST_STRIPE * stripe, TEST_STRIPE * stripe + stripe - 1)
    gt = np.asarray(gt_r.data)
    return (refined_test_mae(np.asarray(pred_r.data), origin_col, gt, test_x),
            refined_test_mae(np.asarray(geo_raster.open_raster(scene["paths"]["dsm"]).data),
                             0, gt, test_x))


def _run_module(module: str, config: str, device: str, tag: str) -> None:
    proc = subprocess.run([sys.executable, "-m", module, config, "--device", device],
                          cwd=REPO, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise RuntimeError(f"{module} failed for {tag}")


def train_config(scene: dict, protocol: Protocol, run_root: str, *, seed: int,
                 epochs: int, scheduler: str, precision: str, batch: int, lr: float,
                 n_samples: int, remat: bool, extra_training: dict | None = None) -> dict:
    """The JAX arm's training config (``run_jax``); ``extra_training``
    merges further ``training_settings`` keys into it (``ema_decay`` for
    ``studies/ema_study.py``)."""
    if scheduler == "steplr":
        sched = {"enabled": True, "name": "StepLR",
                 "settings": {"step_size": STEP_SIZE, "gamma": GAMMA}}
    else:
        sched = {"enabled": True, "name": "ReduceLROnPlateau", "settings": dict(PLATEAU)}
    return {
        "datasets": [{
            "name": "study",
            "raster_in": scene["paths"]["dsm"],
            "raster_gt": scene["paths"]["gt"],
            "path_image_list": scene["imagelist"],
            "path_pairlist_training": scene["pairlist"],
            "path_pairlist_validation": scene["pairlist"],
            "area_type": "train+val",
            "allocation_strategy": "5-crossval_vertical",
            "test_stripe": TEST_STRIPE,
            "n_training_samples": n_samples,
        }],
        "model": dict(protocol.model),
        "stereopair_settings": {"use_all_stereo_pairs": False,
                                "permute_images_within_pair": False},
        "training_settings": {"tile_size": protocol.tile, "batch_size": batch,
                              "n_epochs": epochs, "augment": True, "loss": "L1",
                              **(extra_training or {})},
        "optimizer": {"name": "Adam", "learning_rate": lr, "weight_decay": WD},
        "scheduler": sched,
        "general": {"evaluate_rate": EVALUATE_RATE, "save_model_rate": 10_000,
                    "random_seed": seed, "workers": 0},
        # steps_per_call only groups the batch order in the port, as the JAX
        # trainer groups it (8 steps a call, 1 under remat).
        "tpu": {"train_precision": precision, "steps_per_call": 1 if remat else 8,
                **({"remat": True} if remat else {})},
        "output": {"output_directory": os.path.join(run_root, "runs"),
                   "tboard_log_dir": os.path.join(run_root, "tb")},
    }


def run_port(out_dir: str, protocol: Protocol, *, seed: int = 0, epochs: int = N_EPOCHS,
             scheduler: str = "steplr", precision: str = "balanced16",
             device: str = "cuda", tag: str | None = None, batch: int | None = None,
             lr: float | None = None, n_samples: int | None = None,
             remat: bool = False, extra_training: dict | None = None,
             init: str | None = None) -> dict:
    """Train through the port's train CLI, refine the test stripe through
    its predict CLI, score it, and write ``results/port_<tag>.json``.
    ``extra_training`` merges further ``training_settings`` keys into the
    run's config (``{"ema_decay": 0.999}`` for the EMA study); the rest of
    the protocol stays, so the results compare with the stored ones.
    ``init``: an epoch -1 checkpoint to start from (it adds a suffix to the
    default tag; the result keeps the JAX arm's keys)."""
    import torch

    from resdepth_tpu_torch.studies.precision_study import device_name

    batch = BATCH if batch is None else int(batch)
    lr = LR if lr is None else float(lr)
    n_samples = protocol.n_samples if n_samples is None else int(n_samples)
    scene = _load_scene(out_dir, protocol)
    tag = tag or f"seed{seed}_{scheduler}_{precision}" + ("_init" if init else "")
    run_root = os.path.abspath(os.path.join(out_dir, "runs_port", tag))
    os.makedirs(run_root, exist_ok=True)

    cfg = train_config(scene, protocol, run_root, seed=seed, epochs=epochs,
                       scheduler=scheduler, precision=precision, batch=batch, lr=lr,
                       n_samples=n_samples, remat=remat, extra_training=extra_training)
    if init:
        cfg["model"]["pretrained_path"] = os.path.abspath(init)
    cfg_path = os.path.join(run_root, "config_train.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)
    start = time.time()
    _run_module("resdepth_tpu_torch.train", cfg_path, device, tag)
    train_wall = time.time() - start

    runs = os.path.join(run_root, "runs")
    run_dir = os.path.join(runs, sorted(os.listdir(runs))[-1])
    curve, lr_curve = [], []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("tag") == "val/MAE_metric":
                curve.append([int(rec["step"]), float(rec["value"])])
            elif rec.get("tag") == "val/learning_rate":
                lr_curve.append([int(rec["step"]), float(rec["value"])])

    eval_cfg = {
        "datasets": [{
            "raster_in": scene["paths"]["dsm"],
            "raster_gt": scene["paths"]["gt"],
            "path_image_list": scene["imagelist"],
            "path_pairlist": scene["pairlist"],
            "allocation_strategy": "5-crossval_vertical",
            "test_stripe": TEST_STRIPE, "area_type": "test",
        }],
        "model": {
            "weights": os.path.join(run_dir, "checkpoints", "Model_best.npz"),
            "architecture": os.path.join(run_dir, "model_config.json"),
            "normalization_geom": os.path.join(run_dir, "DSM_normalization_parameters.p"),
            "normalization_image": os.path.join(run_dir,
                                                "Image_normalization_parameters.p"),
        },
        "general": {"tile_size": protocol.tile, "workers": 0},
        "output": {"directory": os.path.join(run_root, "eval_out")},
    }
    eval_cfg_path = os.path.join(run_root, "config_test.json")
    with open(eval_cfg_path, "w") as f:
        json.dump(eval_cfg, f, indent=1)
    _run_module("resdepth_tpu_torch.predict", eval_cfg_path, device, tag)

    mae, initial = stripe_maes(scene, os.path.join(run_root, "eval_out"))

    result = {
        "side": "resdepth-tpu-torch", "tag": tag, "seed": seed,
        "scene_seed": scene["scene_seed"], "epochs": epochs,
        "scheduler": scheduler, "precision": precision,
        "batch": batch, "lr": lr, "remat": remat,
        "backend": device_name(torch.device(device)),
        "val_curve": curve, "lr_curve": lr_curve,
        "best_val_mae": min(v for _, v in curve),
        "best_epoch": min(curve, key=lambda ev: ev[1])[0],
        "final_lr": lr_curve[-1][1] if lr_curve else None,
        "refined_test_mae": mae, "initial_test_mae": initial,
        "train_wall_time_s": round(train_wall, 1),
    }
    path = os.path.join(out_dir, "results", f"port_{tag}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"[port_{tag}] best_val={result['best_val_mae']:.4f} "
          f"refined_test={mae:.4f} final_lr={result['final_lr']} -> {path}")
    return result


def report(out_dir: str, protocol: Protocol) -> list:
    """Print a markdown row per result in ``out_dir/results`` (val MAE at
    epoch marks, best val, refined test MAE, final lr), then the JAX
    package's anchors for the protocol; returns the rows' results."""
    results_dir = os.path.join(out_dir, "results")
    results = []
    for name in sorted(os.listdir(results_dir)):
        with open(os.path.join(results_dir, name)) as f:
            results.append(json.load(f))
    marks = [10, 25, 50, 100, 150, 200, 210, 250, 300]
    print("| run | backend | " + " | ".join(f"val@{m}" for m in marks)
          + " | best val | refined test MAE | final lr |")
    print("|---|---|" + "---|" * (len(marks) + 3))
    for r in results:
        curve = sorted((e, v) for e, v in r["val_curve"])
        cells = []
        for m in marks:
            past = [v for e, v in curve if e <= m - 1]   # the last val at or before the mark
            cells.append(f"{past[-1]:.4f}" if past else "—")
        final_lr = "—" if r["final_lr"] is None else f"{r['final_lr']:.1e}"
        print(f"| {r['side']} {r['tag']} ({r.get('precision', 'f32')}) | {r['backend']} | "
              + " | ".join(cells)
              + f" | {r['best_val_mae']:.4f} | {r['refined_test_mae']:.4f} | {final_lr} |")
    print(f"\nJAX package anchors, {protocol.name} protocol, refined test MAE "
          "(docs/CONVERGENCE.md, BASELINE.md):")
    for arm, (mean, std) in ANCHORS[protocol.name].items():
        print(f"  {arm}: {mean:.4f}" + ("" if std is None else f" ± {std:.4f}") + " m")
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("cmd", choices=["gen", "port", "report"])
    p.add_argument("--out", required=True)
    p.add_argument("--scene-seed", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=N_EPOCHS)
    p.add_argument("--scheduler", choices=["steplr", "plateau"], default="steplr")
    p.add_argument("--precision", default="balanced16",
                   choices=["balanced16", "high", "default", "balanced"])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--tag", default=None)
    p.add_argument("--flagship", action="store_true",
                   help="the reference operating point: depth-5/start-64/256-px on "
                        "a 1024x1280 scene, 2000 samples an epoch")
    p.add_argument("--samples", type=int, default=None, help="samples an epoch")
    p.add_argument("--batch", type=int, default=None, help="training batch size")
    p.add_argument("--lr", type=float, default=None, help="the Adam learning rate")
    p.add_argument("--remat", action="store_true", help="set tpu.remat")
    p.add_argument("--init", default=None,
                   help="start from this epoch -1 checkpoint's weights")
    args = p.parse_args(argv)
    protocol = FLAGSHIP if args.flagship else TOY
    if args.cmd == "gen":
        generate_scene(args.out, args.scene_seed, protocol)
    elif args.cmd == "port":
        run_port(args.out, protocol, seed=args.seed, epochs=args.epochs,
                 scheduler=args.scheduler, precision=args.precision,
                 device=args.device, tag=args.tag, batch=args.batch, lr=args.lr,
                 n_samples=args.samples, remat=args.remat, init=args.init)
    else:
        report(args.out, protocol)


if __name__ == "__main__":
    main()
