"""Combinatorial CLI smoke: random valid train and inference configs on tiny
scenes (the port's copy of ``scripts/config_smoke.py``).

    python -m resdepth_tpu_torch.studies.config_smoke [seed] [n_cases]
        [--device cuda] [--root config_smoke]

Samples configurations across the supported option space with the JAX
script's ``np.random.default_rng(seed)`` draws, in its order (channel
modes x allocations x crossval x schedulers x optimizers x train
precisions x ``steps_per_call`` x augment/permute x weight EMA x
transpose/bilinear x BatchNorm and activations x tiles 16/32, then serving
dtypes x strides x TTA), and drives each case through the port's CLIs in
child processes: ``python -m resdepth_tpu_torch.train`` (2 epochs), then,
unless the case trains cross-validation only, ``python -m
resdepth_tpu_torch.predict`` on ``Model_best.npz``. The models are narrow
(start 4, cap 8, depth 2 on 16-px tiles or 3 on 32-px ones), so on the
card K3 meets 4 and 8 output channels and images down to 4x4, and the
stitch kernels 16-px windows. Each case's scene, configs and runs are
under ``--root/case<i>`` (emptied first). Exits non-zero on any CLI
failure.

On the CPU: ``python -m resdepth_tpu_torch.studies.config_smoke 0 2
--device cpu`` (a few seconds a case).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CASE_TIMEOUT = 600
GEOTRANSFORM = (1000.0, 0.25, 0, 2000.0, 0, -0.25)


def scene(root, dirname, rng, rows=80, cols=100, n_images=4):
    from resdepth_tpu_torch.geo import tiff

    d = os.path.join(root, dirname)
    os.makedirs(d, exist_ok=True)
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float32)
    gt = 400.0 + 5.0 * np.sin(yy / 9.0) + 4.0 * np.cos(xx / 11.0)
    dsm = (gt + rng.normal(0.0, 0.8, (rows, cols))).astype(np.float32)
    paths = {}
    for name, data in (("dsm", dsm), ("gt", gt.astype(np.float32))):
        p = os.path.join(d, f"{name}.tif")
        tiff.write(p, data, geotransform=GEOTRANSFORM, nodata=-9999.0)
        paths[name] = p
    imgs = []
    for j in range(n_images):
        p = os.path.join(d, f"ortho_{j}.tif")
        tiff.write(p, rng.normal(120, 25, (rows, cols)).astype(np.float32),
                   geotransform=GEOTRANSFORM, nodata=-9999.0)
        imgs.append(p)
    il = os.path.join(d, "imagelist.txt")
    with open(il, "w") as f:
        f.write("\n".join(imgs) + "\n")
    return d, paths, il


def sample_config(i, rng, root):
    """Case ``i``'s scene (written under ``root``) and train config, from
    ``rng`` in the JAX script's order of draws."""
    channels = rng.choice(["geom", "geom-mono", "geom-stereo",
                           "geom-multiview", "stereo"])
    alloc = rng.choice(["5-crossval_vertical", "5-crossval_horizontal"])
    crossval = bool(rng.integers(0, 2))
    # tile 16 on the 80x100 scene (5-stripe splits give 16/20-px stripes,
    # the smallest of which exactly admits a 16-px tile) forces depth 2;
    # tile 32 doubles the scene so that the narrowest stripe (32 px) admits
    # the tile, and allows depth 3 (tile >= 2^(depth+2)).
    if rng.integers(0, 2):
        depth, tile = 2, 16
        d, paths, il = scene(root, f"case{i}", rng)
    else:
        depth, tile = 3, 32
        d, paths, il = scene(root, f"case{i}", rng, rows=160, cols=200)
    sched = rng.choice(["none", "StepLR", "ExponentialLR", "ReduceLROnPlateau"])
    opt = rng.choice(["Adam", "SGD"])

    if channels == "geom-mono":
        pair_lines = ["ortho_0"]    # mono takes one pairlist line of one image
    elif channels == "geom-multiview":
        pair_lines = ["ortho_0, ortho_1, ortho_2"]
    else:
        pair_lines = ["ortho_0, ortho_1", "ortho_1, ortho_2"]
    pl = os.path.join(d, "pairs.txt")
    with open(pl, "w") as f:
        f.write("\n".join(pair_lines) + "\n")

    ds = {
        "name": f"case{i}", "raster_in": paths["dsm"], "raster_gt": paths["gt"],
        "area_type": "train+val",
        "allocation_strategy": alloc, "test_stripe": int(rng.integers(0, 5)),
        "n_training_samples": 16, "crossval_training": crossval,
    }
    if channels != "geom":
        ds.update(path_image_list=il, path_pairlist_training=pl,
                  path_pairlist_validation=pl)
    cfg = {
        "datasets": [ds],
        "model": {"input_channels": str(channels), "depth": depth,
                  "outer_skip": channels != "stereo",
                  "start_kernel": 4, "max_filter_depth": 8,
                  "up_mode": str(rng.choice(["transpose", "bilinear"])),
                  "do_BN": bool(rng.integers(0, 2)),
                  "act_fn_encoder": str(rng.choice(["relu", "lrelu", "prelu"]))},
        "stereopair_settings": {
            "use_all_stereo_pairs": bool(rng.integers(0, 2)),
            "permute_images_within_pair": bool(rng.integers(0, 2))},
        "training_settings": {"tile_size": tile, "batch_size": int(rng.choice([3, 4])),
                              "n_epochs": 2, "augment": bool(rng.integers(0, 2)),
                              "loss": "L1"},
        "optimizer": {"name": str(opt), "learning_rate": 0.001,
                      "weight_decay": 1e-5},
        "general": {"save_model_rate": 2, "evaluate_rate": 1, "random_seed": i,
                    "auto_resume": False},
        "tpu": {"steps_per_call": int(rng.choice([1, 4])),
                "train_precision": str(rng.choice(
                    ["high", "default", "balanced", "balanced16"]))},
        "output": {"output_directory": os.path.join(d, "runs")},
    }
    if rng.integers(0, 2):
        cfg["training_settings"]["ema_decay"] = 0.99
    if channels == "geom-multiview":
        cfg["multiview"] = {"config": "3-view"}
    if sched == "none":
        cfg["scheduler"] = {"enabled": False}
    elif sched == "StepLR":
        cfg["scheduler"] = {"enabled": True, "name": "StepLR",
                            "settings": {"step_size": 1, "gamma": 0.7}}
    elif sched == "ExponentialLR":
        cfg["scheduler"] = {"enabled": True, "name": "ExponentialLR",
                            "settings": {"gamma": 0.9}}
    else:
        cfg["scheduler"] = {"enabled": True, "name": "ReduceLROnPlateau",
                            "settings": {"factor": 0.5, "patience": 1}}
    return d, cfg, str(channels), crossval, pl, il


def eval_config(cfg, d, channels, run_dir, pl, il, rng) -> dict:
    """The inference config of a trained case, with the JAX script's draws
    of the serving dtype, the stride and the TTA."""
    ds = cfg["datasets"][0]
    eval_ds = {"name": ds["name"], "raster_in": ds["raster_in"], "raster_gt": ds["raster_gt"],
               "allocation_strategy": ds["allocation_strategy"],
               "test_stripe": ds["test_stripe"], "area_type": "test"}
    if channels != "geom":
        with open(pl) as f:
            single = f.readline().strip()
        pl_test = os.path.join(d, "pairs_test.txt")
        with open(pl_test, "w") as f:
            f.write(single + "\n")
        eval_ds.update(path_image_list=il, path_pairlist=pl_test)
    tile = cfg["training_settings"]["tile_size"]
    out = {
        "datasets": [eval_ds],
        "model": {
            "weights": os.path.join(run_dir, "checkpoints", "Model_best.npz"),
            "architecture": os.path.join(run_dir, "model_config.json"),
            "normalization_geom": os.path.join(run_dir,
                                               "DSM_normalization_parameters.p"),
        },
        "general": {"tile_size": tile,
                    "compute_dtype": str(rng.choice(
                        ["float32", "bfloat16", "mixed", "balanced", "balanced16"]))},
        "output": {"directory": os.path.join(d, "eval")},
    }
    # non-default strides reshape the blend ramps and the stitch windows
    if rng.integers(0, 2):
        out["general"]["tile_stride"] = int(rng.choice([3 * tile // 4, tile]))
    # the transformed replicas change the predictor's batches
    if rng.integers(0, 2):
        out["general"]["tta"] = int(rng.choice([2, 4, 8]))
    if channels != "geom":
        out["model"]["normalization_image"] = os.path.join(
            run_dir, "Image_normalization_parameters.p")
    return out


def run_child(module: str, config_path: str, device: str) -> tuple:
    """``python -m module config --device device`` in a child process:
    ``(return code, the end of its output)``."""
    proc = subprocess.run([sys.executable, "-m", module, config_path, "--device", device],
                          cwd=REPO, capture_output=True, text=True, timeout=CASE_TIMEOUT)
    return proc.returncode, (proc.stdout + proc.stderr)[-1200:]


def run_in_process(module: str, config_path: str, device: str) -> tuple:
    """The CLI's ``main([config, "--device", device])`` in this process (so
    that the kernels' launch counters see its launches): ``(return code,
    the end of its output)``, the code 1 for an exception, whose traceback
    is the output."""
    import contextlib
    import importlib
    import io
    import traceback

    main = importlib.import_module(module + (".cli" if module.endswith(".train") else "")).main
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        try:
            main([config_path, "--device", device])
        except SystemExit as exc:
            code = exc.code if isinstance(exc.code, int) else 1
        except Exception:   # a case's failure is reported, and the next case runs
            traceback.print_exc()
            code = 1
    return code, out.getvalue()[-1200:]


def run_cases(seed: int, n_cases: int, root: str, device: str, run=run_child) -> dict:
    """Sample and run ``n_cases`` cases under ``root`` (emptied first);
    ``run(module, config_path, device) -> (code, output)`` runs one CLI.
    Returns ``{"cases": [...], "fails": n}``, each case with its configs
    and outcome."""
    root = os.path.abspath(root)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(seed)
    cases, fails = [], 0
    for i in range(n_cases):
        d, cfg, channels, crossval, pl, il = sample_config(i, rng, root)
        cfg_path = os.path.join(d, "train.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        tag = (f"case{i} ch={channels} alloc={cfg['datasets'][0]['allocation_strategy'][-8:]} "
               f"cv={crossval} sched={cfg['scheduler'].get('name', 'off')} "
               f"opt={cfg['optimizer']['name']} K={cfg['tpu']['steps_per_call']} "
               f"prec={cfg['tpu']['train_precision']} depth={cfg['model']['depth']} "
               f"tile={cfg['training_settings']['tile_size']} "
               f"ema={cfg['training_settings'].get('ema_decay', 'off')} "
               f"up={cfg['model']['up_mode']} bn={cfg['model']['do_BN']}")
        case = {"tag": tag, "train": cfg, "eval": None, "ok": False}
        cases.append(case)
        code, output = run("resdepth_tpu_torch.train", cfg_path, device)
        if code != 0:
            fails += 1
            print("TRAIN FAIL", tag)
            print(output)
            continue
        runs = os.path.join(d, "runs")
        run_dir = os.path.join(runs, sorted(os.listdir(runs))[0])
        if crossval:
            case["ok"] = True
            print("ok (train-only, crossval)", tag, flush=True)
            continue
        ev = eval_config(cfg, d, channels, run_dir, pl, il, rng)
        case["eval"] = ev
        ev_path = os.path.join(d, "eval.json")
        with open(ev_path, "w") as f:
            json.dump(ev, f)
        served = (f"dtype: {ev['general']['compute_dtype']} stride: "
                  f"{ev['general'].get('tile_stride', 'default')} tta: "
                  f"{ev['general'].get('tta', 1)}")
        code, output = run("resdepth_tpu_torch.predict", ev_path, device)
        if code != 0:
            fails += 1
            print("EVAL FAIL", tag, served)
            print(output)
            continue
        case["ok"] = True
        print("ok", tag, served, flush=True)
    print(f"combo smoke: {n_cases - fails}/{n_cases} passed")
    return {"cases": cases, "fails": fails}


def main(argv=None) -> int:
    from resdepth_tpu_torch import predict

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("seed", type=int, nargs="?", default=0)
    ap.add_argument("n_cases", type=int, nargs="?", default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--root", default="config_smoke",
                    help="directory of the cases' scenes and runs (emptied first)")
    args = ap.parse_args(argv)
    predict.resolve_device(args.device)   # no card: fail before any case
    result = run_cases(args.seed, args.n_cases, args.root, args.device)
    return 1 if result["fails"] else 0


if __name__ == "__main__":
    sys.exit(main())
