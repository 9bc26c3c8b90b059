"""Dihedral test-time augmentation (``general.tta``): accuracy and cost (the
port's copy of ``scripts/tta_study.py``).

``general.tta`` averages (or takes the median of) each tile's predictions
under a dihedral subgroup of 1, 2, 4 or 8 symmetries: tta x the model's
work for a potential accuracy gain on the refined-DSM MAE.

Mode A (``--conv-dir``): the port's convergence-study checkpoints
(``studies/convergence_study.py port``, ``DIR/runs_port/<tag>/``) served
again through ``python -m resdepth_tpu_torch.predict`` in a child process
at every tta, with ``--merge``; each run's refined test-stripe MAE,
printed beside the JAX package's scores of the same protocol
(``docs/studies/tta/tta_conv_results*.json``, toy protocol) and the
reference torch stack's (``docs/studies/convergence/torch_seed*_steplr.json``),
and written to ``OUT/tta_conv_results[_median].json``:

    python -m resdepth_tpu_torch.studies.tta_study --conv-dir DIR --out OUT
        [--tags seed0_steplr_balanced16 ...] [--merge mean|median]
        [--device cuda]

Mode B (``--state-cache``): the trained model of
``studies/precision_study.py --state-cache`` refines a seeded 2048^2 city
at every tta (``predict_linear_blend``, stride tile/2, K2 on the card);
refined MAE, scene seconds with rasters resident (CUDA events on the card,
best of 3 after a warm-up; host clock on the CPU) and the deviation from
tta 1:

    python -m resdepth_tpu_torch.studies.tta_study --state-cache S.npz
        [--device cuda] [--rows 2048] [--cols 2048] [--scene-seed 3]
        [--mode balanced16] [--stitch k2|k1] [--tile 256] [--depth 5]
        [--start-kernel 64] [--json OUT.json]

On the CPU: mode A on a directory of ``convergence_study port --device
cpu --epochs 2 --samples 40`` runs with ``--device cpu``; mode B from the
smoke model's cache with ``--device cpu --tile 32 --depth 2
--start-kernel 4 --rows 128 --cols 128``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ANCHORS = os.path.join(REPO, "docs", "studies")
TTA_COUNTS = (1, 2, 4, 8)
DEFAULT_TAGS = ("seed0_steplr_balanced16", "seed1_steplr_balanced16",
                "seed2_steplr_balanced16")


# ------------------------- mode A: conv checkpoints ------------------------ #

def stored_scores(merge: str) -> tuple:
    """The JAX package's TTA table by tag and tta (toy protocol, its TPU)
    and the reference torch stack's refined test MAEs, from the repo's
    study records."""
    name = "tta_conv_results.json" if merge == "mean" else f"tta_conv_results_{merge}.json"
    path = os.path.join(ANCHORS, "tta", name)
    jax_table = {}
    if os.path.exists(path):
        with open(path) as f:
            jax_table = json.load(f)["table"]
    torch_maes = []
    for p in sorted(glob.glob(os.path.join(ANCHORS, "convergence",
                                           "torch_seed*_steplr.json"))):
        with open(p) as f:
            torch_maes.append(json.load(f)["refined_test_mae"])
    return jax_table, torch_maes


def run_conv_mode(conv_dir: str, out_dir: str, tags, merge: str = "mean",
                  device: str = "cuda") -> dict:
    from resdepth_tpu_torch.studies import convergence_study as cs

    with open(os.path.join(conv_dir, "scene.json")) as f:
        scene = json.load(f)
    initial = None

    os.makedirs(out_dir, exist_ok=True)
    table: dict = {}
    for tag in tags:
        with open(os.path.join(conv_dir, "runs_port", tag, "config_test.json")) as f:
            base_cfg = json.load(f)
        table[tag] = {}
        for tta in TTA_COUNTS:
            cfg = json.loads(json.dumps(base_cfg))
            cfg["general"]["tta"] = tta
            if merge != "mean":
                cfg["general"]["tta_merge"] = merge
            mtag = f"{tag}_tta{tta}" + ("" if merge == "mean" else f"_{merge}")
            eval_dir = os.path.abspath(os.path.join(out_dir, mtag))
            cfg["output"]["directory"] = eval_dir
            cfg_path = os.path.join(out_dir, f"config_{mtag}.json")
            with open(cfg_path, "w") as f:
                json.dump(cfg, f, indent=1)
            proc = subprocess.run([sys.executable, "-m", "resdepth_tpu_torch.predict",
                                   os.path.abspath(cfg_path), "--device", device],
                                  cwd=REPO, capture_output=True, text=True)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-3000:])
                raise RuntimeError(f"the predict CLI failed: {tag} tta={tta}")
            mae, initial = cs.stripe_maes(scene, eval_dir)
            table[tag][tta] = mae
            print(f"[{tag}] tta={tta}: refined test MAE {mae:.4f} m", flush=True)

    jax_table, torch_maes = stored_scores(merge)
    print(f"\nscene {scene['rows']}x{scene['cols']} (seed {scene['scene_seed']}), held-out "
          f"stripe {cs.TEST_STRIPE}, merge {merge}; initial MAE {initial:.4f} m")
    print(f"{'run':>34s}" + "".join(f"{'tta=' + str(t):>10s}" for t in TTA_COUNTS)
          + f"{'d8(cm)':>9s}")
    for tag, row in table.items():
        rows = [("port " + tag, row)]
        if not scene.get("flagship") and tag in jax_table:
            rows.append(("JAX (TPU) " + tag, {int(k): v for k, v in jax_table[tag].items()}))
        for label, r in rows:
            print(f"{label:>34s}" + "".join(f"{r[t]:10.4f}" for t in TTA_COUNTS)
                  + f"{(r[8] - r[1]) * 100:+9.2f}")
    if torch_maes and not scene.get("flagship"):
        print(f"{'torch reference (mean of ' + str(len(torch_maes)) + ')':>34s}"
              f"{np.mean(torch_maes):10.4f}")
    result = {"initial_mae": initial, "merge": merge, "table": table,
              "torch_refined_maes": torch_maes}
    name = ("tta_conv_results.json" if merge == "mean"
            else f"tta_conv_results_{merge}.json")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(result, f, indent=1)
    return result


# ------------------------ mode B: the state cache -------------------------- #

def run_flagship_mode(args) -> dict:
    from resdepth_tpu_torch.data.pipeline import device_put_dataset
    from resdepth_tpu_torch.infer.tiled import predict_linear_blend
    from resdepth_tpu_torch.studies import stride_study as ss
    from resdepth_tpu_torch.studies.precision_study import device_name, make_city

    device, dtype, use_pallas, served = ss.setup(args)
    clock = ss.time_key(device)
    results = {}
    with tempfile.TemporaryDirectory(prefix="tta_study_") as work:
        city = make_city(work, args.rows, args.cols, args.scene_seed)
        gt = city["gt"]
        valid = gt != -9999.0
        ds = ss.test_dataset(city, args.tile)
        rasters = device_put_dataset(ds, device)
        for tta in TTA_COUNTS:
            def run():
                return predict_linear_blend(served, ds, device=device,
                                            batch_size=args.batch_size,
                                            compute_dtype=dtype, rasters=rasters,
                                            use_pallas=use_pallas, fold_bn=False,
                                            as_numpy=False, tta=tta)

            pred, seconds = ss.scene_seconds(run, device)
            pred = pred.cpu().numpy()
            mae = float(np.abs(pred - gt)[valid].mean())
            results[tta] = (mae, seconds, pred)
            print(f"[tta {tta}] {clock} {seconds:8.4f} s/scene, MAE {mae:.4f} m",
                  flush=True)
    mae_in = float(np.abs(city["dsm_in"] - gt)[valid].mean())
    base_mae, base_t, base_pred = results[1]
    print(f"\nscene {args.rows}x{args.cols} (seed {args.scene_seed}), mode {args.mode}, "
          f"{len(ds)} tiles, {device_name(device)}; input MAE {mae_in:.3f} m")
    print(f"{'tta':>4s} {clock:>9s} {'cost':>6s} {'MAE(m)':>8s} {'dMAE(cm)':>9s} "
          f"{'dev-vs-1(cm)':>13s}")
    cells = []
    for tta in TTA_COUNTS:
        mae, t, pred = results[tta]
        dev = float(np.abs(pred - base_pred)[valid].mean()) * 100
        cells.append({"tta": tta, clock: t, "mae_m": mae, "dev_vs_1_cm": dev})
        print(f"{tta:4d} {t:9.4f} {t / base_t:5.2f}x {mae:8.4f} "
              f"{(mae - base_mae) * 100:+9.3f} {dev:13.3f}")
    out = {"device": device_name(device), "mode": args.mode, "stitch": args.stitch,
           "rows": args.rows, "cols": args.cols, "tiles": len(ds), "input_mae": mae_in,
           "cells": cells}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


def main(argv=None) -> dict:
    from resdepth_tpu_torch.studies import stride_study as ss

    argv = sys.argv[1:] if argv is None else list(argv)
    if "--state-cache" in argv:
        ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
        ss.add_common_arguments(ap)
        return run_flagship_mode(ap.parse_args(argv))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--conv-dir", required=True,
                    help="a studies/convergence_study.py directory with port runs")
    ap.add_argument("--out", required=True, help="directory of the re-served runs")
    ap.add_argument("--tags", nargs="+", default=list(DEFAULT_TAGS))
    ap.add_argument("--merge", default="mean", choices=("mean", "median"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    return run_conv_mode(args.conv_dir, args.out, args.tags, args.merge, args.device)


if __name__ == "__main__":
    main()
