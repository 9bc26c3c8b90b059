"""The golden pipeline at several ``random_seed``s through the port's
CLIs: how far apart its refined DSMs land from seed to seed.

    python -m resdepth_tpu_torch.studies.golden_spread --out spread.json
        [--seeds 0 1 2 3 4] [--device cuda|cpu]

For each seed, in a temporary directory: the golden scene and configs of
``make_demo_data.write_golden_scene`` (byte for byte the JAX script's), the
train config's ``general.random_seed`` set to the seed, ``python -m
resdepth_tpu_torch.train``, then ``python -m resdepth_tpu_torch.predict``
on ``Model_best.npz``, as ``make_demo_goldens.py`` runs them, on
``--device`` (default: the card). The JSON holds, a seed, the refined
DSM's overall MAE, RMSE and NMAD (m, as the statistics report prints
them), the val MAE of each epoch and the best, and the mean and standard
deviation over the seeds. ``run_seed(commands=)`` runs another package's
CLIs through the same steps (``tests/_jax_golden_spread.py``: the JAX
package's ``train.py`` and ``test.py``).

On the CPU the 5 seeds take about 5 minutes.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RUN_TIMEOUT = 1800
STATS = ("mae", "rmse", "nmad")


def port_commands(device: str = "cuda") -> tuple:
    """(train argv, inference argv, env) of the port's CLIs on ``device``;
    ``"{config}"`` stands for the config path."""
    return ([sys.executable, "-m", "resdepth_tpu_torch.train", "{config}", "--device",
             device],
            [sys.executable, "-m", "resdepth_tpu_torch.predict", "{config}", "--device",
             device], dict(os.environ))


def refined_stats(report: str) -> dict:
    """MAE, RMSE and NMAD of the refined DSM over every pixel, from a
    statistics report."""
    block = report.split("STATISTICS, OVERALL: REFINED DSM")[1].split("STATISTICS")[0]
    values = [float(v) for v in re.findall(r"-?\d+\.\d+", block)]
    return {"mae": values[2], "rmse": values[3], "nmad": values[6]}


def run_seed(work: str, seed: int, device: str = "cuda", commands=None) -> dict:
    """One golden pipeline at ``seed`` under ``work``, through
    ``commands`` (default ``port_commands(device)``; ``"{config}"`` in an
    argv stands for the config path)."""
    from resdepth_tpu_torch.make_demo_data import (fill_golden_test_config,
                                                   write_golden_scene)

    cfgs = write_golden_scene(work)
    with open(cfgs["train"]) as f:
        cfg = json.load(f)
    cfg["general"]["random_seed"] = seed
    with open(cfgs["train"], "w") as f:
        json.dump(cfg, f, indent=2)
    train, infer, env = commands or port_commands(device)
    for argv, config in ((train, cfgs["train"]), (infer, cfgs["test"])):
        if argv is infer:
            run_dir = max(glob.glob(os.path.join(cfgs["out"], "runs", "*")),
                          key=os.path.getmtime)
            fill_golden_test_config(cfgs["test"], run_dir)
        proc = subprocess.run([config if a == "{config}" else a for a in argv], cwd=REPO,
                              env=env, capture_output=True, text=True, timeout=RUN_TIMEOUT)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-3000:])
            raise RuntimeError(f"seed {seed}: {' '.join(argv[:3])} failed")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        val = [json.loads(line)["value"] for line in f
               if json.loads(line).get("tag") == "val/MAE_metric"]
    pair_dir = os.path.join(cfgs["out"], "eval", "golden_city", "Stereopair_0_1")
    with open(glob.glob(os.path.join(pair_dir, "*_statistics.txt"))[0]) as f:
        stats = refined_stats(f.read())
    return {**stats, "val": val, "best_val": min(val)}


def summary(runs: dict) -> dict:
    """Mean and standard deviation (ddof 1) of each statistic over seeds."""
    out = {}
    for key in (*STATS, "best_val"):
        values = np.array([r[key] for r in runs.values()], np.float64)
        out[key] = {"mean": float(values.mean()),
                    "std": float(values.std(ddof=1)) if len(values) > 1 else 0.0,
                    "min": float(values.min()), "max": float(values.max())}
    return out


def spread(seeds, label: str, **kwargs) -> dict:
    """``run_seed`` at each of ``seeds`` (``kwargs``: its ``device`` or
    ``commands``) in temporary directories, printed as they finish ->
    ``{"runs": {seed: ...}, "summary": summary(runs)}``."""
    runs = {}
    for seed in seeds:
        with tempfile.TemporaryDirectory() as work:
            runs[str(seed)] = run_seed(work, seed, **kwargs)
        print(f"{label} seed {seed}: refined MAE {runs[str(seed)]['mae']:.4f} m, "
              f"best val MAE {runs[str(seed)]['best_val']:.4f} m", flush=True)
    s = summary(runs)["mae"]
    print(f"{label}: refined MAE {s['mean']:.4f} +- {s['std']:.4f} m "
          f"({s['min']:.4f}-{s['max']:.4f})", flush=True)
    return {"runs": runs, "summary": summary(runs)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="JSON file of the results")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device that trains and refines (default: cuda)")
    args = ap.parse_args(argv)
    result = {"seeds": args.seeds, "device": args.device,
              **spread(args.seeds, "port", device=args.device)}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
