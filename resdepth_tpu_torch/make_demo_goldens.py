"""Run the golden pipeline on the port: the golden scene of
``make_demo_data.write_golden_scene`` trained by ``python -m
resdepth_tpu_torch.train`` and refined by ``python -m
resdepth_tpu_torch.predict`` (the port's copy of
``scripts/make_demo_goldens.py``).

    python -m resdepth_tpu_torch.make_demo_goldens --out DIR [--device cuda]

writes the refined-DSM GeoTIFF and its statistics report to
``DIR/demo_refined_dsm.tif`` and ``DIR/demo_statistics.txt``. The JAX
package's committed goldens (``tests/goldens/``) are its own and are never
written here: the golden config trains with augmentation, whose random
streams differ between the packages, so the port's refined DSM matches
them in its statistics, not to 1e-4 m. About a minute on the CPU
(``--device cpu``).
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_golden_pipeline(work_dir: str, device: str = "cuda") -> dict:
    """Train and refine the golden scene under ``work_dir`` through the
    port's CLIs in child processes; returns the artifacts' paths."""
    from resdepth_tpu_torch.make_demo_data import (fill_golden_test_config,
                                                   write_golden_scene)

    cfgs = write_golden_scene(work_dir)
    for module, cfg in (("resdepth_tpu_torch.train", cfgs["train"]),
                        ("resdepth_tpu_torch.predict", cfgs["test"])):
        if module.endswith("predict"):
            run_dir = max(glob.glob(os.path.join(cfgs["out"], "runs", "*")),
                          key=os.path.getmtime)
            fill_golden_test_config(cfgs["test"], run_dir)
        proc = subprocess.run([sys.executable, "-m", module, cfg, "--device", device],
                              cwd=REPO, capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-3000:])
            raise RuntimeError(f"{module} failed on the golden scene")
    pair_dir = os.path.join(cfgs["out"], "eval", "golden_city", "Stereopair_0_1")
    return {
        "prediction": os.path.join(pair_dir, "initial_DSM_prediction_test_area.tif"),
        "statistics": os.path.join(pair_dir,
                                   "initial_DSM_prediction_test_area_statistics.txt"),
        "run_dir": run_dir,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="directory of the refined DSM and report")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    from resdepth_tpu_torch import predict

    predict.resolve_device(args.device)   # no card: fail before training
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory() as work:
        outputs = run_golden_pipeline(work, args.device)
        written = {"prediction": os.path.join(args.out, "demo_refined_dsm.tif"),
                   "statistics": os.path.join(args.out, "demo_statistics.txt")}
        for key, path in written.items():
            shutil.copy(outputs[key], path)
    print(f"Golden pipeline outputs written to {args.out}")
    return written


if __name__ == "__main__":
    main()
