"""Readings a cell's limits are set from: the numbers ``correct``
compares, for many seeds in one process, of the program as the cell runs
it or, with ``--control``, of the traffic's control path in its place.
Not a benchmark run: the window is short and nothing is reported but the
numbers.

    python3 benchmark/readings.py --workload <cell> --seeds 101,102 [--seconds 1] [--control]

Prints one JSON line a seed and, with ``--out``, appends them to a file."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(cell: str, seeds, seconds: float, control: bool, device,
             fault: str | None = None) -> list[dict]:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import contextlib

    from benchmark import faults, harness, run

    plan = run.cell_plan(run.read_json(os.path.join(ROOT, "BENCHMARK.json")), cell)
    driver = run.driver_of(plan)
    out = []
    for seed in seeds:
        ctx = harness.Context(config=plan["config"], traffic=plan["traffic"],
                              limits=plan["limits"], seed=seed, seconds=seconds,
                              trace=False, device=device, started=time.perf_counter(),
                              control=control)
        with (faults.planted(plan["traffic"]["driver"], fault) if fault
              else contextlib.nullcontext()):
            record = driver.run(ctx)
        out.append({"cell": cell, "seed": seed, "control": control, "fault": fault,
                    "numbers": {c["name"]: c["value"] for c in record["checks"]},
                    "ok": all(c["ok"] for c in record["checks"])})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", help="a fault of benchmark/faults.py planted")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    for line in readings(args.workload, [int(s) for s in args.seeds.split(",")],
                         args.seconds, args.control, torch.device("cuda", 0),
                         args.fault):
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
