"""One run of one benchmark cell of the port (``resdepth_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` names the cell's configuration and traffic mix; the
run loads ``benchmark/configs/<file>``, ``benchmark/traffic/<traffic>.json``
(its ``driver`` names ``benchmark/drivers/<driver>.py``) and the cell's
limits, ``benchmark/workloads/<cell>.json``. The driver sets up, measures
for ``--seconds`` and compares what the timed path produced with the plain
reference. Then each metric the cell reports (``--trace 0``: its
end-to-end metrics, ``--trace 1``: its per-layer ones) is read from the
run's record by ``benchmark/metrics/<metric>.py``; a reader that finds
nothing returns None and the metric is left out. The last line of standard
output is the result as one JSON object; the numbers compared, beside their
limits, are the last lines of standard error and the result's last key.

Without a CUDA device, with fewer than the cell's chips, or with JAX or the
JAX package loaded once the window has closed, the run exits with 2 and
prints no result."""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

STARTED = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_file(path: str, name: str):
    """A module from a file of the benchmark, by path: a metric's name
    holds dots, which ``import`` would read as packages."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_plan(bench: dict, cell: str) -> dict:
    """The cell's entry, its configuration and traffic files' contents,
    its limits and the metrics it reports, from ``BENCHMARK.json``."""
    workloads = {w["name"]: w for w in bench["workloads"]}
    if cell not in workloads:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json: "
                         f"{sorted(workloads)}")
    entry = workloads[cell]
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    limits_path = os.path.join(HERE, "workloads", f"{cell}.json")

    def reported(metrics):
        return [m for m in metrics if cell in m.get("workloads", [cell])]

    return {"entry": entry,
            "config": read_json(os.path.join(ROOT, config["file"])),
            "traffic": read_json(os.path.join(HERE, "traffic", f"{entry['traffic']}.json")),
            "limits": read_json(limits_path)["limits"],
            "end_to_end": reported(bench["end_to_end"]),
            "per_layer": reported(bench["per_layer"])}


def driver_of(plan: dict):
    """The cell's driver module, ``drivers/<traffic's driver>.py``."""
    name = plan["traffic"]["driver"]
    return load_file(os.path.join(HERE, "drivers", f"{name}.py"), f"benchmark_driver_{name}")


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip() or out.stderr.strip()


def read_metrics(metrics: list, record: dict) -> dict:
    out = {}
    for m in metrics:
        reader = load_file(os.path.join(HERE, "metrics", f"{m['name']}.py"),
                           f"benchmark_metric_{m['name'].replace('.', '_')}")
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(record: dict, metrics: dict, device: dict) -> dict:
    """The contract's keys, ``breakdown`` in a traced run, and the numbers
    compared under ``checks``, last."""
    checks = record["checks"]
    result = {"correct": bool(checks) and all(c["ok"] for c in checks)
              and record["failed"] == 0,
              "attempted": record["attempted"], "failed": record["failed"],
              "metrics": metrics, "device": device}
    if "trace" in record:
        result["breakdown"] = {k: record["trace"][k] for k in ("device_ops", "idle_gaps")}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness

    # Kernel caches at fixed paths inside the checkout, so that only a
    # cell's first run there builds (the port's nvcc libraries go to
    # build/resdepth_tpu_torch/ by themselves).
    for name, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                      ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[name] = os.path.join(ROOT, "build", "benchmark", sub)

    plan = cell_plan(read_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    chips = plan["entry"]["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "available. No result.", file=sys.stderr)
        return 2
    print(f"card: {power_limit()}", file=sys.stderr, flush=True)
    device = torch.device("cuda", 0)
    ctx = harness.Context(config=plan["config"],
                          traffic=plan["traffic"], limits=plan["limits"],
                          seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                          device=device, started=STARTED)
    record = driver_of(plan).run(ctx)

    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}. No result.",
              file=sys.stderr)
        return 2
    metrics = read_metrics(plan["per_layer"] if args.trace else plan["end_to_end"],
                           record)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": record["memory_peak_bytes"]}
    if args.trace:
        info.update(busy_s=record["trace"]["busy_s"], window_s=record["trace"]["window_s"])
    result = result_line(record, metrics, info)
    if "setup_phases" in record:
        print("setup phases: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                           record["setup_phases"].items()), file=sys.stderr)
    for c in record["checks"]:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r}) "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
