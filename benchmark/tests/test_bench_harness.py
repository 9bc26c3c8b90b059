"""The harness on the CPU: what it may import, that a cell and a metric
are found as files, that the frozen counts agree with the program's
arithmetic today, and the shape of the result line."""

import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness, run
from benchmark.counts import bounds, flops, kernels

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
SOURCES = sorted(os.path.relpath(os.path.join(d, f), BENCH)
                 for d, _, files in os.walk(BENCH) for f in files if f.endswith(".py"))
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def imported(path: str) -> list[str]:
    """Every module a file imports, as written (relative imports resolved
    against the benchmark's package)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append(node.module if not node.level else "benchmark." + (node.module or ""))
    return out


@pytest.mark.parametrize("source", SOURCES)
def test_no_jax_or_jax_package(source):
    """By whole top-level name: ``resdepth_tpu_torch`` starts with
    ``resdepth_tpu`` and is allowed; ``resdepth_tpu`` is not."""
    names = imported(os.path.join(BENCH, source))
    assert not [n for n in names if n.split(".")[0] in harness.FORBIDDEN], names


def _module_path(name: str) -> str | None:
    parts = name.split(".")
    if parts[0] != "benchmark":
        return None
    base = os.path.join(ROOT, *parts)
    for path in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(path):
            return path
    return None


@pytest.mark.parametrize("source", [s for s in SOURCES if s.startswith("reference")])
def test_reference_imports_nothing_of_the_program(source):
    """The reference and every benchmark module it reaches import nothing
    of ``resdepth_tpu_torch``."""
    seen, todo = set(), [os.path.join(BENCH, source)]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in imported(path):
            assert name.split(".")[0] != "resdepth_tpu_torch", (path, name)
            found = _module_path(name)
            if found:
                todo.append(found)


def test_a_new_cell_and_metric_need_no_edit(tmp_path):
    """A cell (traffic, limits, entry) and a per-layer metric (its reader
    and entry) added as files to a copy are found by name, and no file
    that was there changes."""
    copy = tmp_path / "repo"
    shutil.copytree(BENCH, copy / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (copy / "benchmark").rglob("*") if p.is_file()}

    traffic = json.loads((copy / "benchmark/traffic/resident4096.balanced16.k1.json").read_text())
    (copy / "benchmark/traffic/resident2048.fast32.k2.json").write_text(
        json.dumps({**traffic, "scene": 2048, "mode": "fast32", "use_pallas": "fused"}))
    (copy / "benchmark/workloads/stereo.serve.fast32.json").write_text(
        json.dumps({"limits": {"mean_dev_m": 0.01}}))
    (copy / "benchmark/metrics/tiles_a_scene.py").write_text(
        "def read(record):\n    return record.get('scene_tiles')\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "stereo.serve.fast32", "config": "resdepth-stereo",
                               "traffic": "resident2048.fast32.k2", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "tiles_a_scene", "unit": "tiles", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "scene_tiles_per_s"})
    for m in bench["end_to_end"]:
        if m["name"] == "scene_tiles_per_s":
            m["workloads"].append("stereo.serve.fast32")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    copied_run = run.load_file(str(copy / "benchmark/run.py"), "copied_run")
    plan = copied_run.cell_plan(bench, "stereo.serve.fast32")
    assert plan["traffic"]["mode"] == "fast32" and plan["limits"] == {"mean_dev_m": 0.01}
    assert plan["config"]["name"] == "resdepth-stereo"
    assert plan["traffic"]["scene"] == 2048
    assert "tiles_a_scene" in [m["name"] for m in plan["per_layer"]]
    metrics = copied_run.read_metrics([m for m in plan["per_layer"]
                                       if m["name"] == "tiles_a_scene"], {"scene_tiles": 225})
    assert metrics == {"tiles_a_scene": {"value": 225, "unit": "tiles"}}
    assert all(p.read_bytes() == data for p, data in before.items())


@pytest.mark.parametrize("channels", ["geom-stereo", "geom"])
@pytest.mark.parametrize("tile", [64, 256])
def test_frozen_flops_agree_with_analytic_flops(channels, tile):
    from resdepth_tpu_torch.models.unet import analytic_flops, flagship_config

    config = json.load(open(os.path.join(BENCH, "configs", "resdepth-stereo.json")))
    n_in = 3 if channels == "geom-stereo" else 1
    assert flops.forward_flops(config["model"], n_in, tile) == analytic_flops(
        flagship_config(channels), tile)


# The K3 calls of the cells: (x NHWC shape, Cout, passes, dtype).
K3_CALLS = [((128, 256, 256, 3), 64, 3, torch.float32),
            ((128, 256, 256, 1), 64, 3, torch.float32),
            ((128, 256, 256, 64), 1, 3, torch.float32),
            ((128, 128, 128, 64), 4, 3, torch.float32),
            ((128, 128, 128, 64), 128, 1, torch.float32),
            ((128, 16, 16, 512), 512, 1, torch.float32),
            ((20, 256, 256, 1), 64, 3, torch.float32),
            ((128, 64, 64, 128), 256, 1, torch.bfloat16)]


@pytest.mark.parametrize("shape,c_out,passes,dtype", K3_CALLS)
def test_frozen_conv_bound_agrees_with_chip_smoke(shape, c_out, passes, dtype):
    import chip_smoke

    x = torch.empty(shape, dtype=dtype, device="meta")
    want_ms, _ = chip_smoke.conv_bound(x, c_out, passes)
    got = bounds.conv3x3_bound_s(shape, c_out, passes, x.element_size())
    assert got == pytest.approx(want_ms / 1e3, rel=1e-12)


@pytest.mark.parametrize("scene,batch", [(4096, 0), (4096, 7), (1024, 1)])
def test_frozen_stitch_bound_agrees_with_chip_smoke(scene, batch):
    import chip_smoke
    from resdepth_tpu_torch.geo.grid import create_regular_grid, positions_as_array

    from benchmark.drivers.serve_resident import covered_pixels

    tile, n = 256, 128
    area = {"x_extent": [(0, scene - 1)], "y_extent": [(0, scene - 1)]}
    positions = positions_as_array(create_regular_grid(area, tile, tile // 2)[0])
    part = torch.from_numpy(np.resize(positions[batch * n:(batch + 1) * n], (n, 2)))
    record = {"tiles": torch.empty(n, tile, tile), "positions": part,
              "wy": torch.empty(n, tile), "wx": torch.empty(n, tile), "means": torch.empty(n)}
    want_ms, _ = chip_smoke.stitch_bound(record, (scene, scene))
    got = bounds.stitch_bound_s(n, tile, covered_pixels(part.numpy(), tile, (scene, scene)))
    assert got == pytest.approx(want_ms / 1e3, rel=1e-12)


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::narrow::conv3x3_k3_narrow_kernel<3, 2>(x)", "K3"),
    ("split_hi_lo_k_fragments_kernel(float const*)", "K3 split"),
    ("stitch_k1_kernel(float*)", "stitch"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "cuDNN convs"),
    ("void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>", "cuDNN convs"),
    ("void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>", "other")])
def test_kernel_groups_agree_with_chip_smoke(name, group):
    """The frozen grouping puts K3's weight splits with K3."""
    import chip_smoke

    lower = name.lower()
    theirs = next((g for g, keys in chip_smoke.KERNEL_GROUPS
                   if any(k in lower for k in keys)), "other")
    assert theirs == group
    ours = {"K3": "k3", "K3 split": "k3", "stitch": "stitch", "cuDNN convs": "cudnn",
            "other": "other"}[group]
    assert kernels.group_of(name) == ours


def test_result_line_has_the_contract_keys():
    record = {"checks": [{"name": "mean_dev_m", "value": 1e-3, "limit": 2e-3, "ok": True}],
              "attempted": 12, "failed": 0,
              "trace": {"device_ops": [["k", 0.5]], "idle_gaps": [["python", 0.1]],
                        "busy_s": 0.5, "window_s": 0.6}}
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "memory_peak_bytes": 1, "busy_s": 0.5, "window_s": 0.6}
    line = run.result_line(record, {"x": {"value": 1.0, "unit": "%"}}, device)
    assert list(line) == CONTRACT_KEYS + ["breakdown", "checks"]
    assert line["correct"] is True
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    record["checks"][0]["ok"] = False
    del record["trace"]
    line = run.result_line(record, {}, device)
    assert list(line) == CONTRACT_KEYS + ["checks"] and line["correct"] is False
    assert json.loads(json.dumps(line)) == line


def test_reduce_trace_takes_the_union_and_names_the_gaps():
    events = [{"cat": "kernel", "name": "a", "ts": 10.0, "dur": 10.0},
              {"cat": "kernel", "name": "b", "ts": 15.0, "dur": 10.0},
              {"cat": "gpu_memcpy", "name": "copy", "ts": 40.0, "dur": 5.0},
              {"cat": "cpu_op", "name": "aten::copy_", "ts": 24.0, "dur": 20.0},
              {"cat": "user_annotation", "name": "evaluate_performance", "ts": 0.0,
               "dur": 100.0}]
    out = harness.reduce_trace(events)
    assert out["busy_s"] == pytest.approx(20e-6)
    assert out["idle_gaps"] == [["evaluate_performance", pytest.approx(55e-6)],
                                ["aten::copy_", pytest.approx(15e-6)],
                                ["evaluate_performance", pytest.approx(10e-6)]]
    assert out["device_ops"][0][0] in ("a", "b") and len(out["device_ops"]) == 3


def test_no_card_no_result():
    """On the CPU the run exits with 2 and prints nothing on stdout."""
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "stereo.serve.balanced16", "--seed", "5000000000", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, a
    run that finds a card cannot import the program: it fails and prints
    no result line."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    script = ("import sys, torch; torch.cuda.is_available = lambda: True; "
              "torch.cuda.device_count = lambda: 1; "
              "sys.argv = ['run.py', '--workload', 'stereo.serve.balanced16', '--seed', '7', "
              "'--seconds', '1']; "
              "sys.path.insert(0, 'benchmark'); import run; sys.exit(run.main())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=300)
    assert out.returncode != 0
    assert "resdepth_tpu_torch" in out.stderr
    assert not out.stdout.strip().startswith("{")
