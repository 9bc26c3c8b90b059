"""The port's profiler hooks (``resdepth_tpu_torch.utils.profiler``) on the
CPU.

``trace`` writes one Chrome trace JSON file that holds the block's step
annotations; ``trace(None)`` and ``trace("")`` write nothing;
``chip_smoke.trace_steps`` reads steps and K3 kernels from a trace. The
spans themselves are ``tests/test_torch_spans.py``'s.
"""

import glob
import json
import os
from unittest import mock

import pytest
import torch

from resdepth_tpu_torch.utils import profiler


def _annotations(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


def test_trace_writes_the_step_annotations(tmp_path):
    out = str(tmp_path / "trace")
    x = torch.ones(8, 8)
    with profiler.trace(out, torch.device("cpu")):
        for step in range(3):
            with profiler.step_annotation("train", step):
                x = x @ x / 8.0
    files = glob.glob(os.path.join(out, "*.pt.trace.json"))
    assert len(files) == 1
    name = os.path.basename(files[0])
    assert f".{os.getpid()}.rank0." in name
    assert sorted(_annotations(files[0])) == ["train#0", "train#1", "train#2"]
    assert float(x[0, 0]) == 1.0


@pytest.mark.parametrize("profile_dir", [None, ""])
def test_trace_without_a_directory_is_a_no_op(tmp_path, monkeypatch, profile_dir):
    monkeypatch.chdir(tmp_path)
    ran = []
    with mock.patch("torch.profiler.profile") as profile:
        with profiler.trace(profile_dir, torch.device("cpu")):
            ran.append(True)
    assert ran == [True] and not profile.called and os.listdir(tmp_path) == []


def test_chip_smoke_reads_steps_from_a_trace(tmp_path):
    """``chip_smoke.trace_steps`` on a hand-made trace of two steps: each
    device op goes to the step whose first launched op began before it (a
    K3 kernel launched through ctypes has no runtime call to link it), busy
    time is the union of the ops' intervals, and the gap before a step is
    the device's idle time since the previous step's last op."""
    import chip_smoke

    def annotation(name, ts, dur):
        return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}

    def launch(corr, ts):
        return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
                "args": {"correlation": corr}}

    def kernel(name, corr, ts, dur):
        return {"cat": "kernel", "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    events = [annotation("train#0", 0, 100), annotation("train#1", 100, 100),
              annotation("Optimizer.step#Adam.step", 50, 10),
              launch(1, 10), launch(2, 20), launch(3, 110),
              kernel("gemm", 1, 200, 50), kernel("gemm", 2, 240, 30),
              kernel("void conv3x3_k3_kernel<64, 3, true, 64, 2>", 99, 270, 10),
              kernel("gemm", 3, 300, 40),
              {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 330, "dur": 20,
               "args": {"correlation": 98}}]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = chip_smoke.trace_steps(str(path))
    assert got["annotations"] == ["train#0", "train#1"] and got["k3"] == 1
    first, second = got["steps"]
    assert first == {"name": "train#0", "busy_ms": 0.08, "span_ms": 0.08, "gap_ms": 0.2,
                     "host_ms": 0.1}
    assert second == {"name": "train#1", "busy_ms": 0.05, "span_ms": 0.05,
                      "gap_ms": 0.02, "host_ms": 0.1}


@pytest.mark.parametrize("name,k3", [
    ("void (anonymous namespace)::conv3x3_k3_kernel<64, 3, true, 64, 1>(x)", 1),
    ("void (anonymous namespace)::narrow::conv3x3_k3_narrow_kernel<3, 2>(x)", 1),
    ("void (anonymous namespace)::narrow_k::conv3x3_k3_narrow_k_kernel<3, 2>(x)", 1),
    ("void (anonymous namespace)::wide_f32::conv3x3_k3_wide_f32_kernel<128, 1>(x)", 1),
    ("void (anonymous namespace)::wide_f32::split_hi_lo_weights_kernel(float const*)", 0),
    ("void (anonymous namespace)::narrow_k::split_hi_lo_k_fragments_kernel(float const*)", 0),
    ("void (anonymous namespace)::narrow::split_hi_lo_fragments_kernel(float const*)", 0),
    ("void (anonymous namespace)::split_hi_lo_kernel(float const*)", 0)])
def test_chip_smoke_counts_k3_kernels_of_both_variants(tmp_path, name, k3):
    """``chip_smoke.trace_steps`` counts a launch of K3's wide, wide_f32,
    narrow or narrow_k kernel as one K3 kernel, and its split kernels as
    none (the profile phase holds that count to K3's launch counter)."""
    import chip_smoke

    events = [{"cat": "user_annotation", "name": "train#0", "ts": 0, "dur": 100},
              {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 1,
               "args": {"correlation": 1}},
              {"cat": "kernel", "name": name, "ts": 20, "dur": 5,
               "args": {"correlation": 1}}]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert chip_smoke.trace_steps(str(path))["k3"] == k3
