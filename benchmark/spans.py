"""The program's own spans (``resdepth_tpu_torch/utils/profiler.py``) as
the per-layer metrics read them: the store of a traced run holds only the
profiled stretch, since a span records only while a profiler is on.
Readers run in ``run.py``'s process after the window has closed, so they
read the store directly. A program without spans (``profiler.spans``
missing) gives an empty list, and every reader then returns None."""

from __future__ import annotations


def records() -> list[dict]:
    """The program's span records, or [] where it records none."""
    from resdepth_tpu_torch.utils import profiler

    read = getattr(profiler, "spans", None)
    return read() if read is not None else []


def host_ms(record: dict) -> float:
    return (record["end_ns"] - record["start_ns"]) / 1e6


def totals(spans: list[dict], root: str, device: bool = False) -> list[dict]:
    """For each closed span named ``root``, in order: ``{name: ms}`` summed
    over the closed spans under it (itself included) by name, of host time,
    or with ``device`` of ``device_ms`` (spans without it left out). A
    record's ``parent`` is an index into ``spans``, and a parent is entered,
    so stored, before its children."""
    out, owner = {}, {}
    for i, s in enumerate(spans):
        if s["name"] == root:
            owner[i] = i
            out[i] = {}
        elif s["parent"] in owner:
            owner[i] = owner[s["parent"]]
        else:
            continue
        value = None
        if s["end_ns"] is not None:
            value = s.get("device_ms") if device else host_ms(s)
        if value is not None:
            sums = out[owner[i]]
            sums[s["name"]] = sums.get(s["name"], 0.0) + value
    return [sums for i, sums in out.items() if spans[i]["end_ns"] is not None]


def mean_per(spans: list[dict], root: str, names: tuple, device: bool = False,
             scale: float = 1.0):
    """The mean over ``root`` spans of the sum of ``names``' ms under each,
    times ``scale``; None where no root holds any of them."""
    per_root = [sum(t[n] for n in names if n in t)
                for t in totals(spans, root, device) if any(n in t for n in names)]
    return scale * sum(per_root) / len(per_root) if per_root else None


def steps(spans: list[dict]) -> list[dict]:
    """The closed train step spans (``train#<step>``), by start."""
    return sorted((s for s in spans if s["name"].startswith("train#")
                   and s["end_ns"] is not None), key=lambda s: s["start_ns"])


def step_launch_ms(spans: list[dict]):
    """Mean host ms of a step span: the time to enqueue a step. A span the
    profiler's stop fell inside is left out (its time holds the stop)."""
    times = [host_ms(s) for s in steps(spans) if not s.get("outlived_profile")]
    return sum(times) / len(times) if times else None


def step_gap_ms(spans: list[dict]):
    """Mean host ms from one step span's end to the next one's start: the
    train loop's own time between steps (the metrics' drain included)."""
    ordered = steps(spans)
    gaps = [(b["start_ns"] - a["end_ns"]) / 1e6 for a, b in zip(ordered, ordered[1:])]
    return sum(gaps) / len(gaps) if gaps else None
