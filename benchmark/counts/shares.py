"""Shares that several per-layer metrics compute alike from a run's
record: a device's idle share, a share of the bf16 peak and a kernel
group's share of its least time. Each returns None when the record holds
nothing to read."""

from __future__ import annotations

from benchmark.counts import bounds, kernels


def idle_pct(record: dict) -> float | None:
    trace = record.get("trace")
    if not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def peak_pct(flops: float, seconds: float) -> float | None:
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / bounds.PEAK_BF16_FLOPS


def group_roofline_pct(record: dict, group: str, bound_s: float) -> float | None:
    """``bound_s`` over the device time of ``group``'s kernels in the
    traced part of the window."""
    trace = record.get("trace")
    if not trace or bound_s <= 0:
        return None
    spent = sum(s for name, s in trace["kernel_s"].items()
                if kernels.group_of(name) == group)
    return 100.0 * bound_s / spent if spent > 0 else None


def k3_roofline_pct(record: dict) -> float | None:
    """Every K3 call recorded at ``ops.conv.conv3x3_bias_act``'s entry,
    as ``(x shape, Cout, passes, element size)``."""
    calls = record.get("k3_calls")
    if not calls:
        return None
    bound = sum(bounds.conv3x3_bound_s(shape, c_out, passes, size)
                for shape, c_out, passes, size in calls)
    return group_roofline_pct(record, "k3", bound)
