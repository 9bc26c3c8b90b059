"""The stitch's (K1, K2) share of its least time: the frozen bytes bound
of every launch recorded at ``ops.stitch.stitch_tiles``' entry over the
stitch kernels' device time."""

from benchmark.counts.bounds import stitch_bound_s
from benchmark.counts.shares import group_roofline_pct


def read(record: dict):
    calls = record.get("stitch_calls")
    if not calls:
        return None
    bound = sum(stitch_bound_s(n, tile, covered) for n, tile, covered in calls)
    return group_roofline_pct(record, "stitch", bound)
