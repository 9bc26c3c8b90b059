"""K3's share of its least time in the train step (its forward and dx
calls): the frozen bound of every call recorded at
``ops.conv.conv3x3_bias_act``'s entry in the profiled steps over the
device time of K3's kernels and their weight splits there."""

from benchmark.counts.shares import k3_roofline_pct


def read(record: dict):
    return k3_roofline_pct(record) if "samples" in record else None
