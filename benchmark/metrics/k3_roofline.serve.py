"""K3's share of its least time in the scene loop: the frozen bound of
every call recorded at ``ops.conv.conv3x3_bias_act``'s entry over the
device time of K3's kernels and their weight splits."""

from benchmark.counts.shares import k3_roofline_pct


def read(record: dict):
    return k3_roofline_pct(record) if "scene_tiles" in record else None
