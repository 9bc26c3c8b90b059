"""The whole train step's share of the bf16 peak: three times the
model's forward operations (frozen ``analytic_flops``: forward, dx and
dw) for every sample of the epochs after the profiled one, over their
wall."""

from benchmark.counts.flops import forward_flops
from benchmark.counts.shares import peak_pct


def read(record: dict):
    if "samples" not in record or not record.get("unprofiled_samples"):
        return None
    flops = (3 * forward_flops(record["model"], record["input_channels"], record["tile"])
             * record["unprofiled_samples"])
    return peak_pct(flops, record["unprofiled_wall_s"])
