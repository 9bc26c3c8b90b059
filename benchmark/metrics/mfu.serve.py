"""The whole scene's share of the bf16 peak: the model's forward
operations (frozen ``analytic_flops``) for every real tile of the scenes
after the profiled part, over their wall. The peak is the bf16 dense
rate in every mode."""

from benchmark.counts.flops import forward_flops
from benchmark.counts.shares import peak_pct


def read(record: dict):
    if "scene_tiles" not in record or not record.get("unprofiled_scenes"):
        return None
    flops = (forward_flops(record["model"], record["input_channels"], record["tile"])
             * record["scene_tiles"] * record["unprofiled_scenes"])
    return peak_pct(flops, record["unprofiled_wall_s"])
