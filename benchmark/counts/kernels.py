"""Kernel names by group, frozen from ``chip_smoke.py``'s
``KERNEL_GROUPS``: which device kernels a roofline's time is taken from.
A kernel's group is the first whose fragment its lower-cased name holds."""

from __future__ import annotations

GROUPS = (("k3", ("conv3x3_k3", "split_hi_lo")),
          ("stitch", ("stitch_k",)),
          ("cudnn", ("conv", "cudnn", "xmma", "cutlass", "gemm")))


def group_of(name: str) -> str:
    lower = name.lower()
    for group, fragments in GROUPS:
        if any(f in lower for f in fragments):
            return group
    return "other"
