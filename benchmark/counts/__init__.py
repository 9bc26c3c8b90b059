"""Frozen copies of the arithmetic the metrics rest on: the UNet's
operations, the kernels' least times and the grouping of kernel names.
Later changes to the program do not move them."""
