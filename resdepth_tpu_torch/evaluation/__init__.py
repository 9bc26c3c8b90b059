"""The port's copy of ``resdepth_tpu/evaluation/__init__.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""
from resdepth_tpu_torch.evaluation.statistics import (
    compute_residuals, get_statistics, print_statistics, truncate_residuals,
)
from resdepth_tpu_torch.evaluation.performance import CLASS_TITLES, evaluate_performance
