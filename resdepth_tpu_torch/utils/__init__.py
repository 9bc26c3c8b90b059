"""The port's copy of ``resdepth_tpu/utils/__init__.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""
from resdepth_tpu_torch.utils.attrdict import AttrDict
from resdepth_tpu_torch.utils import fs
from resdepth_tpu_torch.utils.logging import setup_logger, add_console_logger, add_file_logger
