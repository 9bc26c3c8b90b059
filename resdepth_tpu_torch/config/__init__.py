"""The port's copy of ``resdepth_tpu/config/__init__.py``, so that the port imports
nothing of the JAX package; only the imports differ.
"""
from resdepth_tpu_torch.config import schema
from resdepth_tpu_torch.config.defaults import default_cfg
from resdepth_tpu_torch.config.io import merge, print_json, read_json, remove_obsolete_keys, write_json
