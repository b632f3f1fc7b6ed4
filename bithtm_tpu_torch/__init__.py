"""bithtm_tpu_torch: the PyTorch and CUDA port of bithtm_tpu.

The HTM learning step (SpatialPooler + TemporalMemory) and its T-step
scan over B independent streams, with the full-table pass of the
temporal memory as a hand-written CUDA kernel on NVIDIA Hopper
(`ops/kernels.py`, `csrc/table_pass.cu`) and its plain PyTorch version
on the CPU. States carry over from the JAX package through `convert`.
Imports torch only: no JAX, and nothing of `bithtm_tpu`.
"""

from .config import (HTMConfig, SPConfig, TMConfig, config_from_dict,
                     config_to_dict, make_htm_config)
from .convert import htm_state_from_numpy, htm_state_to_numpy
from .models.htm import HTMOutput, htm_scan, htm_step
from .models.spatial_pooler import SPOutput, sp_step
from .models.temporal_memory import TMOutput, tm_step
from .rng import Draws, TorchDraws
from .state import HTMState, SPState, TMState, htm_init_batch

__all__ = [
    "Draws", "HTMConfig", "HTMOutput", "HTMState", "SPConfig", "SPOutput",
    "SPState", "TMConfig", "TMOutput", "TMState", "TorchDraws",
    "config_from_dict", "config_to_dict", "htm_init_batch", "htm_scan",
    "htm_state_from_numpy", "htm_state_to_numpy", "htm_step",
    "make_htm_config", "sp_step", "tm_step",
]
