"""bithtm_tpu_torch: the PyTorch and CUDA port of bithtm_tpu.

The HTM learning step (SpatialPooler + TemporalMemory) at up to 2^16
cells and above (16K x 64 through the index-keyed growth selection),
its T-step scan over B independent streams, the chunked scan that widens
tuned list caps on a drop (`htm_scan_autocap`) and the serving scan
(over the synapse tables, a frozen word table or a compact serving
table), with every kernel as hand-written CUDA on NVIDIA Hopper
(`ops/kernels.py`, `csrc/`) and its plain PyTorch version on the CPU. States and serving tables carry over from the JAX package
through `convert`.
Imports torch only: no JAX, and nothing of `bithtm_tpu`.
"""

from .config import (HTMConfig, SPConfig, TMConfig, config_from_dict,
                     config_to_dict, make_htm_config)
from .convert import (htm_state_from_numpy, htm_state_to_numpy,
                      serving_table_from_numpy, serving_table_to_numpy)
from .models.htm import (CAP_DROP_METRICS, HTMOutput, htm_scan,
                         htm_scan_autocap, htm_serve_scan, htm_step,
                         resume_learning)
from .models.spatial_pooler import SPOutput, sp_step
from .models.temporal_memory import TMOutput, tm_resume, tm_step
from .ops.active_set import pack_frozen_table, take_small_table
from .ops.serving import ServingTable, make_serving_table
from .rng import Draws, TorchDraws
from .state import HTMState, SPState, TMState, htm_init_batch

__all__ = [
    "CAP_DROP_METRICS", "Draws", "HTMConfig", "HTMOutput", "HTMState",
    "SPConfig", "SPOutput", "SPState", "ServingTable", "TMConfig",
    "TMOutput", "TMState", "TorchDraws", "config_from_dict",
    "config_to_dict", "htm_init_batch", "htm_scan",
    "htm_scan_autocap", "htm_serve_scan", "htm_state_from_numpy",
    "htm_state_to_numpy", "htm_step", "make_htm_config",
    "make_serving_table", "pack_frozen_table", "resume_learning",
    "serving_table_from_numpy", "serving_table_to_numpy", "sp_step",
    "take_small_table", "tm_resume", "tm_step",
]
