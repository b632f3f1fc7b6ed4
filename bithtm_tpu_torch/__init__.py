"""bithtm_tpu_torch: the PyTorch and CUDA port of bithtm_tpu.

The HTM learning step (SpatialPooler + TemporalMemory) at up to 2^16
cells and above (16K x 64 through the index-keyed growth selection),
its T-step scan over B independent streams, the chunked scan that widens
tuned list caps on a drop (`htm_scan_autocap`) and the serving scan
(over the synapse tables, a frozen word table or a compact serving
table), with every kernel as hand-written CUDA on NVIDIA Hopper
(`ops/kernels.py`, `csrc/`) and its plain PyTorch version on the CPU.
The single-stream reference API sits on top: the `networks` wrappers
(`HierarchicalTemporalMemory(...).process(x)`), the component hooks, the
TM decision trace (`tm_step(return_debug=True)`) that the NumPy oracle
(`oracle`) judges, `HostTemporalMemory`, checkpoints, the state checks,
the metrics log (`utils`) and the CLI (`python -m
bithtm_tpu_torch.example`). The step is batched, so a single stream is a
batch of one (`htm_init`) and there is no separate `htm_step_batch`.
States and serving tables carry over from the JAX package through
`convert`. Imports torch and numpy only: no JAX, and nothing of
`bithtm_tpu`.
"""

from .config import (HTMConfig, SPConfig, TMConfig, config_from_dict,
                     config_to_dict, make_htm_config)
from .convert import (htm_state_from_numpy, htm_state_to_numpy,
                      serving_table_from_numpy, serving_table_to_numpy)
from .host_hooks import HostTemporalMemory
from .models.htm import (CAP_DROP_METRICS, HTMOutput, htm_scan,
                         htm_scan_autocap, htm_serve_scan, htm_step,
                         resume_learning)
from .models.spatial_pooler import SPOutput, sp_step
from .models.temporal_memory import (TMDebug, TMOutput, tm_resume,
                                     tm_segment_observables, tm_step)
from .networks import HierarchicalTemporalMemory, SpatialPooler, TemporalMemory
from .ops.active_set import pack_frozen_table, take_small_table
from .ops.serving import ServingTable, make_serving_table
from .rng import Draws, TorchDraws
from .state import HTMState, SPState, TMState, htm_init, htm_init_batch

__all__ = [
    "CAP_DROP_METRICS", "Draws", "HTMConfig", "HTMOutput", "HTMState",
    "HierarchicalTemporalMemory", "HostTemporalMemory", "SPConfig",
    "SPOutput", "SPState", "ServingTable", "SpatialPooler", "TMConfig",
    "TMDebug", "TMOutput", "TMState", "TemporalMemory", "TorchDraws",
    "config_from_dict", "config_to_dict", "htm_init", "htm_init_batch",
    "htm_scan", "htm_scan_autocap", "htm_serve_scan",
    "htm_state_from_numpy", "htm_state_to_numpy", "htm_step",
    "make_htm_config", "make_serving_table", "pack_frozen_table",
    "resume_learning", "serving_table_from_numpy",
    "serving_table_to_numpy", "sp_step", "take_small_table", "tm_resume",
    "tm_segment_observables", "tm_step",
]
