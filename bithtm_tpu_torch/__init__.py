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
bithtm_tpu_torch.example`). The NAB-style pipeline sits beside it: the
encoders and the anomaly stages (`encoders`), the SDR classifier
(`readout`), the multi-level stack (`models.stack`), the prefetcher and
the phase timer (`utils`) and the example scripts (`python -m
bithtm_tpu_torch.examples.<name>`). The step is batched, so a single
stream is a batch of one (`htm_init`) and `htm_step_batch` is `htm_step`
under the JAX package's name. On the card the scans, `stack_scan` and
the wrappers' `process` replay the step's CUDA graph (`models.graph`,
the counterpart of JAX's `jit` with donation; `models.graph.eager()`
runs their plain loops instead). States, serving tables, classifier and anomaly-stage
states carry over from the JAX package through `convert`. The subpackage
`parallel` (imported on its own, as in JAX) runs the step over a (data x
model) grid of ranks on `torch.distributed`: streams split over data,
columns over model (`parallel.mesh`), with per-process feeding and
restart (`parallel.distributed`). Imports torch and numpy only: no JAX,
and nothing of `bithtm_tpu`.
"""

from .config import (HTMConfig, SPConfig, TMConfig, config_from_dict,
                     config_to_dict, make_htm_config, make_tm_config)
from .convert import (htm_state_from_numpy, htm_state_to_numpy,
                      serving_table_from_numpy, serving_table_to_numpy)
from .encoders import (AnomalyLikelihoodState, CategoryEncoder,
                       CyclicEncoder, DateTimeEncoder, ScalarEncoder,
                       SeasonalZScoreState, alert_episodes,
                       anomaly_likelihood_init, anomaly_likelihood_update,
                       anomaly_score, concat, score_alert_windows,
                       seasonal_zscore, seasonal_zscore_init,
                       seasonal_zscore_update)
from .host_hooks import HostTemporalMemory
from .models.htm import (CAP_DROP_METRICS, HTMOutput, htm_scan,
                         htm_scan_autocap, htm_serve_scan, htm_step,
                         htm_step_batch, resume_learning)
from .models.spatial_pooler import SPOutput, sp_step
from .models.stack import (StackConfig, StackOutput, make_stack_config,
                           stack_draws, stack_init, stack_scan, stack_step)
from .models.temporal_memory import (TMDebug, TMOutput, tm_resume,
                                     tm_segment_observables, tm_step)
from .networks import HierarchicalTemporalMemory, SpatialPooler, TemporalMemory
from .ops.active_set import pack_frozen_table, take_small_table
from .ops.serving import ServingTable, make_serving_table
from .readout import (ClassifierState, bucket_value, bucketize,
                      classifier_init, classifier_predict, classifier_update)
from .rng import Draws, TorchDraws
from .state import (HTMState, SPState, TMState, htm_init, htm_init_batch,
                    sp_init, tm_init)

__all__ = [
    "AnomalyLikelihoodState", "CAP_DROP_METRICS", "CategoryEncoder",
    "ClassifierState", "CyclicEncoder", "DateTimeEncoder", "Draws",
    "HTMConfig", "HTMOutput", "HTMState", "HierarchicalTemporalMemory",
    "HostTemporalMemory", "SPConfig", "SPOutput", "SPState",
    "ScalarEncoder", "SeasonalZScoreState", "ServingTable",
    "SpatialPooler", "StackConfig", "StackOutput", "TMConfig", "TMDebug",
    "TMOutput", "TMState", "TemporalMemory", "TorchDraws",
    "alert_episodes", "anomaly_likelihood_init",
    "anomaly_likelihood_update", "anomaly_score", "bucket_value",
    "bucketize", "classifier_init", "classifier_predict",
    "classifier_update", "concat", "config_from_dict", "config_to_dict",
    "htm_init", "htm_init_batch", "htm_scan", "htm_scan_autocap",
    "htm_serve_scan", "htm_state_from_numpy", "htm_state_to_numpy",
    "htm_step", "htm_step_batch", "make_htm_config", "make_serving_table",
    "make_stack_config", "make_tm_config", "pack_frozen_table",
    "resume_learning", "score_alert_windows", "seasonal_zscore",
    "seasonal_zscore_init", "seasonal_zscore_update",
    "serving_table_from_numpy", "serving_table_to_numpy", "sp_init",
    "sp_step", "stack_draws", "stack_init", "stack_scan", "stack_step",
    "take_small_table", "tm_init", "tm_resume", "tm_segment_observables",
    "tm_step",
]
