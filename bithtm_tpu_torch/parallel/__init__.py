"""Data- and model-parallel execution on `torch.distributed`:
`parallel.mesh` (the rank grid, the state layout, the sharded learning
and serving steps) and `parallel.distributed` (process-group set-up,
per-process feeding, restart). Counterpart of `bithtm_tpu/parallel/`;
imported as a subpackage, not re-exported by the package."""
