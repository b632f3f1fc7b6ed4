"""Structured metrics logging: the host side of the step's metric dicts.

Counterpart of `bithtm_tpu/utils/metrics_log.py`: summarize per-step (or
[T]-stacked, batched) metric dicts of tensors or arrays and append them
to a JSONL file. Tensors are read with `.cpu().numpy()`.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def summarize(metrics: dict, reduce_batch: bool = True) -> dict:
    """Convert a (possibly batched or [T]-stacked) metric dict into
    plain python scalars/lists."""
    out = {}
    for k, v in metrics.items():
        a = _host(v)
        if a.ndim == 0:
            out[k] = a.item()
        elif reduce_batch:
            out[k] = float(a.mean()) if a.dtype.kind == "f" else int(a.sum())
        else:
            out[k] = a.tolist()
    return out


def capacity_health(metrics: dict, pool_slots: int | None = None,
                    scan: bool = False) -> dict:
    """Aggregate the pool-capacity signals from a step (or [T]-stacked
    scan) metric dict into one operator-facing record: every
    ``tm_dropped_*`` counter plus ``tm_evicted_segments`` summed, the
    pool occupancy at the latest step (mean over streams), the
    occupancy fraction when ``pool_slots`` (= column_dim *
    segments_per_column) is given, and a coarse status — ``"ok"`` when
    nothing dropped, ``"pressure"`` when capacity overflow occurred
    (see README "Pool capacity semantics" for what to do about it)."""
    rec = {}
    total_drops = 0
    for k, v in metrics.items():
        if k.startswith("tm_dropped_") or k == "tm_evicted_segments":
            n = int(_host(v).sum())
            rec[k] = n
            if k.startswith("tm_dropped_"):
                total_drops += n
    occ = metrics.get("tm_pool_occupancy")
    if occ is not None:
        a = _host(occ)
        if scan and a.ndim >= 1:
            a = a[-1]  # [T] or [T, B]: latest step
        rec["pool_occupancy"] = float(np.mean(a))
        if pool_slots:
            rec["pool_occupancy_frac"] = round(
                float(np.mean(a)) / pool_slots, 4
            )
    rec["status"] = "pressure" if total_drops else "ok"
    return rec


class JsonlLogger:
    """Append-only JSONL metrics log with a monotonic step counter.

    log = JsonlLogger("run/metrics.jsonl", config=cfg_dict)
    log.write(out.metrics)            # one line per step (or epoch)
    """

    def __init__(self, path: str, config: dict | None = None):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self.step = 0
        if config is not None:
            self._emit({"event": "config", **config})

    def _emit(self, record: dict) -> None:
        record.setdefault("ts", round(time.time(), 3))
        self._f.write(json.dumps(record) + "\n")

    def write(self, metrics: dict, **extra) -> None:
        self._emit({"step": self.step, **summarize(metrics), **extra})
        self.step += 1

    def write_capacity(self, metrics: dict, pool_slots: int | None = None,
                       scan: bool = False, **extra) -> None:
        """Emit a ``{"event": "capacity", ...}`` health record (see
        `capacity_health`) — typically once per epoch, so long runs show
        pool-saturation trends without custom analysis."""
        self._emit({
            "event": "capacity", "step": self.step,
            **capacity_health(metrics, pool_slots=pool_slots, scan=scan),
            **extra,
        })

    def close(self) -> None:
        self._f.close()
