"""Metrics logging and step timing (port of the JAX-free part of
``megatts2_tpu/utils/logging.py``, which imports jax for its profiler hook).

``MetricsLogger`` appends one JSON object per call to
``<log_dir>/<name>_metrics.jsonl``: ``{"step", "time", <prefix><key>: value}``,
the file format of the JAX package's logger.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Dict


class MetricsLogger:
    def __init__(self, log_dir: str, name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}_metrics.jsonl")
        self._f = open(self.path, "a")

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "") -> None:
        row = {"step": int(step), "time": time.time()}
        row.update({f"{prefix}{k}": float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class StepTimer:
    """Rolling steps/sec over the last ≤window ticks (updates every tick)."""

    def __init__(self, window: int = 50):
        self._ticks = deque([time.perf_counter()], maxlen=window + 1)
        self.steps_per_sec = 0.0

    def tick(self) -> None:
        self._ticks.append(time.perf_counter())
        span = self._ticks[-1] - self._ticks[0]
        if span > 0:
            self.steps_per_sec = (len(self._ticks) - 1) / span
