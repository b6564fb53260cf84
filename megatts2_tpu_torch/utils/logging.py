"""Metrics logging and profiler traces (port of
``megatts2_tpu/utils/logging.py``).

``MetricsLogger`` appends one JSON object per call to
``<log_dir>/<name>_metrics.jsonl``: ``{"step", "time", <prefix><key>: value}``,
the file format of the JAX package's logger.  ``ProfilerHook`` captures a
``torch.profiler`` trace of a few steps, as JAX's hook does with
``jax.profiler``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


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


class ProfilerHook:
    """A ``torch.profiler`` trace of steps [start, start + n): CPU and, when
    a card is present, CUDA activities, exported as a Chrome trace
    ``<trace_dir>/trace_steps_<start>-<stop>.json``.  A run that starts past
    ``start`` (a resume) takes no trace, as JAX's hook."""

    def __init__(self, trace_dir: Optional[str], start_step: int = 10, n_steps: int = 3):
        self.trace_dir = trace_dir
        self.start = start_step
        self.stop = start_step + n_steps
        self._prof = None

    def before_step(self, step: int) -> None:
        if self.trace_dir and step == self.start:
            import torch  # here: this package's modules load without torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()

    def after_step(self, step: int) -> None:
        if self._prof is not None and step + 1 >= self.stop:
            self.close()

    def close(self) -> None:
        """Stop a trace in progress and write it."""
        if self._prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.trace_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.trace_dir, f"trace_steps_{self.start}-{self.stop}.json"))
