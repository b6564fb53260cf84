"""The training loop on one device (port of
``megatts2_tpu/training/train_loop.py``).

The JAX loop's cadence and metric names: every ``log_every`` steps the
step's metrics plus ``steps_per_sec`` and ``host_rss_gb`` under
``train/``; every ``val_every`` steps the mean of each scalar of
``eval_step`` over the validation loader under ``val/``, then
``artifact_fn(state, first_valid_batch, step)`` (its failure is reported,
never fatal); JSONL through ``utils.logging.MetricsLogger``.
``trace_dir``: a ``torch.profiler`` trace of steps [10, 13)
(``utils.logging.ProfilerHook``).

On a mesh (the one ``parallel.place_train_state`` recorded on the state)
every rank runs the loop on the same global batches and takes its rows
(``parallel.shard_batch``; a batch that does not split evenly over the data
ranks raises, since the steps' reductions assume each rank holds rows of
its own); the steps' metrics are global, so the
validation means are of global values.  Only global rank 0 writes the
metrics, the ``loop/`` row, the trace and the checkpoints; every rank
takes part in a save (it gathers the sharded state) and calls
``artifact_fn``, which writes on rank 0 only.  The run starts from
``ckpt_path`` when given, else from the latest checkpoint in ``ckpt_dir``
(if any); with ``ckpt_dir`` it saves on the JAX cadence: after every
``save_every_n_vals``-th validation, scored by its ``val/<monitor>``, and
at the end unless that validation just saved the last step
(``training/checkpoints.py``: reference layout, top-k by score plus the
latest).

The run turns the tracer on (``utils/tracing.py``; as it was after the
run): the loop takes ``loop.loader_wait`` (the time it blocked on the next
batch) and ``loop.step`` (host wall from a batch in hand to its metrics
handled) around the train step's own spans, which a ``trace_dir`` profile
shows beside the kernels, and reads every one of its ``loop.*`` spans
through a tally of its own.  ``steps_per_sec`` is the last ≤50 steps over
their loader waits and step walls.  Beyond JAX's rows, one ``loop/`` row at
the end of a run that took steps: ``steps``, ``step_ms_median`` (steps
after the run's first, or the first alone), ``loader_wait_ms_median`` and
``loader_wait_ms_mean``.
"""
from __future__ import annotations

import os
import time
import traceback
from typing import Callable, Dict, Iterable, Optional

import numpy as np

from ..parallel.mesh import Mesh, shard_batch
from ..utils import tracing
from ..utils.logging import MetricsLogger, ProfilerHook
from .checkpoints import latest_checkpoint, restore_checkpoint, save_checkpoint

_END = object()


def _host_rss_gb() -> float:
    """This process' resident set (GB) from /proc/self/statm."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except OSError:  # not Linux
        return float("nan")
    return round(pages * os.sysconf("SC_PAGE_SIZE") / 1e9, 2)


class _NoLogger:
    """The logger of a rank other than 0."""

    def log(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def run_training(
    name: str,
    state,
    train_step: Callable,
    train_loader_factory: Callable[[int], Iterable],
    max_steps: int,
    log_dir: str = "logs",
    ckpt_dir: Optional[str] = None,
    log_every: int = 100,
    val_every: int = 1500,
    eval_step: Optional[Callable] = None,
    valid_loader_factory: Optional[Callable[[int], Iterable]] = None,
    trace_dir: Optional[str] = None,
    keep_ckpts: int = 5,
    artifact_fn: Optional[Callable] = None,
    monitor: str = "loss",
    save_every_n_vals: int = 1,
    ckpt_path: Optional[str] = None,
):
    """Train ``state`` in place from ``state.step`` to ``max_steps``; returns it.

    ``train_loader_factory(epoch)`` yields the global batches of one epoch;
    ``train_step(state, batch)`` and ``eval_step(state, batch)`` return
    dicts of scalars (see ``lm_trainers``).  Restores and saves as the
    module docstring says."""
    mesh = getattr(state, "mesh", None) or Mesh()
    path = ckpt_path or (latest_checkpoint(ckpt_dir) if ckpt_dir else None)
    if path:
        restore_checkpoint(path, state)
    logger = MetricsLogger(log_dir, name) if mesh.is_main else _NoLogger()
    profiler = ProfilerHook(trace_dir if mesh.is_main else None)
    step = state.step
    epoch = 0
    n_vals = 0
    saved = None  # the step last saved
    tracing_was_on = tracing.enabled()
    tracing.enable()
    loop = tracing.tally("loop.", keep=None)
    try:
        while step < max_steps:
            n_batches = 0
            batches = iter(train_loader_factory(epoch))
            try:
                while step < max_steps:
                    t0 = time.perf_counter_ns()
                    batch = next(batches, _END)
                    if batch is _END:
                        break
                    tracing.record("loop.loader_wait", t0, time.perf_counter_ns())
                    n_batches += 1
                    profiler.before_step(step)  # outside the span: a profile holds it whole
                    with tracing.span("loop.step"):
                        metrics = train_step(state, shard_batch(batch, mesh, replicate=False))
                        m = ({k: float(v) for k, v in metrics.items()}
                             if (step + 1) % log_every == 0 else None)
                    profiler.after_step(step)
                    step += 1
                    if m is not None:
                        steps = loop.durations_ms("loop.step", 50)
                        m["steps_per_sec"] = 1e3 * len(steps) / (
                            sum(steps) + sum(loop.durations_ms("loop.loader_wait", 50)))
                        m["host_rss_gb"] = _host_rss_gb()
                        logger.log(step, m, prefix="train/")
                    if val_every and step % val_every == 0 and eval_step and valid_loader_factory:
                        n_vals += 1
                        vm = _validate(state, eval_step, valid_loader_factory(epoch), artifact_fn,
                                       step, mesh)
                        logger.log(step, vm, prefix="val/")
                        if ckpt_dir and n_vals % max(save_every_n_vals, 1) == 0:
                            save_checkpoint(ckpt_dir, state, step, keep=keep_ckpts,
                                            metric=vm.get(monitor))
                            saved = step
            finally:
                if hasattr(batches, "close"):
                    batches.close()
            if n_batches == 0:
                raise ValueError(f"train loader gave no batch in epoch {epoch}")
            epoch += 1
        waits, walls = loop.durations_ms("loop.loader_wait"), loop.durations_ms("loop.step")
        if waits:
            logger.log(step, {"steps": len(waits),
                              "step_ms_median": float(np.median(walls[1:] or walls)),
                              "loader_wait_ms_median": float(np.median(waits)),
                              "loader_wait_ms_mean": float(np.mean(waits))},
                       prefix="loop/")
        if ckpt_dir and saved != step:
            save_checkpoint(ckpt_dir, state, step, keep=keep_ckpts)
    finally:
        profiler.close()
        logger.close()
        loop.close()
        if not tracing_was_on:
            tracing.disable()
    return state


def _validate(state, eval_step: Callable, batches: Iterable, artifact_fn: Optional[Callable],
              step: int, mesh: Mesh) -> Dict[str, float]:
    """The mean of each scalar ``eval_step`` returns over ``batches``; then
    ``artifact_fn`` on the first batch, whose failure is printed, not raised."""
    vals: Dict[str, list] = {}
    first = None
    for vb in batches:
        vb = shard_batch(vb, mesh, replicate=False)
        first = vb if first is None else first
        for k, v in eval_step(state, vb).items():
            if np.ndim(v) == 0:
                vals.setdefault(k, []).append(float(v))
    if artifact_fn is not None and first is not None:
        try:
            artifact_fn(state, first, step)
        except Exception:  # validation artifacts never stop a run
            print(f"[val artifacts] step {step} skipped:\n{traceback.format_exc()}")
    return {k: float(np.mean(v)) for k, v in vals.items()}
