"""The training loop on one device (port of
``megatts2_tpu/training/train_loop.py``).

The JAX loop's cadence and metric names: every ``log_every`` steps the
step's metrics plus ``steps_per_sec`` and ``host_rss_gb`` under
``train/``; every ``val_every`` steps the mean of each scalar of
``eval_step`` over the validation loader under ``val/``; JSONL through
``utils.logging.MetricsLogger``.  There is no mesh (one device) and no
profiler hook.  With ``ckpt_dir`` the loop first resumes from the latest
checkpoint there (if any), then saves on the JAX cadence: after every
``save_every_n_vals``-th validation, scored by its ``val/<monitor>``, and
once at the end (``training/checkpoints.py``: reference layout, top-k by
score plus the latest).
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Optional

import numpy as np

from ..utils.logging import MetricsLogger, StepTimer
from .checkpoints import latest_checkpoint, restore_checkpoint, save_checkpoint


def _host_rss_gb() -> float:
    """This process' resident set (GB) from /proc/self/statm."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except OSError:  # not Linux
        return float("nan")
    return round(pages * os.sysconf("SC_PAGE_SIZE") / 1e9, 2)


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
    keep_ckpts: int = 5,
    monitor: str = "loss",
    save_every_n_vals: int = 1,
):
    """Train ``state`` in place from ``state.step`` to ``max_steps``; returns it.

    ``train_loader_factory(epoch)`` yields the batches of one epoch;
    ``train_step(state, batch)`` and ``eval_step(state, batch)`` return
    dicts of scalars (see ``lm_trainers``).  ``ckpt_dir``: resume from its
    latest checkpoint, then save as the module docstring says."""
    if ckpt_dir and latest_checkpoint(ckpt_dir):
        restore_checkpoint(ckpt_dir, state)
    logger = MetricsLogger(log_dir, name)
    timer = StepTimer()
    step = state.step
    epoch = 0
    n_vals = 0
    try:
        while step < max_steps:
            n_batches = 0
            for batch in train_loader_factory(epoch):
                if step >= max_steps:
                    break
                n_batches += 1
                metrics = train_step(state, batch)
                timer.tick()
                step += 1
                if step % log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["steps_per_sec"] = timer.steps_per_sec
                    m["host_rss_gb"] = _host_rss_gb()
                    logger.log(step, m, prefix="train/")
                if val_every and step % val_every == 0 and eval_step and valid_loader_factory:
                    vals: Dict[str, list] = {}
                    for vb in valid_loader_factory(epoch):
                        for k, v in eval_step(state, vb).items():
                            if np.ndim(v) == 0:
                                vals.setdefault(k, []).append(float(v))
                    vm = {k: float(np.mean(v)) for k, v in vals.items()}
                    logger.log(step, vm, prefix="val/")
                    n_vals += 1
                    if ckpt_dir and n_vals % max(save_every_n_vals, 1) == 0:
                        save_checkpoint(ckpt_dir, state, step, keep=keep_ckpts,
                                        metric=vm.get(monitor))
            if n_batches == 0:
                raise ValueError(f"train loader gave no batch in epoch {epoch}")
            epoch += 1
        if ckpt_dir:
            save_checkpoint(ckpt_dir, state, step, keep=keep_ckpts)
    finally:
        logger.close()
    return state
