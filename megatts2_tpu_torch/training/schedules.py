"""LR schedules and optimizer (port of ``megatts2_tpu/training/schedules.py``
and of the vocoder trainer's ``_make_tx``): linear warmup to ``lr`` over
``warmup_steps``, then cosine decay to 0 at ``total_steps``
(``transformers.get_cosine_schedule_with_warmup``, num_cycles=0.5), under
AdamW; or ``optax.exponential_decay`` (continuous, not staircase), under
AdamW with optax's weight decay 1e-4 (the vocoder).

optax's ``adamw`` and ``torch.optim.AdamW`` take the same step: bias
corrected moments, eps outside the square root, decoupled weight decay on
the pre-update parameters.  Weight decay applies to every parameter
(biases, norms and embeddings included), as the JAX optimizer has no mask.
optax reads the schedule at the count of updates already taken, so the
first update uses ``schedule(0)`` (0 during warmup): ``LambdaLR`` starts
there and is stepped after each ``optimizer.step()``.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import torch


def cosine_schedule_with_warmup(lr: float, warmup_steps: int, total_steps: int) -> Callable[[int], float]:
    """The learning rate at a step count, as a function."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr * step / max(1.0, float(warmup_steps))
        progress = (step - warmup_steps) / max(1.0, float(total_steps - warmup_steps))
        return lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))

    return schedule


def exponential_decay(lr: float, transition_steps: int, decay_rate: float) -> Callable[[int], float]:
    """``optax.exponential_decay(lr, transition_steps, decay_rate)``:
    lr · decay_rate ** (step / transition_steps), continuous."""

    def schedule(step: int) -> float:
        return lr * decay_rate ** (step / transition_steps)

    return schedule


def adamw(
    params: Iterable[torch.nn.Parameter],
    schedule: Callable[[int], float],
    weight_decay: float,
    b1: float,
    b2: float,
    eps: float = 1e-8,
) -> tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW whose learning rate is ``schedule(updates taken)``.  Step the
    scheduler after the optimizer."""
    # base lr 1, so that LambdaLR's factor is the scheduled rate itself
    opt = torch.optim.AdamW(params, lr=1.0, betas=(b1, b2), eps=eps, weight_decay=weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)


def make_adamw(
    params: Iterable[torch.nn.Parameter],
    lr: float,
    warmup_steps: int,
    total_steps: int,
    weight_decay: float = 0.01,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW with the cosine-warmup schedule (torch AdamW defaults:
    betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)."""
    return adamw(params, cosine_schedule_with_warmup(lr, warmup_steps, total_steps),
                 weight_decay, b1, b2, eps)
