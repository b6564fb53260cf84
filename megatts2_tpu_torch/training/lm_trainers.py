"""PLM and ADM training steps (port of ``megatts2_tpu/training/lm_trainers.py``).

* PLM: summed cross-entropy over the code logits, ignoring targets equal to
  ``eos_id`` (vq_bins + 1), cast to fp32 before the log-softmax; the logged
  ``loss`` is the sum / B / T with T the padded target length, and ``ac10``
  the top-10 accuracy over non-eos targets.
* ADM: summed squared error of the predicted durations.  As in the
  reference, the sum INCLUDES padded positions unless ``mask_padding``.

A :class:`TrainState` holds the model (fp32 master weights), AdamW, its
schedule, the dropout generator and the step count; a train step updates
it in place and returns its metrics as 0-d tensors, so the host waits on
the device only where the loop reads them.  Batches are dicts of numpy
arrays in ``PLMBatchBuilder`` / ``ADMBatchBuilder`` form; ``tc_latents``
arrives as fp16 and the model casts it to the compute dtype.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import MegaADMConfig, MegaPLMConfig, TrainConfig
from ..models import MegaADM, MegaPLM, init_random_
from .schedules import make_adamw

Metrics = Dict[str, torch.Tensor]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class TrainState:
    model: nn.Module
    opt: torch.optim.Optimizer
    sched: torch.optim.lr_scheduler.LRScheduler
    generator: torch.Generator  # dropout, on the model's device
    step: int = 0


def compute_dtype(tcfg: TrainConfig) -> torch.dtype:
    if tcfg.train_dtype not in _DTYPES:
        raise ValueError(f"train_dtype {tcfg.train_dtype!r} not in {sorted(_DTYPES)}")
    return _DTYPES[tcfg.train_dtype]


def top_k_accuracy(logits: torch.Tensor, targets: torch.Tensor, k: int, ignore_index: int) -> torch.Tensor:
    """MulticlassAccuracy(top_k=k, average='micro', ignore_index=...)."""
    hit = (logits.topk(k, dim=-1).indices == targets[..., None]).any(-1)
    valid = targets != ignore_index
    return (hit & valid).sum() / valid.sum().clamp(min=1)


def _create_state(model: nn.Module, tcfg: TrainConfig, device) -> TrainState:
    init_random_(model, torch.Generator().manual_seed(tcfg.seed))
    model.to(device)
    opt, sched = make_adamw(model.parameters(), tcfg.initial_learning_rate, tcfg.warmup_steps,
                            tcfg.max_steps)
    gen = torch.Generator(device=device).manual_seed(tcfg.seed + 1)
    return TrainState(model, opt, sched, gen)


def train_device(device) -> torch.device:
    """``device`` as a torch device; raises for the card when there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training: device 'cuda' requested but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device


def create_plm_state(cfg: MegaPLMConfig, tcfg: TrainConfig, device="cuda") -> TrainState:
    """A MegaPLM with seeded random weights on ``device``, fp32, and its AdamW.
    The card unless the caller asks for the CPU; raises without a card."""
    with torch.no_grad():
        return _create_state(MegaPLM(cfg), tcfg, train_device(device))


def create_adm_state(cfg: MegaADMConfig, tcfg: TrainConfig, device="cuda") -> TrainState:
    """A MegaADM with seeded random weights on ``device``, fp32, and its AdamW.
    The card unless the caller asks for the CPU; raises without a card."""
    with torch.no_grad():
        return _create_state(MegaADM(cfg), tcfg, train_device(device))


def _on(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch on ``device``: numpy arrays uploaded, tensors moved (a
    batch already there, as ``tools/bench_train.py`` times, stays put)."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v)))
            .to(device, non_blocking=True) for k, v in batch.items()}


def _device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def _make_steps(loss_fn: Callable) -> tuple[Callable, Callable]:
    """(train_step, eval_step) around ``loss_fn(model, batch, train, generator)
    -> (loss, metrics)``."""

    def train_step(state: TrainState, batch: Dict[str, np.ndarray]) -> Metrics:
        state.opt.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.model, _on(batch, _device(state)), True, state.generator)
        loss.backward()
        state.opt.step()
        state.sched.step()
        state.step += 1
        return metrics

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, np.ndarray]) -> Metrics:
        return loss_fn(state.model, _on(batch, _device(state)), False, None)[1]

    return train_step, eval_step


def make_plm_train_step(cfg: MegaPLMConfig, tcfg: TrainConfig) -> tuple[Callable, Callable]:
    """(train_step, eval_step); each returns {"loss", "loss_sum", "ac10"}."""
    dtype = compute_dtype(tcfg)
    eos = cfg.eos_id

    def loss_fn(model, batch, train, generator):
        logits, target = model(batch["tc_latents"], batch["p_codes"].long(), batch["lens"],
                               train=train, generator=generator, dtype=dtype)
        logits = logits.float()
        valid = target != eos
        logp = F.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, target.masked_fill(~valid, 0)[..., None])[..., 0]
        loss = torch.where(valid, nll, 0.0).sum()  # reduction='sum', ignore eos
        # 'loss' is per-token (sum / (B * T)); 'loss_sum' the reference's summed CE
        loss_log = loss / target.shape[0] / target.shape[1]
        ac10 = top_k_accuracy(logits, target, 10, eos)
        return loss, {"loss": loss_log.detach(), "loss_sum": loss.detach(), "ac10": ac10}

    return _make_steps(loss_fn)


def make_adm_train_step(
    cfg: MegaADMConfig, tcfg: TrainConfig, mask_padding: bool = False
) -> tuple[Callable, Callable]:
    """(train_step, eval_step); each returns {"loss", "loss_sum"}."""
    dtype = compute_dtype(tcfg)

    def loss_fn(model, batch, train, generator):
        pred, target = model(batch["tc_latents"], batch["duration_tokens"], batch["lens"],
                             train=train, generator=generator, dtype=dtype)
        sq = (pred.float() - target) ** 2
        if mask_padding:
            pos = torch.arange(target.shape[1], device=target.device)[None, :]
            sq = torch.where(pos < batch["lens"][:, None], sq, 0.0)
        loss = sq.sum()
        # 'loss_sum' is the reference's summed MSE; 'loss' is per position
        loss_log = loss / target.shape[0] / target.shape[1]
        return loss, {"loss": loss_log.detach(), "loss_sum": loss.detach()}

    return _make_steps(loss_fn)
