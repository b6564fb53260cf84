"""PLM and ADM training steps (port of ``megatts2_tpu/training/lm_trainers.py``).

* PLM: summed cross-entropy over the code logits, ignoring targets equal to
  ``eos_id`` (vq_bins + 1), cast to fp32 before the log-softmax; the logged
  ``loss`` is the sum / B / T with T the padded target length, and ``ac10``
  the top-10 accuracy over non-eos targets.
* ADM: summed squared error of the predicted durations.  As in the
  reference, the sum INCLUDES padded positions unless ``mask_padding``.

On a data-parallel mesh (``state.mesh``, ``parallel.place_train_state``)
a step runs on this rank's rows of the global batch (``parallel.shard_batch``)
and, the losses being sums, SUMS the gradients over the data ranks (an
average would shrink JAX's gradient of the global sum by n_data); the
metrics are the global batch's (numerators and denominators summed), and
the dropout masks this rank's rows of the global masks.

A train step takes the tracer's ``train.batch_to_device``,
``train.forward``, ``train.backward`` and ``train.optimizer`` spans
(``utils/tracing.py``).

A :class:`TrainState` holds the model (fp32 master weights), AdamW, its
schedule, the dropout generator and the step count; a train step updates
it in place and returns its metrics as 0-d tensors, so the host waits on
the device only where the loop reads them.  Batches are dicts of numpy
arrays in ``PLMBatchBuilder`` / ``ADMBatchBuilder`` form; ``tc_latents``
arrives as fp16 and the model casts it to the compute dtype.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import MegaADMConfig, MegaPLMConfig, TrainConfig
from ..models import MegaADM, MegaPLM, init_random_
from ..nn import Draws
from ..parallel.collectives import data_sum, reduce_grads
from ..parallel.mesh import Mesh
from ..utils import tracing
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
    mesh: Optional[Mesh] = None  # set by parallel.place_train_state
    # a Draws that replaces ``generator``'s for the dropout masks (a test
    # replays recorded masks through it); None: drawn from ``generator``
    draws: Optional[Draws] = None


def compute_dtype(tcfg: TrainConfig) -> torch.dtype:
    if tcfg.train_dtype not in _DTYPES:
        raise ValueError(f"train_dtype {tcfg.train_dtype!r} not in {sorted(_DTYPES)}")
    return _DTYPES[tcfg.train_dtype]


def top_k_accuracy(logits: torch.Tensor, targets: torch.Tensor, k: int, ignore_index: int,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """MulticlassAccuracy(top_k=k, average='micro', ignore_index=...), over
    the global batch on a data-parallel ``mesh``."""
    hit = (logits.topk(k, dim=-1).indices == targets[..., None]).any(-1)
    valid = targets != ignore_index
    return data_sum((hit & valid).sum(), mesh) / data_sum(valid.sum(), mesh).clamp(min=1)


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
    """(train_step, eval_step) around ``loss_fn(model, batch, draws, mesh)
    -> (loss, metrics)`` (``draws`` None in eval)."""

    def train_step(state: TrainState, batch: Dict[str, np.ndarray]) -> Metrics:
        mesh = state.mesh
        state.opt.zero_grad(set_to_none=True)
        draws = state.draws or Draws(state.generator, rows=mesh.rows if mesh is not None else None)
        with tracing.span("train.batch_to_device", sum(v.nbytes for v in batch.values())):
            batch = _on(batch, _device(state))
        with tracing.span("train.forward"):
            loss, metrics = loss_fn(state.model, batch, draws, mesh)
        with tracing.span("train.backward"):
            loss.backward()
            if mesh is not None:
                reduce_grads(state.model.parameters(), mesh.data_group, average=False)
        with tracing.span("train.optimizer"):
            state.opt.step()
            state.sched.step()
        state.step += 1
        return metrics

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, np.ndarray]) -> Metrics:
        return loss_fn(state.model, _on(batch, _device(state)), None, state.mesh)[1]

    return train_step, eval_step


def _per_position(loss: torch.Tensor, target: torch.Tensor, mesh: Optional[Mesh]) -> tuple:
    """(the global summed loss, it over the global B·T) for the metrics."""
    total = data_sum(loss.detach(), mesh)
    n_data = mesh.n_data if mesh is not None else 1
    return total, total / (target.shape[0] * n_data) / target.shape[1]


def make_plm_train_step(cfg: MegaPLMConfig, tcfg: TrainConfig) -> tuple[Callable, Callable]:
    """(train_step, eval_step); each returns {"loss", "loss_sum", "ac10"}."""
    dtype = compute_dtype(tcfg)
    eos = cfg.eos_id

    def loss_fn(model, batch, draws, mesh):
        logits, target = model(batch["tc_latents"], batch["p_codes"].long(), batch["lens"],
                               train=draws is not None, dtype=dtype, draws=draws)
        logits = logits.float()
        valid = target != eos
        logp = F.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, target.masked_fill(~valid, 0)[..., None])[..., 0]
        loss = torch.where(valid, nll, 0.0).sum()  # reduction='sum', ignore eos
        # 'loss' is per-token (sum / (B * T)); 'loss_sum' the reference's summed CE
        loss_sum, loss_log = _per_position(loss, target, mesh)
        ac10 = top_k_accuracy(logits, target, 10, eos, mesh)
        return loss, {"loss": loss_log, "loss_sum": loss_sum, "ac10": ac10}

    return _make_steps(loss_fn)


def make_adm_train_step(
    cfg: MegaADMConfig, tcfg: TrainConfig, mask_padding: bool = False
) -> tuple[Callable, Callable]:
    """(train_step, eval_step); each returns {"loss", "loss_sum"}."""
    dtype = compute_dtype(tcfg)

    def loss_fn(model, batch, draws, mesh):
        pred, target = model(batch["tc_latents"], batch["duration_tokens"], batch["lens"],
                             train=draws is not None, dtype=dtype, draws=draws)
        sq = (pred.float() - target) ** 2
        if mask_padding:
            pos = torch.arange(target.shape[1], device=target.device)[None, :]
            sq = torch.where(pos < batch["lens"][:, None], sq, 0.0)
        loss = sq.sum()
        # 'loss_sum' is the reference's summed MSE; 'loss' is per position
        loss_sum, loss_log = _per_position(loss, target, mesh)
        return loss, {"loss": loss_log, "loss_sum": loss_sum}

    return _make_steps(loss_fn)
