"""VQ-GAN training step, generator and multi-window discriminator (port of
``megatts2_tpu/training/gan_trainer.py``).

Two AdamW optimizers, each with the cosine-warmup schedule over
``max_steps // 2``, alternate within one step, in the reference's order:
* ONE generator forward in train mode (dropout, the codebook's kmeans
  init on the first batch and its EMA update);
* the D step on the detached ŷ: LSGAN 0.5·E[(D(y) − 1)²] + 0.5·E[D(ŷ)²],
  the real pass then the fake pass updating BatchNorm's running
  statistics in that order, then ``d_opt.step()``;
* the G step against the UPDATED discriminator (a third BatchNorm
  update): L1(y, ŷ) + 0.15·commit + 0.05·vq + 1.0·0.5·E[(D(ŷ) − 1)²]
  (``TrainConfig``'s coefficients), back-propagated into G's parameters
  only (D's gradients stay as the D step left them);
* with ``g_ema_decay`` > 0, the EMA generator e ← d·e + (1 − d)·p.

Window starts, one per window length and shared by the batch, are drawn in
[0, max(L − window, 0)] with L the batch's longest ``mel_target_lens``
(the padded length without it); a window longer than L scores zero.
All randomness comes from the state's :class:`~megatts2_tpu_torch.nn.Draws`,
which a test may replace by one that replays injected values.

On a data-parallel mesh (``state.mesh``, ``parallel.place_train_state``)
the step runs on this rank's rows of the global batch; its losses are
means over equal shards, so the gradients are AVERAGED over the data
ranks, and the metrics are the means of the ranks' values.  The window
starts read the global batch's longest length; the codebook and the
BatchNorms keep global statistics (``quantization/vq.py``,
``models/dscrm.py``) and the draws the global masks' rows.

The step computes in ``train_dtype`` over fp32 master weights, the casts
written out in each layer; the losses, the codebook and the optimizers are
fp32.  Batches are dicts of numpy arrays in ``GANBatchBuilder``'s form;
``mel_targets`` and ``mel_timbres`` arrive as fp16 or fp32.  The metrics
are 0-d tensors, read by the host only where the loop logs them.

A train step takes the tracer's spans (``utils/tracing.py``), none of
which synchronises: ``gan.batch_to_device`` (``n`` = bytes handed over),
``gan.g_forward`` (``n`` = target frames, rows × padded length),
``gan.d_step`` (``n`` = rows), ``gan.g_step`` (the adversarial pass, the
loss, its backward and AdamW) and, with ``g_ema_decay`` > 0, ``gan.ema``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import DiscriminatorConfig, MegaGConfig, TrainConfig
from ..models import Discriminator, MegaG, init_random_
from ..nn import Draws
from ..parallel.collectives import data_mean, reduce_grads
from ..parallel.mesh import Mesh, full_batch
from ..quantization.vq import EuclideanCodebook
from ..utils import tracing
from .lm_trainers import Metrics, _on, train_device, compute_dtype
from .schedules import make_adamw


@dataclass
class GANTrainState:
    g: MegaG
    d: Discriminator
    g_opt: torch.optim.Optimizer
    g_sched: torch.optim.lr_scheduler.LRScheduler
    d_opt: torch.optim.Optimizer
    d_sched: torch.optim.lr_scheduler.LRScheduler
    draws: Draws  # dropout masks, codebook samples (device), window starts (host)
    step: int = 0
    # EMA copy of G's parameters by name when g_ema_decay > 0, taken from the
    # parameters the first train step starts from (so weights loaded into
    # ``g`` after ``create_gan_state`` seed it); None before that or without EMA
    g_ema: Optional[Dict[str, torch.Tensor]] = None
    mesh: Optional[Mesh] = None  # set by parallel.place_train_state


def create_gan_state(g_cfg: MegaGConfig, d_cfg: DiscriminatorConfig, tcfg: TrainConfig,
                     device="cuda") -> GANTrainState:
    """G and D with seeded random weights on ``device``, fp32, the codebook
    empty (kmeans-initialised by the first train step), and their AdamW.
    The card unless the caller asks for the CPU; raises without a card."""
    device = train_device(device)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(tcfg.seed)
        g, d = init_random_(MegaG(g_cfg), gen), init_random_(Discriminator(d_cfg), gen)
        for cb in g.modules():
            if isinstance(cb, EuclideanCodebook):
                for buf in cb.buffers():
                    buf.zero_()
        g.to(device)
        d.to(device)
    total = tcfg.max_steps // 2
    g_opt, g_sched = make_adamw(g.parameters(), tcfg.initial_learning_rate, tcfg.warmup_steps, total)
    d_opt, d_sched = make_adamw(d.parameters(), tcfg.initial_learning_rate, tcfg.warmup_steps, total)
    draws = Draws(torch.Generator(device=device).manual_seed(tcfg.seed + 1),
                  torch.Generator().manual_seed(tcfg.seed + 2))
    return GANTrainState(g, d, g_opt, g_sched, d_opt, d_sched, draws)


def _g_inputs(b: dict) -> tuple:
    return (b["duration_tokens"].long(), b["phone_tokens"].long(), b["tokens_lens"],
            b["mel_timbres"].float(), b["mel_targets"].float())


def make_gan_train_step(g_cfg: MegaGConfig, d_cfg: DiscriminatorConfig,
                        tcfg: TrainConfig) -> Callable[[GANTrainState, dict], Metrics]:
    """``train_step(state, batch)`` updates ``state`` in place and returns
    the nine metrics of the JAX step."""
    dtype = compute_dtype(tcfg)

    def train_step(state: GANTrainState, batch: Dict[str, np.ndarray]) -> Metrics:
        g, d, draws = state.g, state.d, state.draws
        if tcfg.g_ema_decay > 0 and state.g_ema is None:
            state.g_ema = {n: p.detach().clone() for n, p in g.named_parameters()}
        mesh = state.mesh
        with tracing.span("gan.batch_to_device", sum(v.nbytes for v in batch.values())):
            b = _on(batch, next(g.parameters()).device)
        B, T = batch["mel_targets"].shape[:2]
        lens = full_batch(batch).get("mel_target_lens")
        max_len = min(int(np.max(lens)), T) if lens is not None else T
        starts = draws.starts([max(max_len - wl, 0) for wl in d_cfg.time_lengths])

        def disc(mel):
            return d(mel, starts, True, max_len, draws, dtype)["y"].float()

        with tracing.span("gan.g_forward", B * T):
            y_hat, commit, vq_loss = g(*_g_inputs(b), True, draws, dtype)
            y_hat = y_hat.float()
            y = b["mel_targets"].float()

        with tracing.span("gan.d_step", B):
            state.d_opt.zero_grad(set_to_none=True)
            d_real = 0.5 * ((disc(y) - 1.0) ** 2).mean()
            d_fake = 0.5 * (disc(y_hat.detach()) ** 2).mean()
            d_loss = d_real + d_fake
            d_loss.backward()
            if mesh is not None:
                reduce_grads(d.parameters(), mesh.data_group, average=True)
            state.d_opt.step()
            state.d_sched.step()

        with tracing.span("gan.g_step"):
            g_params = list(g.parameters())
            state.g_opt.zero_grad(set_to_none=True)
            g_adv = 0.5 * ((disc(y_hat) - 1.0) ** 2).mean()
            g_re = (y - y_hat).abs().mean()
            g_loss = (g_re + commit * tcfg.G_commit_loss_coeff + vq_loss * tcfg.G_vq_loss_coeff
                      + g_adv * tcfg.G_adv_loss_coeff)
            g_loss.backward(inputs=g_params)
            if mesh is not None:
                reduce_grads(g_params, mesh.data_group, average=True)
            state.g_opt.step()
            state.g_sched.step()
        if state.g_ema is not None:
            k = tcfg.g_ema_decay
            with tracing.span("gan.ema"), torch.no_grad():
                for name, p in g.named_parameters():
                    e = state.g_ema[name]
                    e.copy_(e * k + p * (1.0 - k))
        state.step += 1
        cluster_size = g.vqpe.vq.layers[0]._codebook.cluster_size
        losses = {"D_loss_total": d_loss, "D_loss_real": d_real, "D_loss_fake": d_fake,
                  "G_loss_total": g_loss, "G_loss_adv": g_adv, "G_loss_re": g_re,
                  "G_loss_commit": commit, "G_loss_vq": vq_loss}
        return {**{k: data_mean(v.detach(), mesh) for k, v in losses.items()},
                "vq_code_usage": (cluster_size > 1.0).float().mean()}

    return train_step


def make_gan_eval_step(g_cfg: MegaGConfig) -> Callable[[GANTrainState, dict], Metrics]:
    """``eval_step(state, batch)`` → {"loss_re", "y_hat"}: G in eval mode at
    fp32, on the EMA weights when the state has them (with the live
    codebook, as JAX pairs ``g_ema`` with ``vq_stats``)."""

    @torch.no_grad()
    def eval_step(state: GANTrainState, batch: Dict[str, np.ndarray]) -> Metrics:
        g = state.g
        b = _on(batch, next(g.parameters()).device)
        if state.g_ema is None:
            y_hat, _, _ = g(*_g_inputs(b))
        else:
            y_hat, _, _ = torch.func.functional_call(g, state.g_ema, _g_inputs(b))
        loss_re = (b["mel_targets"].float() - y_hat.float()).abs().mean()
        return {"loss_re": data_mean(loss_re, state.mesh), "y_hat": y_hat}

    return eval_step


def make_gan_val_artifacts(g_cfg: MegaGConfig, out_dir: str, vocoder=None) -> Callable:
    """``artifact_fn(state, batch, step)`` for ``run_training``: the first
    validation utterance's target and output mels as
    ``<out_dir>/mel_step<step>.png`` (``.npz`` without matplotlib) and, with
    a ``vocoder`` module (the port's HiFi-GAN, on the state's device),
    ``audio_target_step<step>.wav`` and ``audio_hat_step<step>.wav``
    (reference ``trainer.py:154-188``).  The output is the eval step's
    (``g_ema`` when the state has it).  On a mesh every rank calls it (the
    eval step's collectives) and rank 0 writes."""
    import os

    from ..models import vocode
    from ..utils.audio import save_wav
    from ..utils.plotting import save_spectrogram_plot

    evaluate = make_gan_eval_step(g_cfg)
    os.makedirs(out_dir, exist_ok=True)

    @torch.no_grad()
    def artifact_fn(state: GANTrainState, batch: Dict[str, np.ndarray], step: int) -> None:
        y_hat = evaluate(state, batch)["y_hat"][0].float()
        if state.mesh is not None and not state.mesh.is_main:
            return
        y = torch.as_tensor(np.asarray(batch["mel_targets"][0], np.float32), device=y_hat.device)
        save_spectrogram_plot(os.path.join(out_dir, f"mel_step{step}"),
                              y.cpu().numpy().T, y_hat.cpu().numpy().T)
        if vocoder is not None:
            for label, mel in (("target", y), ("hat", y_hat)):
                wav = vocode(vocoder, mel[None])[0].cpu().numpy()
                save_wav(os.path.join(out_dir, f"audio_{label}_step{step}.wav"), wav)

    return artifact_fn
