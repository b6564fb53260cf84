"""Vocoder GAN training: a HiFi-GAN or Vocos generator against the MPD + MSD
wave discriminator (port of ``megatts2_tpu/training/vocoder_trainer.py``).

HiFi-GAN's recipe: LSGAN terms over every sub-discriminator,
feature-matching L1 (``fm_loss_coeff`` 2), mel L1 (``mel_loss_coeff`` 45),
two AdamW (b1 0.8, b2 0.99, optax's eps 1e-8 and weight decay 1e-4 on every
parameter) under ``optax.exponential_decay`` (continuous), read at the count
of updates taken.  One step, in JAX's order:
* the target mel of the waveform crop, under no grad (kernel A on the card);
* ONE generator forward, mel → ŷ, in ``train_dtype`` over fp32 masters;
* the D step on ŷ detached: Σ E[(1 − D(y))²] + E[D(ŷ)²] over the
  sub-discriminators, then ``d_opt.step()``;
* the G step against the UPDATED D: Σ E[(1 − D(ŷ))²] + 2 · Σ mean|f(y) −
  f(ŷ)| (fp32 over the compute dtype's features, the real ones under no
  grad) + 45 · mean|mel − mel(ŷ)|, back-propagated into G's parameters only
  (D's gradients stay as the D step left them); the mel of ŷ goes through
  kernel A and its backward on the card.

On a data-parallel mesh (``state.mesh``) the step runs on this rank's rows
of the global batch and AVERAGES the gradients over the data ranks (the
losses are means over equal shards); the metrics are the ranks' means.

The discriminator's logits are cast to fp32; the losses and optimizers are
fp32.  Batches are dicts with ``wav`` (B, segment_frames · 256) fp32, numpy
or tensors.  Metrics are 0-d tensors, read by the host only where the loop
logs them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..config import HiFiGANConfig, VocoderTrainConfig, VocosConfig, WaveDiscConfig
from ..models import HiFiGAN, Vocos, init_random_, vocode
from ..models.wave_dscrm import WaveDiscriminator
from ..ops.mel import mel_spectrogram
from ..parallel.collectives import data_mean, reduce_grads
from ..parallel.mesh import Mesh
from .lm_trainers import Metrics, train_device, compute_dtype
from .schedules import adamw, exponential_decay

VocoderConfig = Union[HiFiGANConfig, VocosConfig]


@dataclass
class VocoderTrainState:
    g: Union[HiFiGAN, Vocos]
    d: WaveDiscriminator
    g_opt: torch.optim.Optimizer
    g_sched: torch.optim.lr_scheduler.LRScheduler
    d_opt: torch.optim.Optimizer
    d_sched: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
    mesh: Optional[Mesh] = None  # set by parallel.place_train_state


def _make_opt(params, tcfg: VocoderTrainConfig):
    sched = exponential_decay(tcfg.initial_learning_rate, tcfg.lr_decay_steps, tcfg.lr_decay)
    return adamw(params, sched, weight_decay=1e-4, b1=tcfg.adam_b1, b2=tcfg.adam_b2)


def create_vocoder_state(voc_cfg: VocoderConfig, d_cfg: WaveDiscConfig, tcfg: VocoderTrainConfig,
                         device="cuda") -> VocoderTrainState:
    """The generator (the family ``voc_cfg``'s type selects) and the wave
    discriminator with seeded random weights on ``device``, fp32, and their
    AdamW.  The card unless the caller asks for the CPU; raises without a
    card."""
    device = train_device(device)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(tcfg.seed)
        g = Vocos(voc_cfg) if isinstance(voc_cfg, VocosConfig) else HiFiGAN(voc_cfg)
        g, d = init_random_(g, gen), init_random_(WaveDiscriminator(d_cfg), gen)
        g.to(device)
        d.to(device)
    g_opt, g_sched = _make_opt(g.parameters(), tcfg)
    d_opt, d_sched = _make_opt(d.parameters(), tcfg)
    return VocoderTrainState(g, d, g_opt, g_sched, d_opt, d_sched)


def _wav(batch: dict, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(batch["wav"]).to(device, torch.float32, non_blocking=True)


def make_vocoder_train_step(voc_cfg: VocoderConfig, d_cfg: WaveDiscConfig,
                            tcfg: VocoderTrainConfig) -> Callable[[VocoderTrainState, dict], Metrics]:
    """``train_step(state, batch)`` updates ``state`` in place and returns
    the six metrics of the JAX step."""
    dtype = compute_dtype(tcfg)
    T = tcfg.segment_frames

    def train_step(state: VocoderTrainState, batch: Dict[str, np.ndarray]) -> Metrics:
        g, d = state.g, state.d
        wav = _wav(batch, next(g.parameters()).device)
        with torch.no_grad():
            mel = mel_spectrogram(wav)[:, :T]
        y_hat = vocode(g, mel, dtype)

        def logits(w):
            lg, feats = d(w, dtype)
            return [x.float() for x in lg], feats

        state.d_opt.zero_grad(set_to_none=True)
        l_real, _ = logits(wav)
        l_fake, _ = logits(y_hat.detach())
        d_loss = sum(((1.0 - r) ** 2).mean() + (f ** 2).mean() for r, f in zip(l_real, l_fake))
        d_loss.backward()
        if state.mesh is not None:
            reduce_grads(d.parameters(), state.mesh.data_group, average=True)
        state.d_opt.step()
        state.d_sched.step()

        g_params = list(g.parameters())
        state.g_opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            _, f_real = d(wav, dtype)
        l_fake, f_fake = logits(y_hat)
        loss_adv = sum(((1.0 - x) ** 2).mean() for x in l_fake)
        loss_fm = sum((fr.float() - ff.float()).abs().mean()
                      for frs, ffs in zip(f_real, f_fake) for fr, ff in zip(frs, ffs))
        loss_mel = (mel - mel_spectrogram(y_hat)[:, :T]).abs().mean()
        g_loss = loss_adv + tcfg.fm_loss_coeff * loss_fm + tcfg.mel_loss_coeff * loss_mel
        g_loss.backward(inputs=g_params)
        if state.mesh is not None:
            reduce_grads(g_params, state.mesh.data_group, average=True)
        state.g_opt.step()
        state.g_sched.step()
        state.step += 1
        m = {"D_loss_total": d_loss, "G_loss_total": g_loss, "G_loss_adv": loss_adv,
             "G_loss_fm": loss_fm, "G_loss_mel": loss_mel, "loss": loss_mel}
        return {k: data_mean(v.detach(), state.mesh) for k, v in m.items()}

    return train_step


def make_vocoder_eval_step(voc_cfg: VocoderConfig,
                           tcfg: VocoderTrainConfig) -> Callable[[VocoderTrainState, dict], Metrics]:
    """``eval_step(state, batch)`` → {"loss": mel L1, "y_hat"}: G at fp32."""
    T = tcfg.segment_frames

    @torch.no_grad()
    def eval_step(state: VocoderTrainState, batch: Dict[str, np.ndarray]) -> Metrics:
        wav = _wav(batch, next(state.g.parameters()).device)
        mel = mel_spectrogram(wav)[:, :T]
        y_hat = vocode(state.g, mel, torch.float32)
        loss = (mel - mel_spectrogram(y_hat)[:, :T]).abs().mean()
        return {"loss": data_mean(loss, state.mesh), "y_hat": y_hat}

    return eval_step
