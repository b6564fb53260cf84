"""Training-step throughput at reference size (port of ``tools/bench_train.py``).

    python -m megatts2_tpu_torch.tools.bench_train [batch] [--stages gan,plm,adm,vocoder] [--device cuda]

Prints one JSON line per stage with steps/s, on synthetic batches shaped
like the production configs, every stage in bf16 over fp32 masters on the
port's own trainers:

* ``plm``: ``MegaPLMConfig()`` (``use_flash``: kernels B and C in every
  layer) at L=1024, ``tokens_per_sec``;
* ``adm``: ``MegaADMConfig(tc_emb_dim=512)`` at T=64, ``tokens_per_sec``;
* ``vocoder``: Vocos + the wave discriminators on 64-frame crops (kernel A
  and its backward), ``audio_sec_per_sec``;
* ``gan``: ``MegaGConfig()`` + ``DiscriminatorConfig()`` at Tp=64, 512
  timbre and 512 target frames, ``mel_frames_per_sec``, ``gflop_per_step``
  (``utils/flops.gan_step_flops``) and ``mfu`` against the H100's bf16
  peak (None off the card).

Each step is timed as JAX's ``_timed_steps``: the batch is moved to the
device first (the GAN's target lengths stay on the host, where its step
reads them), one warm step, then 10 steps between two synchronisations.
Every line carries the card's name and power limit (``nvidia-smi``).  Runs on
the card unless given ``--device cpu``; without a card it raises.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import config as c
from ..training.lm_trainers import train_device
from .bw_ceiling import card_name

ITERS = 10
SR, HOP = 16000, 256


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_device(batch: dict, device: torch.device) -> dict:
    """The batch on ``device``, but for the target lengths: the GAN step
    reads their maximum on the host, so they stay numpy, as ``cli fit``'s
    batches give them (on the card, every step would wait on it)."""
    return {k: v if k == "mel_target_lens" else torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _timed_steps(step: Callable, state, batch: dict, device: torch.device) -> float:
    """Seconds per step: the batch on the device first, one warm step, then
    ITERS steps ending in a synchronisation and the metrics read."""
    batch = to_device(batch, device)
    m = step(state, batch)
    [float(v) for v in m.values()]
    sync(device)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        m = step(state, batch)
    sync(device)
    [float(v) for v in m.values()]
    return (time.perf_counter() - t0) / ITERS


def plm_batch(cfg: c.MegaPLMConfig, B: int, L: int) -> dict:
    """``tools/bench_train.py``'s PLM batch: every row L codes long."""
    rng = np.random.RandomState(0)
    return {"p_codes": rng.randint(0, cfg.vq_bins, (B, L + 1)).astype(np.int32),
            "tc_latents": rng.randn(B, L, cfg.tc_latent_dim).astype(np.float32),
            "lens": np.full((B,), L, np.int32)}


def adm_batch(cfg: c.MegaADMConfig, B: int, T: int) -> dict:
    """``tools/bench_train.py``'s ADM batch: durations 1-8 after a 0."""
    rng = np.random.RandomState(0)
    return {"tc_latents": rng.randn(B, T, cfg.tc_latent_dim).astype(np.float32),
            "duration_tokens": np.concatenate(
                [np.zeros((B, 1, 1), np.float32),
                 rng.randint(1, 9, (B, T, 1)).astype(np.float32)], axis=1),
            "lens": np.full((B,), T, np.int32)}


def gan_batch(B: int, Tp: int, Tm: int, Tt: int, vocab: int = 320) -> dict:
    """``tools/bench_train.py``'s GAN batch: durations 1-8, every row full."""
    rng = np.random.RandomState(0)
    return {"duration_tokens": rng.randint(1, 9, (B, Tp)).astype(np.int32),
            "phone_tokens": rng.randint(0, vocab, (B, Tp)).astype(np.int32),
            "tokens_lens": np.full((B,), Tp, np.int32),
            "mel_timbres": rng.randn(B, Tt, 80).astype(np.float32),
            "mel_targets": rng.randn(B, Tm, 80).astype(np.float32),
            "mel_target_lens": np.full((B,), Tm, np.int32)}


def build_plm_step(B: int = 8, L: int = 1024, device="cuda",
                   cfg: Optional[c.MegaPLMConfig] = None) -> tuple:
    """(step, state, batch, loss key) of the PLM at ``cfg`` (default
    ``MegaPLMConfig()``), bf16."""
    from ..training import create_plm_state, make_plm_train_step

    cfg = cfg or c.MegaPLMConfig()
    tcfg = c.TrainConfig(train_dtype="bfloat16", max_steps=100_000)
    state = create_plm_state(cfg, tcfg, device=train_device(device))
    return make_plm_train_step(cfg, tcfg)[0], state, plm_batch(cfg, B, L), "loss"


def build_adm_step(B: int = 8, T: int = 64, device="cuda",
                   cfg: Optional[c.MegaADMConfig] = None) -> tuple:
    """(step, state, batch, loss key) of the ADM at ``cfg`` (default
    ``MegaADMConfig(tc_emb_dim=512)``), bf16."""
    from ..training import create_adm_state, make_adm_train_step

    cfg = cfg or c.MegaADMConfig(tc_emb_dim=512)
    tcfg = c.TrainConfig(train_dtype="bfloat16", max_steps=100_000)
    state = create_adm_state(cfg, tcfg, device=train_device(device))
    return make_adm_train_step(cfg, tcfg)[0], state, adm_batch(cfg, B, T), "loss"


def build_vocoder_step(B: int = 8, device="cuda", voc_cfg=None,
                       d_cfg: Optional[c.WaveDiscConfig] = None) -> tuple:
    """(step, state, batch, loss key) of the vocoder GAN (default Vocos and
    the wave discriminators), bf16, on ``segment_frames`` crops of noise."""
    from ..training import create_vocoder_state, make_vocoder_train_step

    tcfg = c.VocoderTrainConfig(train_dtype="bfloat16")
    voc_cfg, d_cfg = voc_cfg or c.VocosConfig(), d_cfg or c.WaveDiscConfig()
    rng = np.random.RandomState(0)
    batch = {"wav": rng.randn(B, tcfg.segment_frames * HOP).astype(np.float32)}
    state = create_vocoder_state(voc_cfg, d_cfg, tcfg, device=train_device(device))
    return make_vocoder_train_step(voc_cfg, d_cfg, tcfg), state, batch, "G_loss_total"


def build_gan_step(B: int = 8, Tm: int = 512, Tp: int = 64, Tt: int = 512, device="cuda",
                   g_cfg: Optional[c.MegaGConfig] = None,
                   d_cfg: Optional[c.DiscriminatorConfig] = None) -> tuple:
    """(step, state, batch, loss key) of the VQ-GAN (default
    ``MegaGConfig()`` and ``DiscriminatorConfig()``), bf16."""
    from ..training import create_gan_state, make_gan_train_step

    g_cfg, d_cfg = g_cfg or c.MegaGConfig(), d_cfg or c.DiscriminatorConfig()
    tcfg = c.TrainConfig(train_dtype="bfloat16", max_steps=600_000)
    state = create_gan_state(g_cfg, d_cfg, tcfg, device=train_device(device))
    batch = gan_batch(B, Tp, Tm, Tt, g_cfg.mrte.phone_vocab_size)
    return make_gan_train_step(g_cfg, d_cfg, tcfg), state, batch, "G_loss_total"


def _record(metric: str, dt: float, detail: dict, device: torch.device, emit: Callable) -> dict:
    rec = {"metric": metric, "value": round(1.0 / dt, 3), "unit": "steps/s",
           "detail": {**detail, "step_ms": round(dt * 1000, 2), "device": card_name(device)}}
    emit(json.dumps(rec))
    return rec


def bench_lm(which: str, B: int, device="cuda", cfg=None, length: Optional[int] = None,
             emit: Callable = print) -> dict:
    """``{which}_train_steps_per_sec`` of the PLM (L = ``length`` or 1024) or
    the ADM (T = ``length`` or 64)."""
    device = train_device(device)
    if which == "plm":
        L = length or 1024  # multi-utterance prompt-prefix scale
        step, state, batch, _ = build_plm_step(B, L, device, cfg)
    else:
        L = length or 64
        step, state, batch, _ = build_adm_step(B, L, device, cfg)
    dt = _timed_steps(step, state, batch, device)
    return _record(f"{which}_train_steps_per_sec", dt,
                   {"batch": B, "tokens_per_sec": round(B * L / dt, 1)}, device, emit)


def bench_vocoder(B: int, device="cuda", voc_cfg=None, d_cfg=None,
                  emit: Callable = print) -> dict:
    """``vocoder_train_steps_per_sec``, with the audio seconds trained a second."""
    device = train_device(device)
    step, state, batch, _ = build_vocoder_step(B, device, voc_cfg, d_cfg)
    dt = _timed_steps(step, state, batch, device)
    samples = batch["wav"].shape[1]
    return _record("vocoder_train_steps_per_sec", dt,
                   {"batch": B, "audio_sec_per_sec": round(B * samples / SR / dt, 1)}, device, emit)


def bench_gan(B: int, device="cuda", g_cfg=None, d_cfg=None, Tm: int = 512, Tp: int = 64,
              Tt: int = 512, emit: Callable = print) -> dict:
    """``gan_train_steps_per_sec`` with mel frames a second, the step's
    modelled GFLOP and its MFU against the H100's bf16 peak (on the card)."""
    from ..utils.flops import PEAK_FLOPS, gan_step_flops

    device = train_device(device)
    g_cfg = g_cfg or c.MegaGConfig()
    step, state, batch, _ = build_gan_step(B, Tm, Tp, Tt, device, g_cfg, d_cfg)
    dt = _timed_steps(step, state, batch, device)
    fl = gan_step_flops(g_cfg, B, Tp, Tm, Tt)
    mfu = round(fl / dt / PEAK_FLOPS["bf16"], 4) if device.type == "cuda" else None
    return _record("gan_train_steps_per_sec", dt,
                   {"batch": B, "mel_frames_per_sec": round(B * Tm / dt, 1),
                    "gflop_per_step": round(fl / 1e9, 1), "mfu": mfu}, device, emit)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", type=int, nargs="?", default=8)
    ap.add_argument("--stages", default="gan", help="comma list from {gan,plm,adm,vocoder}")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    stages = args.stages.split(",")
    unknown = set(stages) - {"gan", "plm", "adm", "vocoder"}
    if unknown:
        raise SystemExit(f"bench_train: unknown stages {sorted(unknown)}")
    train_device(args.device)
    records = []
    for s in stages:
        if s in ("plm", "adm"):
            records.append(bench_lm(s, args.batch, args.device))
        elif s == "vocoder":
            records.append(bench_vocoder(args.batch, args.device))
    if "gan" in stages:
        records.append(bench_gan(args.batch, args.device))
    return records


if __name__ == "__main__":
    main()
