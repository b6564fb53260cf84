"""The synthesis stack of a configuration file, built from the port with
the benchmark's weights, and the checks of its outputs against the
reference.

A configuration file holds the port's config dataclasses' fields under
``g`` (with ``mrte`` and ``vqpe``), ``plm``, ``adm`` and ``vocoder``
(Vocos), and ``dtype`` and ``quant_int8`` as ``Megatts`` takes them.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import reference as R
from .harness import sub_seed
from .weights import layout_of, make_weights

HOP, SR = 256, 16000
MODULES = ("g", "plm", "adm", "vocoder")


def port_configs(cfg: dict) -> Dict[str, object]:
    from megatts2_tpu_torch.config import (MegaADMConfig, MegaGConfig, MegaPLMConfig, MRTEConfig,
                                           VocosConfig, VQPEConfig)

    g = dict(cfg["g"])
    g_cfg = MegaGConfig(mrte=MRTEConfig(**g.pop("mrte")), vqpe=VQPEConfig(**g.pop("vqpe")), **g)
    return {"g": g_cfg, "plm": MegaPLMConfig(**cfg["plm"]), "adm": MegaADMConfig(**cfg["adm"]),
            "vocoder": VocosConfig(**cfg["vocoder"])}


def empty_modules(cfg: dict, device) -> Dict[str, torch.nn.Module]:
    from megatts2_tpu_torch.models import MegaADM, MegaG, MegaPLM, Vocos

    c = port_configs(cfg)
    kinds = {"g": MegaG, "plm": MegaPLM, "adm": MegaADM, "vocoder": Vocos}
    with torch.device(device):
        return {k: kinds[k](c[k]) for k in MODULES}


def stack_weights(layouts: Dict[str, list], cfg: dict, seed: int, device) -> Dict[str, dict]:
    """Each module's fp32 weights from the run's seed (Vocos' layer scale
    at 1 / num_layers, its published initial value), the leaves the
    configuration's ``init_scale`` names scaled by it."""
    scale = 1.0 / cfg["vocoder"]["num_layers"]
    out = {k: make_weights(layouts[k], sub_seed(seed, "weights", k), device, scale)
           for k in MODULES}
    for k, leaves in cfg.get("init_scale", {}).items():
        for name, factor in leaves.items():
            out[k][name].mul_(factor)
    return out


def build(cfg: dict, seed: int, device, work_dir) -> tuple:
    """(``Megatts`` over the port's modules with the seed's weights, their
    layouts): cast and quantised as ``Megatts`` does it."""
    from megatts2_tpu_torch.models import Megatts

    mods = empty_modules(cfg, device)
    layouts = {k: layout_of(m) for k, m in mods.items()}
    weights = stack_weights(layouts, cfg, seed, device)
    for k, m in mods.items():
        m.load_state_dict(weights[k], strict=True)
    del weights
    work_dir.mkdir(parents=True, exist_ok=True)
    symbols = work_dir / "symbols.txt"
    symbols.write_text("")
    mt = Megatts(mods["g"], mods["plm"], mods["adm"], mods["vocoder"], str(symbols),
                 dtype=getattr(torch, cfg["dtype"]), device=device, quant_int8=cfg["quant_int8"])
    return mt, layouts


def prompt_waves(seed: int, n: int, frames: int, device) -> torch.Tensor:
    """``n`` prompt waveforms whose log-mels have ``frames`` frames: noise
    under a few seeded partials, as a pool of speakers' samples."""
    N = (frames - 1) * HOP
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "prompts"))
    t = torch.arange(N, device=device, dtype=torch.float32) / SR
    f0 = 80 + 160 * torch.rand(n, 1, generator=gen, device=device)
    amp = 0.3 * torch.rand(n, 4, 1, generator=gen, device=device)
    harm = torch.arange(1, 5, device=device, dtype=torch.float32)[None, :, None]
    wav = (amp * torch.sin(2 * np.pi * f0[:, None, :] * harm * t)).sum(1)
    return wav + 0.05 * torch.randn(n, N, generator=gen, device=device)


# ---------------------------------------------------------------- checks


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||."""
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))


def frames_err(raw: torch.Tensor, raw_ref: torch.Tensor) -> float:
    """RMS of the raw durations' difference over the reference's RMS, or
    over one frame where that is smaller: an error of a hundredth of a
    frame is a hundredth however short the phones."""
    rms = lambda x: float(x.float().pow(2).mean().sqrt())  # noqa: E731
    return rms(raw.float() - raw_ref.float()) / max(rms(raw_ref), 1.0)


def duration_gap(raw_ref: torch.Tensor, dt: torch.Tensor, max_dt: int) -> float:
    """The widest distance from a reference raw duration to the raw values
    that round to the duration the judged side took: (d - 0.5, d + 0.5],
    open below at 1 and above at ``max_dt``."""
    d = dt.float()
    lo = torch.where(d <= 1, torch.full_like(d, -np.inf), d - 0.5)
    hi = torch.where(d >= max_dt, torch.full_like(d, np.inf), d + 0.5)
    return float(torch.clamp(torch.maximum(lo - raw_ref, raw_ref - hi), min=0).max())


def mel_gap(wav: torch.Tensor, wav_ref: torch.Tensor) -> float:
    """Mean |log-mel difference| (nepers) of two waveforms, the reference's
    log-mel of each: the audio's spectral envelope, which a vocoder's
    phase error leaves alone."""
    if wav_ref.numel() < R.WIN:
        return 0.0
    return float((R.log_mel(wav.float()) - R.log_mel(wav_ref.float())).abs().mean())


def token_gap(logits_ref: torch.Tensor, codes: torch.Tensor) -> float:
    """The widest gap by which a taken code's reference logit lies below
    the reference's best at that position."""
    taken = logits_ref.gather(-1, codes[..., None].long())[..., 0]
    return float((logits_ref.max(-1).values - taken).max())


class Reference:
    """The reference over one batch of inputs: its own mel of the prompt
    waveforms and MRTE latent; the ADM over that latent, teacher-forced
    with the judged side's raw predictions; the PLM teacher-forced with its
    codes, and the decoder and vocoder fed its durations and codes (as a
    served model's tokens are: the reference runs over them)."""

    def __init__(self, weights: Dict[str, dict], cfg: dict, precision: R.Precision):
        self.W, self.cfg, self.P = weights, cfg, precision

    def latent(self, phone, lens, waves):
        """The MRTE latent from the reference's own mel of the prompts."""
        mel = torch.stack([R.log_mel(w) for w in waves])
        return R.tc_latent(self.W["g"], self.cfg["g"]["mrte"], phone, lens, mel, self.P)

    def durations(self, tc, fed):
        """The ADM's raw predictions over the latent ``tc``, teacher-forced
        with the judged side's raw predictions ``fed``."""
        return R.adm_raw(self.W["adm"], self.cfg["adm"], tc.float(), fed.float(), self.P)

    def back(self, tc, lens, dt, codes, max_frames):
        pos = torch.arange(dt.shape[1], device=dt.device)[None, :]
        dt = torch.where(pos < lens[:, None], dt, 0)
        frames = R.regulate(tc, dt, max_frames)
        plm = self.cfg["plm"]
        prev = torch.cat([torch.full_like(codes[:, :1], plm["vq_bins"]), codes[:, :-1]], 1)
        logits = R.plm_logits(self.W["plm"], plm, R.max_pool8(frames), prev.long(), self.P,
                              quant=bool(self.cfg["quant_int8"]))
        mel = R.mel_decoder(self.W["g"], self.cfg["g"], frames, codes.long(), self.P)
        wav = R.vocos(self.W["vocoder"], self.cfg["vocoder"], mel, self.P)
        return logits, mel, wav


def adm_durations(raw: torch.Tensor, max_dt: int) -> torch.Tensor:
    """Raw predictions to durations as the configuration states: + 0.5,
    truncated, clamped to [1, max_dt]."""
    return torch.clamp((raw + 0.5).to(torch.int32), 1, max_dt).long()


def adm_scale(ref: Reference, phone, lens, waves, fed, raw_ref, valid) -> float:
    """The MRTE's and the ADM's rounding error on these inputs when their
    operands are bf16 (``frames_err`` of the reference so computed, from
    its own latent): how sensitive this seed's random stack is.  A sound
    bf16 program's error is of that size, wherever it lies between seeds
    (6× apart), and a lower precision's is several times larger."""
    emulated = Reference(ref.W, ref.cfg, R.Precision("bf16", ref.P.quant_bits))
    raw = emulated.durations(emulated.latent(phone, lens, waves), fed)
    return frames_err(raw[valid], raw_ref[valid])


@torch.no_grad()
def judge_sample(ref: Reference, sample: dict, inputs: dict, max_frames: int,
                 control: Optional[Reference] = None) -> Dict[str, float]:
    """The numbers compared for one synthesised batch: of the program's
    outputs in ``sample`` (tc, dt, codes, mel, wavs), or, with ``control``,
    of the control put in the program's place on the same inputs and the
    program's durations and codes."""
    phone, lens, waves = inputs["phone"], inputs["lens"], inputs["waves"]
    max_dt = ref.cfg["adm"]["max_duration_token"]
    tc_ref = ref.latent(phone, lens, waves)
    raw_ref = ref.durations(tc_ref, sample["raw"])
    dt, codes = sample["dt"], sample["codes"]
    logits_ref, mel_ref, wav_ref = ref.back(tc_ref, lens, dt, codes, max_frames)
    valid = torch.arange(phone.shape[1], device=phone.device)[None, :] < lens[:, None]
    if control is None:
        tc, mel, wav, taken = sample["tc"], sample["mel"], sample["wav"], codes
        raw = sample["raw"]
    else:
        tc = control.latent(phone, lens, waves)
        raw = control.durations(tc, sample["raw"])
        logits_c, mel, wav = control.back(tc, lens, dt, codes, max_frames)
        taken = logits_c.argmax(-1)
    n = sample["n_frames"]
    wav_ref = torch.cat([wav_ref[b, : int(n[b]) * HOP] for b in range(len(n))])
    wav = torch.cat([wav[b, : int(n[b]) * HOP] for b in range(len(n))]) \
        if wav.dim() == 2 else wav
    wav = wav.to(wav_ref.device)
    scale = adm_scale(ref, phone, lens, waves, sample["raw"], raw_ref, valid)
    return {
        "adm_ratio": frames_err(raw[valid], raw_ref[valid]) / max(scale, 1e-6),
        "tc_rel": rel(tc.float()[valid], tc_ref[valid]),
        "dur_gap": duration_gap(raw_ref[valid], adm_durations(raw, max_dt)[valid], max_dt),
        "plm_gap": token_gap(logits_ref, taken),
        "mel_rel": rel(mel, mel_ref),
        "wav_rel": rel(wav, wav_ref) if wav_ref.numel() else 0.0,
        "wav_mel_gap": mel_gap(wav, wav_ref),
    }
