"""Streaming zero-shot synthesis: incremental PLM decode and chunked mel
decode / vocode over receptive-field-exact windows (port of
``megatts2_tpu/models/streaming.py``).

The content path (MRTE → ADM → length regulation) runs once
(:func:`stream_prep`); prosody codes then come out of the KV-cached PLM in
chunks (:func:`plm_stream_start`, :func:`plm_stream_chunk`), and each audio
chunk of F frames is emitted as soon as the codes it depends on exist
(:func:`emit_chunk`).  The MegaG decoder and the vocoder are convolutions
of finite receptive field: a chunk of frames [a, a+F) is computed from a
window padded by the decoder's field (``rd``) and the vocoder's (``rv``)
on each side, clamped to the sequence, and trimmed, so the concatenated
chunks equal the one-shot ``synthesize`` at the stream's frame budget.
All window arithmetic is 8-frame aligned, so code windows slice cleanly.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from .. import HIFIGAN_HOP_LENGTH
from ..config import HiFiGANConfig, MegaGConfig, VocosConfig
from ..ops import regulate_length
from .adm import adm_infer
from .fast_decode import pick, plm_decode_step
from .megatts import max_pool_time, vocode


def _roundup(x: int, m: int) -> int:
    return -(-x // m) * m


def decoder_rf_frames(g_cfg: MegaGConfig) -> int:
    """One-sided receptive field of the MegaG mel decoder in mel frames
    (first conv, n_stack × n_block ConvBlocks, last conv; one kernel size)."""
    n_convs = g_cfg.decoder_n_stack * g_cfg.decoder_n_block + 2
    return (g_cfg.kernel_size - 1) // 2 * n_convs


def vocoder_rf_frames(cfg) -> int:
    """One-sided receptive field of the vocoder in mel frames, by config
    type.  Vocos: embed k=7 (3) + num_layers depthwise k=7 convs (3 each),
    plus ``n_fft/hop - 1`` frames of iSTFT overlap."""
    if isinstance(cfg, VocosConfig):
        return 3 + 3 * cfg.num_layers + (cfg.n_fft // cfg.hop_length - 1)
    return hifigan_rf_frames(cfg)


def hifigan_rf_frames(cfg: HiFiGANConfig) -> int:
    """One-sided receptive field of the HiFi-GAN generator in mel frames (a
    conservative walk back from the output through conv_post, each MRF bank
    and each transposed conv)."""
    mrf = max((k - 1) // 2 * (sum(ds) + len(ds))
              for k, ds in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes))
    r = 3  # conv_post k=7
    for rate, kern in zip(cfg.upsample_rates[::-1], cfg.upsample_kernel_sizes[::-1]):
        r += mrf
        r = -(-(r + kern) // rate)
    return r + 3  # conv_pre k=7


def stream_geometry(g_cfg: MegaGConfig, voc_cfg, max_frames: int, chunk_frames: int):
    """(F, rv, rd, Tmax): the chunk, both receptive-field pads (8-aligned)
    and the frame budget, a multiple of F and at least one full window."""
    F = _roundup(chunk_frames, 8)
    rv = _roundup(vocoder_rf_frames(voc_cfg), 8)
    rd = _roundup(decoder_rf_frames(g_cfg), 8)
    return F, rv, rd, max(_roundup(max_frames, F), F + 2 * (rv + rd))


@torch.inference_mode()
def stream_prep(g, adm, phone: torch.Tensor, lens: torch.Tensor, mels_prompt: torch.Tensor,
                max_frames: int):
    """The content path once: MRTE latent → durations → length regulation
    → ×8 pool.  (tc_expand (B, Tf, H), tc_plm (B, Tf/8, H), n_frames (B,))."""
    tc_latent = g.mrte.tc_latent(phone, mels_prompt, lens)
    dt = adm_infer(adm, tc_latent.float())
    pos = torch.arange(dt.shape[1], device=dt.device)[None, :]
    dt = torch.where(pos < lens[:, None], dt, torch.zeros_like(dt))
    n_frames = torch.clamp(dt.sum(dim=1), max=max_frames)
    tc_expand = regulate_length(tc_latent, dt, max_frames)
    return tc_expand, max_pool_time(tc_expand, 8), n_frames


@torch.inference_mode()
def plm_stream_start(plm, tc_plm: torch.Tensor, max_decode_len: int, temperature: float = 0.0,
                     top_k: int = 0, generator: Optional[torch.Generator] = None):
    """Step 0: new KV caches of ``max_decode_len`` positions and the first code."""
    B = tc_plm.shape[0]
    tc = tc_plm.to(plm.plm.dtype)
    caches = plm.plm.new_cache(B, max_decode_len, tc)
    bos = torch.full((B,), plm.cfg.bos_id, dtype=torch.long, device=tc.device)
    logits = plm_decode_step(plm, tc[:, 0], bos, caches, 0)
    return caches, pick(logits, 0, temperature, top_k, generator, None)


@torch.inference_mode()
def plm_stream_chunk(plm, caches, prev: torch.Tensor, tc_plm: torch.Tensor, t0: int,
                     n_steps: int, temperature: float = 0.0, top_k: int = 0,
                     generator: Optional[torch.Generator] = None):
    """``n_steps`` codes from position ``t0``: (last code (B,), codes (B, n_steps))."""
    tc = tc_plm.to(plm.plm.dtype)
    Tc = tc.shape[1]
    out = []
    for t in range(t0, t0 + n_steps):
        t = min(t, Tc - 1)
        logits = plm_decode_step(plm, tc[:, t], prev, caches, t)
        prev = pick(logits, t, temperature, top_k, generator, None)
        out.append(prev)
    return prev, torch.stack(out, dim=1)


def emit_window(a: int, F: int, rv: int, rd: int, Tmax: int) -> tuple[int, int]:
    """(s, mv): the decoder window [s, s + F + 2(rv+rd)) and the vocoder
    window [mv, mv + F + 2rv) of the chunk of frames [a, a+F), both clamped
    into [0, Tmax)."""
    W = F + 2 * (rv + rd)
    s = min(max(a - rv - rd, 0), Tmax - W)
    mv = min(max(a - rv, s), s + W - (F + 2 * rv))
    return s, mv


@torch.inference_mode()
def emit_chunk(g, vocoder, tc_expand: torch.Tensor, codes: torch.Tensor, a: int, F: int,
               rv: int, rd: int) -> torch.Tensor:
    """Audio (B, F*hop) fp32 of frames [a, a+F): the mel over the decoder
    window, vocoded over the vocoder window, trimmed.  ``codes`` (B,
    Tmax/8) need be decoded only as far as the window reaches."""
    Tmax = tc_expand.shape[1]
    W = F + 2 * (rv + rd)
    if Tmax < W:
        raise ValueError(f"frame budget {Tmax} below one window {W}")
    s, mv = emit_window(a, F, rv, rd, Tmax)
    zq = g.vqpe.vq.decode(codes[None, :, s // 8:(s + W) // 8]).repeat_interleave(8, dim=1)
    mel = g.decode_latents(tc_expand[:, s:s + W], zq)
    wav = vocode(vocoder, mel[:, mv - s:mv - s + F + 2 * rv].float())
    off = (a - mv) * HIFIGAN_HOP_LENGTH
    return wav[:, off:off + F * HIFIGAN_HOP_LENGTH]


def _trim(wav: np.ndarray, j: int, F: int, total: int) -> np.ndarray:
    if (j + 1) * F > total:
        return wav[: (total - j * F) * HIFIGAN_HOP_LENGTH]
    return wav


@torch.inference_mode()
def stream_synthesize(g, plm, adm, vocoder, phone: torch.Tensor, lens: torch.Tensor,
                      mels_prompt: torch.Tensor, max_frames: int, chunk_frames: int = 256,
                      temperature: float = 0.0, top_k: int = 0,
                      generator: Optional[torch.Generator] = None) -> Iterator[np.ndarray]:
    """Waveform chunks (fp32 numpy, ``chunk_frames``×hop samples, the last
    possibly shorter) of one utterance (phone (1, Tp)); concatenated they
    equal ``synthesize`` at the stream's budget (:func:`stream_geometry`)
    trimmed to ``n_frames`` (greedy).  Chunk j+1 is queued on the device
    before chunk j is copied to the host."""
    F, rv, rd, Tmax = stream_geometry(g.cfg, vocoder.cfg, max_frames, chunk_frames)
    Tc, Cc = Tmax // 8, F // 8
    tc_expand, tc_plm, n_frames = stream_prep(g, adm, phone, lens, mels_prompt, Tmax)
    n0 = min(Tc, (F + rv + rd) // 8)  # the codes chunk 0 needs
    caches, prev = plm_stream_start(plm, tc_plm, Tc, temperature, top_k, generator)
    codes = torch.zeros((1, Tc), dtype=torch.long, device=tc_plm.device)
    codes[:, 0] = prev
    if n0 > 1:
        prev, new = plm_stream_chunk(plm, caches, prev, tc_plm, 1, n0 - 1, temperature, top_k,
                                     generator)
        codes[:, 1:n0] = new
    pending = [(0, emit_chunk(g, vocoder, tc_expand, codes, 0, F, rv, rd))]
    total = int(n_frames[0])
    n_codes = n0
    for j in range(1, -(-total // F)):
        n_steps = min(Cc, Tc - n_codes)  # 0 near the end: only lag frames are left
        if n_steps > 0:
            prev, new = plm_stream_chunk(plm, caches, prev, tc_plm, n_codes, n_steps, temperature,
                                         top_k, generator)
            codes[:, n_codes:n_codes + n_steps] = new
            n_codes += n_steps
        pending.append((j, emit_chunk(g, vocoder, tc_expand, codes, j * F, F, rv, rd)))
        jj, w = pending.pop(0)
        yield _trim(w[0].cpu().numpy(), jj, F, total)
    if total > 0:
        for jj, w in pending:
            yield _trim(w[0].cpu().numpy(), jj, F, total)
