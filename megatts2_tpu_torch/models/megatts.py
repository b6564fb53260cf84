"""Megatts — end-to-end zero-shot synthesis (port of
``megatts2_tpu/models/megatts.py``).

prompt wavs → log-mel (kernel A on the card) → MRTE tc_latent (kernel B in
the phone encoder when ``use_flash``) → ADM KV-cached decode → length
regulation → 8× max-pool → PLM KV-cached decode (float or int8 / int4
weights, greedy or temperature / top-k sampled, optionally after a prefilled
prosody prompt) → codebook lookup, ×8 repeat → MegaG ConvNet decoder →
HiFi-GAN or Vocos, with the prompt audio prepended.

PyTorch runs eagerly, so ``synthesize`` is a plain function over modules;
the true lengths ride beside the padded tensors and the host trims the
waveform.
"""
from __future__ import annotations

import glob
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import HIFIGAN_HOP_LENGTH, HIFIGAN_SR
from ..ops import mel_spectrogram, regulate_length
from ..quantization.vq import EuclideanCodebook
from ..quantization.weight_only import cast_float_, quantize_
from ..text.symbol_table import SymbolTable
from ..text.tokenizer import TextTokenizer
from ..utils.audio import load_wav, peak_normalize, save_wav
from .adm import MegaADM, adm_infer
from .hifigan import HiFiGAN
from .megag import MegaG
from .fast_decode import gumbel_noise
from .plm import MegaPLM, plm_infer
from .vocos import Vocos

Vocoder = HiFiGAN | Vocos


def vocode(vocoder: Vocoder, mel: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """mel (B, T, 80) → waveform (B, T*hop) fp32, by the vocoder module's
    type: :class:`HiFiGAN` (the reference's vocoder) or :class:`Vocos`,
    computing in ``dtype`` (default: the module's weight dtype)."""
    if not isinstance(vocoder, (HiFiGAN, Vocos)):
        raise TypeError(f"vocode: no vocoder of type {type(vocoder).__name__}")
    return vocoder(mel, dtype).float()


def max_pool_time(x: torch.Tensor, stride: int) -> torch.Tensor:
    """F.max_pool1d(stride, ceil_mode=True) over the time axis of (B, T, D)."""
    return F.max_pool1d(x.transpose(1, 2), stride, stride, ceil_mode=True).transpose(1, 2)


class _StageClock:
    """Wall seconds per stage into ``times`` (device synchronised at each
    mark); does nothing when ``times`` is None."""

    def __init__(self, times: Optional[dict], device: torch.device):
        self.times = times
        self.device = device
        if times is not None:
            self._sync()
            self.t = time.perf_counter()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, name: str) -> None:
        if self.times is None:
            return
        self._sync()
        now = time.perf_counter()
        self.times[name] = now - self.t
        self.t = now


@torch.inference_mode()
def synthesize(
    g: MegaG,
    plm: MegaPLM,
    adm: MegaADM,
    vocoder: Vocoder,
    phone_tokens: torch.Tensor,  # (B, Tp) int, 0-padded
    phone_lens: torch.Tensor,  # (B,)
    mels_prompt: torch.Tensor,  # (B, Tm, 80)
    max_frames: int,
    quant: bool = False,  # the PLM is quantized (quantize_)
    plm_temperature: float = 0.0,  # > 0: sample prosody codes
    plm_top_k: int = 0,
    generator: Optional[torch.Generator] = None,  # on the device, when sampling
    plm_prompt_tc: Optional[torch.Tensor] = None,  # (B, P, D) in-context prompt
    plm_prompt_codes: Optional[torch.Tensor] = None,  # (B, P)
    plm_gumbel: Optional[torch.Tensor] = None,  # (ceil(max_frames/8), B, vq_bins) injected noise
    stage_times: Optional[dict] = None,
):
    """Batched zero-shot synthesis.  Returns (wav (B, max_frames*hop) fp32,
    mel_hat (B, max_frames, 80), n_frames (B,)); callers trim with
    n_frames*hop.  The PLM options are :func:`plm_infer`'s.  With
    ``stage_times`` a dict, each stage's wall seconds are written into it
    (the device is synchronised between stages)."""
    clock = _StageClock(stage_times, phone_tokens.device)

    # 1. content/timbre latent (phone × mel-prompt cross attention)
    tc_latent = g.mrte.tc_latent(phone_tokens, mels_prompt, phone_lens)  # (B, Tp, H)
    clock("mrte")

    # 2. AR duration decode; predictions beyond the true phone length are 0
    dt = adm_infer(adm, tc_latent.float())
    pos = torch.arange(dt.shape[1], device=dt.device)[None, :]
    dt = torch.where(pos < phone_lens[:, None], dt, torch.zeros_like(dt))
    n_frames = torch.clamp(dt.sum(dim=1), max=max_frames)
    clock("adm")

    # 3. length-regulate to frame rate; 4. 8× max-pool, AR prosody decode
    tc_expand = regulate_length(tc_latent, dt, max_frames)  # (B, Tf, H)
    tc_plm = max_pool_time(tc_expand, 8)
    p_codes = plm_infer(plm, tc_plm.float(), quant=quant, temperature=plm_temperature,
                        top_k=plm_top_k, generator=generator, prompt_tc=plm_prompt_tc,
                        prompt_codes=plm_prompt_codes, gumbel=plm_gumbel)  # (B, Tf/8)
    clock("plm")

    # 5. codebook lookup, ×8 repeat, mel decode
    zq = g.vqpe.vq.decode(p_codes[None]).repeat_interleave(8, dim=1)
    mel_hat = g.decode_latents(tc_expand, zq)  # (B, Tf, 80)
    clock("decoder")

    # 6. vocode
    wav = vocode(vocoder, mel_hat.float())
    clock("vocoder")
    return wav, mel_hat, n_frames


def _cast_(module: nn.Module, dtype: torch.dtype, keep: Sequence[str] = ()) -> None:
    """Cast ``module``'s submodules to ``dtype`` in place, except those
    named in ``keep`` (dotted paths, e.g. ``vqpe.vq``), which stay as they
    are (fp32)."""
    for name, child in module.named_children():
        inner = [k[len(name) + 1:] for k in keep if k.startswith(name + ".")]
        if name in keep:
            continue
        if inner:
            _cast_(child, dtype, inner)
        else:
            child.to(dtype)


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill a freshly built model with seeded random weights, in place:
    Linear, Conv2d and (transposed) Conv1d weights N(0, 1/fan_in) with zero biases,
    embeddings and codebooks N(0, 1); LayerNorms and layer scales keep their
    defaults.  Synthesis speed does not depend on the weights."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)):
            # a transposed conv's output sums in_channels * k / stride taps
            fan_in = (m.in_channels * m.kernel_size[0] // m.stride[0]
                      if isinstance(m, nn.ConvTranspose1d) else m.weight[0].numel())
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) / fan_in**0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        elif isinstance(m, EuclideanCodebook):
            m.embed.copy_(torch.randn(m.embed.shape, generator=generator))
    return module


class Megatts:
    """End-to-end inference entry point: ``Megatts(...)(wavs_dir, text)`` writes
    ``test.wav`` with the prompt audio and the generated speech.

    The modules are moved to ``device`` and cast to ``dtype`` in place; the
    codebook (``g.vqpe.vq``) and the Vocos ``head`` stay fp32, HiFi-GAN is cast
    whole.  ``quant_int8`` quantizes the PLM's Linear layers to int8 from
    their fp32 weights before the cast, and their scales and biases stay
    fp32; the ADM stays float, as in JAX.  ``plm_temperature`` > 0 samples
    the prosody codes (``plm_top_k``) from a generator seeded with ``seed``.
    There is no CPU fallback: ``device="cuda"`` without a CUDA device raises."""

    def __init__(
        self,
        g: MegaG,
        plm: MegaPLM,
        adm: MegaADM,
        vocoder: Vocoder,
        symbol_table: str,
        pinyin_dict_path: Optional[str] = None,
        max_frames: int = 2048,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device = "cuda",
        quant_int8: bool = False,
        plm_temperature: float = 0.0,
        plm_top_k: int = 0,
        seed: int = 0,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Megatts: device 'cuda' requested but no CUDA device is available")
        for m in (g, plm, adm, vocoder):
            m.to(self.device).eval()
        if quant_int8:
            quantize_(plm, 8)
        _cast_(g, dtype, keep=("vqpe.vq",))
        cast_float_(plm, dtype)
        adm.to(dtype)
        _cast_(vocoder, dtype, keep=("head",) if isinstance(vocoder, Vocos) else ())
        self.g, self.plm, self.adm, self.vocoder = g, plm, adm, vocoder
        self.tt = TextTokenizer(pinyin_dict_path)
        st = SymbolTable.from_file(symbol_table)
        self.token2idx = {s: i for i, s in enumerate(st.symbols)}
        self.max_frames = max_frames
        self.dtype = dtype
        self.quant_int8 = quant_int8
        self.plm_temperature = float(plm_temperature)
        self.plm_top_k = int(plm_top_k)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def phone_ids(self, text: str) -> np.ndarray:
        """G2P → symbol ids.  Separators ('_'/'-') absent from the symbol
        table are skipped; any other unknown phone raises KeyError."""
        phones = self.tt.tokenize_lty(self.tt.tokenize(text))
        ids = [
            self.token2idx[p]
            for p in phones
            if not (p in ("_", "-") and p not in self.token2idx)
        ]
        return np.array(ids, dtype=np.int64)

    def prompt_mel(self, wavs_dir: str) -> tuple[torch.Tensor, Optional[np.ndarray]]:
        """(mel (Tm, 80) on the device, the first prompt's waveform): one
        log-mel per ``*.wav`` of ``wavs_dir`` (kernel A on the card, each
        reflect-padded on its own), joined along time."""
        mels, first = [], None
        for w in sorted(glob.glob(os.path.join(wavs_dir, "*.wav"))):
            y = peak_normalize(load_wav(w, HIFIGAN_SR))
            first = y if first is None else first
            mels.append(mel_spectrogram(torch.from_numpy(y).to(self.device)))
        if not mels:
            raise FileNotFoundError(f"no *.wav under {wavs_dir}")
        return torch.cat(mels, dim=0), first

    def _synthesize(self, phone: torch.Tensor, lens: torch.Tensor, mels: torch.Tensor,
                    prompt_features: Optional[tuple], stage_times: Optional[dict],
                    max_frames: Optional[int] = None, mesh=None):
        """``synthesize`` with this instance's models and PLM options;
        ``prompt_features`` (tc (1|B, P, D), codes (1|B, P)) are broadcast
        to the batch.  On a ``mesh`` whose data axis splits the batch each
        rank synthesises its rows; a sampling PLM then draws the noise of
        the whole batch at once, the same on every rank, and takes its rows."""
        B = phone.shape[0]
        prompt = {}
        if prompt_features is not None:
            tc, codes = (torch.as_tensor(np.asarray(x)).to(self.device) for x in prompt_features)
            prompt = dict(plm_prompt_tc=tc.float().expand(B, *tc.shape[1:]),
                          plm_prompt_codes=codes.long().expand(B, *codes.shape[1:]))
        max_frames = max_frames or self.max_frames
        split = mesh is not None and mesh.n_data > 1 and B % mesh.n_data == 0
        if split:
            from ..parallel import shard_rows

            if self.plm_temperature > 0:
                V = self.plm.cfg.vq_bins
                noise = gumbel_noise((-(-max_frames // 8), B, V), self.generator, self.device)
                prompt["plm_gumbel"] = shard_rows(noise.transpose(0, 1), mesh).transpose(0, 1)
            phone, lens, mels = (shard_rows(x, mesh) for x in (phone, lens, mels))
            prompt = {k: v if k == "plm_gumbel" else shard_rows(v, mesh) for k, v in prompt.items()}
        out = synthesize(
            self.g, self.plm, self.adm, self.vocoder, phone, lens, mels, max_frames,
            quant=self.quant_int8, plm_temperature=self.plm_temperature,
            plm_top_k=self.plm_top_k, generator=self.generator, stage_times=stage_times,
            **prompt,
        )
        if not split:
            return out
        from ..parallel.collectives import gather_rows

        return tuple(gather_rows(x, mesh) for x in out)

    def synthesize_batch(
        self,
        texts: list,
        mels_prompt,  # (B, Tm, 80) per-utterance prompt mels, numpy or tensor
        stage_times: Optional[dict] = None,
        prompt_features: Optional[tuple] = None,  # (tc (1|B, P, D), codes (1|B, P))
        max_frames: Optional[int] = None,
        mesh=None,
    ) -> list:
        """Batched synthesis: phone sequences padded to a multiple of 16,
        one cascade for the whole batch, per-utterance trimmed waveforms.
        ``stage_times`` as in :func:`synthesize`; ``prompt_features`` is an
        in-context prosody prompt of one length, one shared by the batch
        when its leading dim is 1; ``max_frames`` overrides the instance's
        frame budget (``serve.py``'s length buckets).  ``mesh``
        (``parallel.make_mesh``): every rank passes the whole batch, which
        is padded before each rank takes its rows over the data axis, and
        gets every utterance back (gathered); a batch that does not split
        evenly runs whole on every rank, as JAX replicates it."""
        ids = [self.phone_ids(t) for t in texts]
        B = len(ids)
        Tp = -(-max(len(i) for i in ids) // 16) * 16
        phone = np.zeros((B, Tp), np.int64)
        for b, seq in enumerate(ids):
            phone[b, : len(seq)] = seq
        lens = np.asarray([len(i) for i in ids], np.int64)
        mels = torch.as_tensor(mels_prompt, dtype=torch.float32).to(self.device)
        wav, _, n_frames = self._synthesize(
            torch.from_numpy(phone).to(self.device), torch.from_numpy(lens).to(self.device),
            mels, prompt_features, stage_times, max_frames, mesh,
        )
        wav = wav.cpu().numpy()
        n = n_frames.cpu().numpy()
        return [wav[b, : int(n[b]) * HIFIGAN_HOP_LENGTH] for b in range(B)]

    def __call__(self, wavs_dir: str, text: str, out_path: str = "test.wav",
                 prompt_features: Optional[tuple] = None) -> np.ndarray:
        """One mel per prompt file (each reflect-padded on its own), joined
        along time; the generated speech is appended to the first prompt.
        ``prompt_features`` (tc (1, P, D), codes (1, P)) is an optional
        in-context prosody prompt for the PLM."""
        mel, prompt_wav = self.prompt_mel(wavs_dir)
        mel_prompt = mel[None]  # (1, Tm, 80)
        ids = torch.from_numpy(self.phone_ids(text))[None].to(self.device)
        lens = torch.tensor([ids.shape[1]], device=self.device)
        wav, _, n_frames = self._synthesize(ids, lens, mel_prompt, prompt_features, None)
        n = int(n_frames[0]) * HIFIGAN_HOP_LENGTH
        gen = wav[0, :n].cpu().numpy()
        full = np.concatenate([prompt_wav, gen]) if prompt_wav is not None else gen
        save_wav(out_path, full, HIFIGAN_SR)
        return full

    def stream(self, wavs_dir: str, text: str, chunk_frames: int = 256,
               max_frames: Optional[int] = None):
        """Streaming synthesis: waveform chunks (fp32 numpy, ``chunk_frames``
        × hop samples) as soon as the prosody codes they depend on exist
        (``models/streaming.py``); concatenated they equal the one-shot
        ``synthesize`` at the stream's frame budget.  Greedy, or sampled
        with this instance's temperature, top-k and generator."""
        from .streaming import stream_synthesize

        mel, _ = self.prompt_mel(wavs_dir)
        ids = torch.from_numpy(self.phone_ids(text))[None].to(self.device)
        lens = torch.tensor([ids.shape[1]], device=self.device)
        yield from stream_synthesize(
            self.g, self.plm, self.adm, self.vocoder, ids, lens, mel[None],
            max_frames or self.max_frames, chunk_frames, self.plm_temperature, self.plm_top_k,
            self.generator)
