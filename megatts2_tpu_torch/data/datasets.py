"""Batch builders of the training stages and the in-context prosody prompt
helpers (port of ``megatts2_tpu/data/datasets.py``).

* ``GANBatchBuilder`` (reference TTSDataset): phone and duration tokens
  padded with 0 to a multiple of 16; mel targets cut to Σdurations and
  padded to T = round_up(max(Σdur, 128), 64); timbre mels the concat of
  2..n random same-speaker utterances, cut to the batch's shortest and
  rounded down to a power of two (min 128);
* ``PLMBatchBuilder`` (MegaPLMDataset): stage-2 latents length-regulated by
  the durations and ×8 max-pooled, up to n same-speaker utterances prefixed
  as the prompt, BOS = vq_bins first, EOS = vq_bins + 1 padding;
* ``ADMBatchBuilder`` (MegaADMDataset): cuts with a duration ≥ the cap
  skipped, a leading 0 (BOS), float durations (B, T + 1, 1);
* ``VocoderBatchBuilder``: seeded raw-waveform crops.

Each keeps JAX's ``np.random.RandomState`` draws in JAX's order and its
dtypes on the wire (fp16 ``mel_targets``, ``mel_timbres``, ``tc_latents``;
the trainers cast at entry), so on one manifest and seed the batches are
JAX's bit for bit.  Not ported: ``shape_guard.safe_target_frames``, which
pads T around a TPU compiler's crash geometries.

A prompt is the stage-2 features of same-speaker utterances: each cut's
``tc_latent`` length-regulated to frame rate by its durations and ×8
max-pooled to code rate, paired with its VQPE codes, as ``PLMBatchBuilder``
builds the training prompt prefix.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..text.symbol_table import SymbolTable
from .features import FeatureReader
from .manifest import CutManifest
from .sampler import round_up

MEL_PAD_MULTIPLE = 64
PHONE_PAD_MULTIPLE = 16


def expand_by_durations(x: np.ndarray, durations: np.ndarray) -> np.ndarray:
    """Host-side length regulation: (T, D) → (Σdur, D)."""
    return np.repeat(x, durations.astype(np.int64), axis=0)


def max_pool_1d_ceil(x: np.ndarray, stride: int) -> np.ndarray:
    """(T, D) → (ceil(T/stride), D) max pooling."""
    T = x.shape[0]
    pad = -T % stride
    if pad:
        x = np.concatenate([x, np.full((pad,) + x.shape[1:], -np.inf, x.dtype)], axis=0)
    return x.reshape(-1, stride, *x.shape[1:]).max(axis=1)


class LatentReader:
    """Stage-2 latent store: {ds_path}/latents/{spk}/{id}.npy with keys
    tc_latent (1, Tp, D) and p_code (1, 1, Tc)."""

    def __init__(self, ds_path: str):
        self.ds_path = ds_path

    def read(self, cut) -> Dict[str, np.ndarray]:
        path = os.path.join(self.ds_path, "latents", cut.speaker, f"{cut.id}.npy")
        return np.load(path, allow_pickle=True).item()


def prompt_features(manifest, ds_path: str, cut_ids: List[str], max_tokens: int = 2048):
    """(tc (1, P, D) fp32, codes (1, P) int32): the given cuts' stage-2
    features concatenated and tail-truncated to ``max_tokens``."""
    reader = LatentReader(ds_path)
    by_id = {c.id: c for c in manifest}
    tcs, ps = [], []
    for cid in cut_ids:
        cut = by_id[cid]
        lat = reader.read(cut)
        tc = np.asarray(lat["tc_latent"][0], np.float32)
        tc = expand_by_durations(tc, np.asarray(cut.duration_tokens, np.int64))
        tc = max_pool_1d_ceil(tc, 8)
        p = np.asarray(lat["p_code"]).reshape(-1)
        if tc.shape[0] != p.shape[0]:
            raise ValueError(f"cut {cid}: {tc.shape[0]} code-rate latents, {p.shape[0]} codes")
        tcs.append(tc)
        ps.append(p)
    tc = np.concatenate(tcs)[-max_tokens:]
    p = np.concatenate(ps)[-max_tokens:]
    return tc[None].astype(np.float32), p[None].astype(np.int32)


def load_prompt_manifest(ds_path: str) -> CutManifest:
    """All cuts (train + valid) of a prepared dataset: the prompt pool."""
    m = CutManifest.load(os.path.join(ds_path, "cuts_train.jsonl.gz"))
    vp = os.path.join(ds_path, "cuts_valid.jsonl.gz")
    if os.path.exists(vp):
        m.cuts.extend(CutManifest.load(vp).cuts)
    return m


def resolve_prompt(ds_path: str, cut_ids: Optional[List[str]] = None,
                   speaker: Optional[str] = None, n: int = 3, max_tokens: int = 2048,
                   manifest: Optional[CutManifest] = None):
    """The prompt of explicit ``cut_ids``, or of the first ``n`` utterances
    of ``speaker``: (tc (1, P, D), codes (1, P))."""
    m = manifest if manifest is not None else load_prompt_manifest(ds_path)
    if not cut_ids:
        if not speaker:
            raise ValueError("need prompt cut_ids or a speaker")
        pool = [c.id for c in m if c.speaker == speaker]
        if not pool:
            raise ValueError(f"no cuts for speaker {speaker!r} in {ds_path}")
        cut_ids = pool[:n]
    return prompt_features(m, ds_path, list(cut_ids), max_tokens=max_tokens)


def fit_prompt(tc: np.ndarray, codes: np.ndarray, length: int):
    """A prompt fitted to a static token length: tiled and tail-truncated,
    so its last ``length`` tokens flow into the decode.  Takes (P, ...) /
    (P,) or (1, P, ...) arrays; returns (1, length, D) fp32, (1, length) int32."""
    tc = np.asarray(tc)
    codes = np.asarray(codes)
    if tc.ndim == 3:
        tc = tc[0]
    codes = codes.reshape(-1)
    P = tc.shape[0]
    if P == 0 or P != codes.shape[0]:
        raise ValueError(f"prompt of {P} latents and {codes.shape[0]} codes")
    reps = -(-length // P)
    tc = np.concatenate([tc] * reps)[-length:]
    codes = np.concatenate([codes] * reps)[-length:]
    return tc[None].astype(np.float32), codes[None].astype(np.int32)


class TokensCollector:
    """Phone-string → id collation (reference ``datamodule.py:30-69``)."""

    def __init__(self, symbols_file: str):
        self.token2idx = {tok: idx for idx, tok in
                          enumerate(SymbolTable.from_file(symbols_file).symbols)}

    def phone2token(self, phones: List[str]) -> np.ndarray:
        return np.array([self.token2idx[p] for p in phones], dtype=np.int32)

    def collate(self, cuts) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(phones (B, T) int32, durations (B, T) int32, lens (B,) int32),
        T a multiple of 16, padded with 0."""
        lens = np.array([len(c.phone_tokens) for c in cuts], np.int32)
        T = round_up(int(lens.max()), PHONE_PAD_MULTIPLE)
        phones = np.zeros((len(cuts), T), np.int32)
        durs = np.zeros((len(cuts), T), np.int32)
        for i, c in enumerate(cuts):
            phones[i, : lens[i]] = self.phone2token(c.phone_tokens)
            durs[i, : lens[i]] = np.asarray(c.duration_tokens, np.int32)
        return phones, durs, lens


class GANBatchBuilder:
    """The VQ-GAN training batch (reference TTSDataset semantics).

    ``use_native``: the mel reads go through the native reader (its async
    ring for the targets, ``concat_slices`` for the timbres), built and
    loaded here or raising; ``False`` takes the numpy reader.  Both give
    the same batch."""

    def __init__(self, manifest: CutManifest, ds_path: str, n_same_spk_samples: int = 10,
                 seed: int = 0, max_timbre_frames: int = 2048, use_native: bool = True):
        self.manifest = manifest
        self.collector = TokensCollector(os.path.join(ds_path, "unique_text_tokens.k2symbols"))
        self.reader = FeatureReader()
        self.native = None
        if use_native:
            from .native_loader import NativeFeatureReader

            self.native = NativeFeatureReader()
        self.spk2idx = manifest.speaker_index()
        self.n_same_spk_samples = n_same_spk_samples
        self.rng = np.random.RandomState(seed)
        self.max_timbre_frames = max_timbre_frames
        self._ring = None  # the native ring, made (and grown) on demand

    def _get_ring(self, need_floats: int):
        if self._ring is None or self._ring.max_floats < need_floats:
            if self._ring is not None:
                self._ring.close()
            self._ring = self.native.ring_create(2, need_floats)
        return self._ring

    def _read_mel(self, cut) -> np.ndarray:
        return self.reader.read(cut.feats_path, cut.feats_offset, cut.num_frames)

    def __call__(self, idxs: List[int]) -> Dict[str, np.ndarray]:
        cuts = [self.manifest[i] for i in idxs]
        phones, durs, lens = self.collector.collate(cuts)

        # mel targets, cut to Σduration, then padded to a multiple of 64
        tgt_lens = np.array([min(int(sum(c.duration_tokens)), c.num_frames) for c in cuts],
                            np.int32)
        T = round_up(max(int(tgt_lens.max()), 128), MEL_PAD_MULTIPLE)
        ticket = -1
        if self.native is not None and len({c.feats_path for c in cuts}) == 1:
            # the C++ pool fills the padded targets while this thread
            # assembles the timbre mels below
            ticket = self._get_ring(len(cuts) * T * 80).submit(
                cuts[0].feats_path, [c.feats_offset for c in cuts], tgt_lens.tolist(), T)
        mel_targets = None
        if ticket < 0:
            mel_targets = np.zeros((len(cuts), T, 80), np.float32)
            for i, c in enumerate(cuts):
                mel_targets[i, : tgt_lens[i]] = self._read_mel(c)[: tgt_lens[i]]
        try:
            return self._assemble(cuts, phones, durs, lens, tgt_lens, T, ticket, mel_targets)
        except BaseException:
            if ticket >= 0:  # never strand a ring slot on an exception
                try:
                    self._ring.wait(ticket, len(cuts), T)
                finally:
                    self._ring.release(ticket)
            raise

    def _assemble(self, cuts, phones, durs, lens, tgt_lens, T, ticket, mel_targets):
        # timbre mels: the concat of 2..n random same-speaker utterances
        n_sample = self.rng.randint(2, self.n_same_spk_samples + 1)
        timbres, tlens = [], []
        for c in cuts:
            pool = self.spk2idx[c.speaker]
            pick = self.rng.choice(pool, size=min(n_sample, len(pool)), replace=False)
            picks = [self.manifest[int(j)] for j in pick]
            if self.native is not None and {p.feats_path for p in picks} == {cuts[0].feats_path}:
                mel = self.native.concat_slices(picks[0].feats_path,
                                                [p.feats_offset for p in picks],
                                                [p.num_frames for p in picks],
                                                self.max_timbre_frames)
            else:
                mel = np.concatenate([self._read_mel(p) for p in picks])[: self.max_timbre_frames]
            timbres.append(mel)
            tlens.append(mel.shape[0])
        tmin = min(tlens)
        # round the batch's shortest down to a power of two (min 128), or on
        # tiny corpora down to a multiple of 16: a few shapes, not one a batch
        if tmin >= 128:
            bucket = 128
            while bucket * 2 <= tmin:
                bucket *= 2
            tmin = min(bucket, self.max_timbre_frames)
        else:
            tmin = max(tmin - tmin % PHONE_PAD_MULTIPLE, PHONE_PAD_MULTIPLE)
        mel_timbres = np.stack([m[:tmin] for m in timbres]).astype(np.float32)

        if ticket >= 0:  # collect the async target fill
            mel_targets = self._ring.wait(ticket, len(cuts), T)
            self._ring.release(ticket)
        return {
            "phone_tokens": phones,
            "duration_tokens": durs,
            "tokens_lens": lens,
            "mel_targets": mel_targets.astype(np.float16),
            "mel_target_lens": tgt_lens,
            "mel_timbres": mel_timbres.astype(np.float16),
        }


class VocoderBatchBuilder:
    """``{"wav": (B, segment_frames · hop)}`` float32 crops at seeded random
    offsets, zero-padded when an utterance is shorter than the segment.
    The mel is the train step's work (kernel A on the card)."""

    def __init__(self, manifest: CutManifest, ds_path: str, segment_frames: int = 64,
                 hop: int = 256, seed: int = 0):
        del ds_path  # the builders' common signature; the crops read cut.wav_path
        self.manifest = manifest
        self.n_samples = segment_frames * hop
        self.rng = np.random.RandomState(seed)
        self._cache: dict = {}

    def _load(self, cut) -> np.ndarray:
        wav = self._cache.get(cut.id)
        if wav is None:
            from ..utils.audio import load_wav

            wav = load_wav(cut.wav_path, 16000).astype(np.float32)
            if len(self._cache) < 256:  # tiny corpora stay in memory
                self._cache[cut.id] = wav
        return wav

    def __call__(self, idxs: List[int]) -> Dict[str, np.ndarray]:
        out = np.zeros((len(idxs), self.n_samples), np.float32)
        for i, idx in enumerate(idxs):
            y = self._load(self.manifest[idx])
            if y.shape[0] <= self.n_samples:
                out[i, : y.shape[0]] = y
            else:
                start = self.rng.randint(0, y.shape[0] - self.n_samples + 1)
                out[i] = y[start: start + self.n_samples]
        return {"wav": out}


class PLMBatchBuilder:
    """``{"p_codes" (B, L + 1) int32, "tc_latents" (B, L, D) fp16, "lens"}``:
    each cut's code-rate latents and codes behind up to ``n_same_spk_samples``
    same-speaker utterances, tail-cut to ``max_tokens``, L a multiple of 32."""

    def __init__(self, manifest: CutManifest, ds_path: str, n_same_spk_samples: int = 10,
                 vq_bins: int = 1024, seed: int = 0, max_tokens: int = 4096):
        self.manifest = manifest
        self.latents = LatentReader(ds_path)
        self.spk2idx = manifest.speaker_index()
        self.n = n_same_spk_samples
        self.bos = vq_bins
        self.eos = vq_bins + 1
        self.rng = np.random.RandomState(seed)
        self.max_tokens = max_tokens

    def _cut_latent(self, cut) -> tuple[np.ndarray, np.ndarray]:
        lat = self.latents.read(cut)
        tc = np.asarray(lat["tc_latent"][0], np.float32)  # (Tp, D)
        tc = expand_by_durations(tc, np.asarray(cut.duration_tokens, np.int64))  # frame rate
        tc = max_pool_1d_ceil(tc, 8)  # code rate
        p = np.asarray(lat["p_code"]).reshape(-1)  # (Tc,)
        if tc.shape[0] != p.shape[0]:
            raise ValueError(f"cut {cut.id}: {tc.shape[0]} code-rate latents, {p.shape[0]} codes")
        return tc, p

    def __call__(self, idxs: List[int]) -> Dict[str, np.ndarray]:
        tc_list, code_list, lens = [], [], []
        for i in idxs:
            cut = self.manifest[i]
            tc, p = self._cut_latent(cut)
            pool = self.spk2idx[cut.speaker]
            picks = self.rng.choice(pool, size=min(self.n, len(pool)), replace=False)
            for j in picks:  # the prompt prefix: same-speaker utterances
                tc_j, p_j = self._cut_latent(self.manifest[int(j)])
                tc = np.concatenate([tc_j, tc])
                p = np.concatenate([p_j, p])
            tc = tc[-self.max_tokens:]
            p = p[-self.max_tokens:]
            if p.max() >= self.bos:
                raise ValueError(f"cut {cut.id}: a code ≥ vq_bins {self.bos}")
            code_list.append(np.concatenate([[self.bos], p]))
            tc_list.append(tc)
            lens.append(p.shape[0])
        lens = np.asarray(lens, np.int32)
        L = round_up(int(lens.max()), 32)
        D = tc_list[0].shape[1]
        p_codes = np.full((len(idxs), L + 1), self.eos, np.int32)
        tc_latents = np.zeros((len(idxs), L, D), np.float16)
        for i, (tc, p) in enumerate(zip(tc_list, code_list)):
            p_codes[i, : len(p)] = p
            tc_latents[i, : tc.shape[0]] = tc
        return {"p_codes": p_codes, "tc_latents": tc_latents, "lens": lens}


class ADMBatchBuilder:
    """``{"duration_tokens" (B, T + 1, 1) fp32, "tc_latents" (B, T, D) fp16,
    "lens"}``; None when every cut of the batch is skipped."""

    def __init__(self, manifest: CutManifest, ds_path: str, max_duration_token: int = 128):
        self.manifest = manifest
        self.latents = LatentReader(ds_path)
        self.max_duration_token = max_duration_token

    def __call__(self, idxs: List[int]) -> Optional[Dict[str, np.ndarray]]:
        durs, tcs, lens = [], [], []
        for i in idxs:
            cut = self.manifest[i]
            d = np.asarray(cut.duration_tokens, np.float32)
            if d.max() >= self.max_duration_token:
                continue  # the reference skips such cuts (datamodule.py:259-260)
            tc = np.asarray(self.latents.read(cut)["tc_latent"][0], np.float32)
            if tc.shape[0] != d.shape[0]:
                raise ValueError(f"cut {cut.id}: {tc.shape[0]} latents, {d.shape[0]} durations")
            durs.append(d)
            tcs.append(tc)
            lens.append(d.shape[0])
        if not durs:
            return None
        lens = np.asarray(lens, np.int32)
        T = round_up(int(lens.max()), PHONE_PAD_MULTIPLE)
        D = tcs[0].shape[1]
        duration_tokens = np.zeros((len(durs), T + 1, 1), np.float32)  # leading 0 = BOS
        tc_latents = np.zeros((len(durs), T, D), np.float16)
        for i, (d, tc) in enumerate(zip(durs, tcs)):
            duration_tokens[i, 1: 1 + len(d), 0] = d
            tc_latents[i, : tc.shape[0]] = tc
        return {"duration_tokens": duration_tokens, "tc_latents": tc_latents, "lens": lens}
