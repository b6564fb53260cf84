"""The in-context prosody prompt helpers of ``megatts2_tpu/data/datasets.py``
(the training batch builders are not ported yet).

A prompt is the stage-2 features of same-speaker utterances: each cut's
``tc_latent`` length-regulated to frame rate by its durations and ×8
max-pooled to code rate, paired with its VQPE codes, as ``PLMBatchBuilder``
builds the training prompt prefix.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from .manifest import CutManifest


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
