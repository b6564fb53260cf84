"""A synthetic corpus in the layout ``prepare_ds`` reads, made from a seed.

    wavs/<speaker>/<id>.wav, wavs/<speaker>/<id>.txt
    textgrids/<speaker>/<id>.TextGrid   (one "phones" interval tier)

Each utterance is a harmonic stack (5 partials of a per-utterance f0 in the
speaker's register, with a slow amplitude envelope and a little noise,
peak-normalised), as ``tools/train_curve.py`` builds its corpus, with a
duration drawn from ``dur_range`` seconds.  Its phones are ``n_symbols``
symbols ``p00``, ``p01``, ... of 4-20 frames (16 ms) each, from 0 s to the
last whole phone that ends inside the wav.
"""
from __future__ import annotations

import os

import numpy as np

from ..utils.audio import save_wav

SR = 16000
FRAME_S = 256 / SR
WORDS = ["hello", "world", "nice", "day", "of", "speech"]


def _textgrid(dur_s: float, phones: list) -> str:
    iv = "".join(f"        intervals [{j + 1}]:\n            xmin = {a}\n            xmax = {b}\n"
                 f'            text = "{name}"\n' for j, (a, b, name) in enumerate(phones))
    return ('File type = "ooTextFile"\nObject class = "TextGrid"\n'
            f"xmin = 0\nxmax = {dur_s}\ntiers? <exists>\nsize = 1\nitem []:\n"
            '    item [1]:\n        class = "IntervalTier"\n        name = "phones"\n'
            f"        xmin = 0\n        xmax = {dur_s}\n        intervals: size = {len(phones)}\n"
            + iv)


def build_corpus(root: str, n_speakers: int = 4, n_per_spk: int = 12, seed: int = 0,
                 dur_range: tuple = (2.5, 6.0), n_symbols: int = 40) -> tuple[str, str]:
    """Write the corpus under ``root``; returns (wavs dir, textgrids dir)."""
    rng = np.random.RandomState(seed)
    wavs, tgs = os.path.join(root, "wavs"), os.path.join(root, "textgrids")
    for s in range(n_speakers):
        spk = f"spk{s}"
        os.makedirs(os.path.join(wavs, spk), exist_ok=True)
        os.makedirs(os.path.join(tgs, spk), exist_ok=True)
        for i in range(n_per_spk):
            dur_s = float(rng.uniform(*dur_range))
            n = int(dur_s * SR)
            t = np.arange(n) / SR
            f0 = 90.0 * 1.3 ** s * (1 + 0.3 * rng.rand())
            y = sum((0.4 / h) * np.sin(2 * np.pi * f0 * h * t + rng.rand() * 6.28)
                    for h in range(1, 6))
            y = y * (0.5 + 0.5 * np.sin(2 * np.pi * (2 + rng.rand()) * t) ** 2)
            y = (y + 0.01 * rng.randn(n)).astype(np.float32)
            y /= np.abs(y).max() + 1e-6
            phones, frame = [], 0
            while True:
                d = int(rng.randint(4, 21))
                if (frame + d) * FRAME_S >= n / SR:
                    break
                phones.append((frame * FRAME_S, (frame + d) * FRAME_S,
                               f"p{rng.randint(n_symbols):02d}"))
                frame += d
            uid = f"{spk}_u{i:02d}"
            save_wav(os.path.join(wavs, spk, uid + ".wav"), y, SR)
            words = [WORDS[j] for j in rng.randint(len(WORDS), size=4)]
            with open(os.path.join(wavs, spk, uid + ".txt"), "w", encoding="utf-8") as f:
                f.write(" ".join(words))
            with open(os.path.join(tgs, spk, uid + ".TextGrid"), "w", encoding="utf-8") as f:
                f.write(_textgrid(n / SR, phones))
    return wavs, tgs
