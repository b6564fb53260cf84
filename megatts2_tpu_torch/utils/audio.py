"""WAV I/O without librosa/soundfile: scipy-based read/resample/write.

Replaces the reference's librosa.load + librosa.util.normalize front door
(``models/megatts2.py:332-338``) and torchaudio.save back door (``:375``).
"""
from __future__ import annotations

import numpy as np
from scipy.io import wavfile


def load_wav(path: str, sr: int = 16000) -> np.ndarray:
    """Load mono float32 waveform at the target sample rate."""
    in_sr, data = wavfile.read(path)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if in_sr != sr:
        # imported here: scipy.signal takes seconds to import, and every
        # process of the pipeline (stage 0's workers, the fits) reads wavs
        from scipy.signal import resample_poly

        g = np.gcd(in_sr, sr)
        data = resample_poly(data, sr // g, in_sr // g).astype(np.float32)
    return data


def peak_normalize(y: np.ndarray) -> np.ndarray:
    """librosa.util.normalize default: scale so max |y| == 1."""
    peak = np.max(np.abs(y))
    return y / peak if peak > 0 else y


def save_wav(path: str, y: np.ndarray, sr: int = 16000) -> None:
    y = np.clip(np.asarray(y, dtype=np.float32), -1.0, 1.0)
    wavfile.write(path, sr, (y * 32767.0).astype(np.int16))


def wav_bytes(y: np.ndarray, sr: int = 16000) -> bytes:
    """Encode a waveform as an in-memory RIFF/WAV (int16) — the HTTP
    serving response body (serve.py --http)."""
    import io

    buf = io.BytesIO()
    y = np.clip(np.asarray(y, dtype=np.float32), -1.0, 1.0)
    wavfile.write(buf, sr, (y * 32767.0).astype(np.int16))
    return buf.getvalue()
