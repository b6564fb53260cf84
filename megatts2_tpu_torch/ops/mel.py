"""Log-mel spectrogram (port of ``megatts2_tpu/ops/mel.py``).

Same function as the JAX golden ``mel_spectrogram``: torchaudio-style
``MelSpectrogram`` with power 1, slaney filterbank and mel scale, periodic
Hann window, center=True reflect padding, then ``log(clamp(x, 1e-5))``.

* :func:`mel_spectrogram_plain` — framing, ``torch.fft.rfft`` and a
  filterbank matmul in fp32; what a CPU tensor takes, and the reference
  the CUDA kernel is held against.
* :func:`mel_spectrogram_cuda` — kernel A (``csrc/mel.cu``), which replaces
  the Pallas ``mel_spectrogram_fused``: a register FFT whose index plan,
  twiddles and compact filterbank are built here (:func:`fft_plan`,
  :func:`kernel_twiddles`, :func:`filterbank_tasks`).
* :func:`mel_spectrogram` — dispatch by device: CPU → plain, CUDA → kernel.

The numpy filterbank and window helpers are copies of the JAX module's,
which cannot be imported without importing JAX.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import (
    HIFIGAN_HOP_LENGTH,
    HIFIGAN_MAX_FREQ,
    HIFIGAN_MEL_CHANNELS,
    HIFIGAN_NFFT,
    HIFIGAN_SR,
    HIFIGAN_WIN_LENGTH,
)

LOG_CLIP = 1e-5


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    mel = f / f_sp
    with np.errstate(divide="ignore"):
        log_mel = min_log_mel + np.log(np.maximum(f, 1e-30) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log_mel, mel)


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    hz = m * f_sp
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), hz)


def mel_filterbank(
    sr: int = HIFIGAN_SR,
    n_fft: int = HIFIGAN_NFFT,
    n_mels: int = HIFIGAN_MEL_CHANNELS,
    fmin: float = 0.0,
    fmax: float = HIFIGAN_MAX_FREQ,
) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular filterbank, (n_freqs, n_mels)."""
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sr / 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    f_pts = _mel_to_hz_slaney(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
    return (fb * enorm[None, :]).astype(np.float32)


def _hann_window(win_length: int) -> np.ndarray:
    # torch.hann_window(periodic=True)
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * n / win_length)).astype(np.float32)


def padded_window(win_length: int, n_fft: int) -> np.ndarray:
    """Hann window of ``win_length`` centred in ``n_fft`` samples."""
    window = _hann_window(win_length)
    lpad = (n_fft - win_length) // 2
    return np.pad(window, (lpad, n_fft - win_length - lpad))


def num_frames(n_samples: int, hop: int = HIFIGAN_HOP_LENGTH) -> int:
    """center=True frame count: 1 + n_samples // hop."""
    return 1 + n_samples // hop


@functools.lru_cache(maxsize=8)
def _tables(n_fft: int, win_length: int, n_mels: int, device: torch.device):
    """On ``device``: window (n_fft,) fp32 and filterbank (n_fft//2+1,
    n_mels) fp32."""
    return (
        torch.from_numpy(padded_window(win_length, n_fft)).to(device),
        torch.from_numpy(mel_filterbank(n_fft=n_fft, n_mels=n_mels)).to(device),
    )


# ---- kernel A's plan --------------------------------------------------------
#
# A 1024-sample frame x is one 512-point complex sequence z[j] = x[2j] +
# i x[2j+1]; its FFT Z gives the real spectrum by the split X[k] = E[k] +
# W_1024^k O[k] (E, O the spectra of the even and odd samples).  The kernel
# runs that FFT with 64 threads a frame, 8 points a thread, in three radix-8
# passes of registers with two exchanges through shared memory.  With
# digits n = n2 + 64 n1, n2 = m2 + 8 m1 and k = k1 + 8 j1 + 64 j2 (each
# digit in [0, 8)), thread t of a frame:
#   pass 1: loads z[t + 64 r], r = 0..7; DFT-8 over r gives digit k1 = r;
#           times W_512^(t k1); stores slot k1 ROW + t of exchange A.
#   pass 2: as thread p = m2 + 8 k1 (t = p): loads A[k1 ROW + m2 + 8 r];
#           DFT-8 over r gives j1 = r; times W_64^(m2 j1); stores slot
#           k1 ROW + 9 j1 + m2 of exchange B.
#   pass 3: as thread q = j1 + 8 k1 (t = q): loads B[k1 ROW + 9 j1 + r];
#           DFT-8 over r gives j2 = r: Z[k1 + 8 j1 + 64 j2], the two octal
#           digits of q reversed.
# ROW = 72 and the 9 keep every 16-lane access on 16 distinct 8-byte
# slots: no shared-memory bank conflicts.  Z is then stored at zpos(k) =
# k + 2 (k >> 3) (conflict-free for pass 3's stores), and thread t splits
# bins k = t + 64 i.  The kernel computes these indices in the same
# formulas; this plan is their one statement in Python, the source of the
# twiddle table the kernel reads, and what the CPU tests execute in numpy.

FFT_N = 512  # complex FFT length of a 1024-sample frame
FFT_THREADS = 64  # threads a frame, 8 points each
FFT_ROW = 72  # exchange-buffer stride between first digits, in complex slots
FFT_ZSLOTS = 640  # exchange A a frame: 8 * 72 for pass 1, then Z at zpos(k) <= 637


def twiddles_1024() -> np.ndarray:
    """exp(-2 pi i t / 1024), t in [0, 1024), computed in float64, complex64."""
    return np.exp(-2j * np.pi * np.arange(1024) / 1024).astype(np.complex64)


def zpos(k):
    """Slot of Z[k] in exchange A after pass 3."""
    return k + 2 * (k >> 3)


@functools.lru_cache(maxsize=1)
def fft_plan() -> dict:
    """The kernel's FFT as index arrays over (thread t, register r), each
    (64, 8): ``load1`` (into z), ``store1``, ``load2`` (exchange A),
    ``store2``, ``load3`` (exchange B), ``out3`` (the natural index k of the
    Z each register ends with), and the W_1024 exponents ``tw1`` (pass 1),
    ``tw2`` (pass 2) and ``tws`` (512,) for the split's W_1024^k."""
    t = np.arange(FFT_THREADS)[:, None]
    r = np.arange(8)[None, :]
    hi, lo = t >> 3, t & 7  # pass 2: (k1, m2); pass 3: (k1, j1)
    return {
        "load1": t + 64 * r,
        "tw1": (2 * t * r) % 1024,  # W_512^(t k1)
        "store1": r * FFT_ROW + t,
        "load2": hi * FFT_ROW + lo + 8 * r,
        "tw2": (16 * lo * r) % 1024,  # W_64^(m2 j1)
        "store2": hi * FFT_ROW + 9 * r + lo,
        "load3": hi * FFT_ROW + 9 * lo + r,
        "out3": hi + 8 * lo + 64 * r,
        "tws": np.arange(FFT_N),
    }


def kernel_twiddles() -> np.ndarray:
    """The twiddle table kernel A reads, (1088,) complex64: pass 1's
    W_512^(t r) stored [r][t] (512), pass 2's W_64^(m2 r) stored [r][m2]
    (64), then the split's W_1024^k (512); every entry is
    ``twiddles_1024()`` at the plan's exponent."""
    plan, w = fft_plan(), twiddles_1024()
    return np.concatenate([w[plan["tw1"].T.ravel()], w[plan["tw2"][:8].T.ravel()], w[plan["tws"]]])


def filterbank_tasks(fb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The filterbank as its nonzeros, in the layout kernel A reads.

    Task p (one thread a frame) sums mel p and mel n_mels - 1 - p: a narrow
    low filter with a wide high one, so the 40 tasks of 80 slaney mels are
    16-42 weights long where single mels run 4-37.  Returns ``tasks``
    (n_mels/2, 4) int32 (first bin of mel p, its count, first bin of mel
    n_mels - 1 - p, its count) and ``weights`` (depth, n_mels/2) fp32:
    column p holds mel p's weights then its partner's, zero past them, so
    the lanes of a warp read consecutive words at each step.  Every
    filter's nonzeros must be one run of bins (true of slaney filters)."""
    n_mels = fb.shape[1]
    if n_mels % 2:
        raise ValueError(f"kernel A pairs the mels: n_mels must be even, got {n_mels}")
    nz = fb != 0
    lo = nz.argmax(0)
    cnt = nz.sum(0)
    for j in range(n_mels):
        if not nz[lo[j] : lo[j] + cnt[j], j].all():
            raise ValueError(f"mel {j}'s nonzero bins are not one run")
    half = n_mels // 2
    tasks = np.stack([lo[:half], cnt[:half], lo[::-1][:half], cnt[::-1][:half]], 1).astype(np.int32)
    depth = int((tasks[:, 1] + tasks[:, 3]).max())
    weights = np.zeros((depth, half), np.float32)
    for p, (la, ca, lb, cb) in enumerate(tasks):
        weights[:ca, p] = fb[la : la + ca, p]
        weights[ca : ca + cb, p] = fb[lb : lb + cb, n_mels - 1 - p]
    return tasks, weights


@functools.lru_cache(maxsize=8)
def _kernel_tables(n_mels: int, device: torch.device):
    """Kernel A's tables on ``device``, built once: window (1024,) fp32,
    twiddles (1088, 2) fp32, filterbank tasks and weights."""
    tasks, weights = filterbank_tasks(mel_filterbank(n_mels=n_mels))
    tw = kernel_twiddles()
    return (
        _tables(1024, 1024, n_mels, device)[0],  # the window
        torch.from_numpy(np.stack([tw.real, tw.imag], 1)).to(device),
        torch.from_numpy(tasks).to(device),
        torch.from_numpy(weights).to(device),
    )


def frame_signal(signal: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Reflect-pad (center=True) and frame: (B, n) → (B, n_frames, n_fft)."""
    pad = n_fft // 2
    sig = F.pad(signal[:, None], (pad, pad), mode="reflect")[:, 0]
    return sig.unfold(-1, n_fft, hop)


def mel_spectrogram_plain(
    signal: torch.Tensor,  # (n,) or (B, n) float32
    n_fft: int = HIFIGAN_NFFT,
    hop: int = HIFIGAN_HOP_LENGTH,
    win_length: int = HIFIGAN_WIN_LENGTH,
    n_mels: int = HIFIGAN_MEL_CHANNELS,
) -> torch.Tensor:
    """Log-mel spectrogram, (..., n_frames, n_mels), in plain PyTorch ops."""
    window, fb = _tables(n_fft, win_length, n_mels, signal.device)
    squeeze = signal.dim() == 1
    sig = signal[None] if squeeze else signal
    frames = frame_signal(sig.float(), n_fft, hop) * window
    spec = torch.fft.rfft(frames, dim=-1).abs()
    mel = torch.log(torch.clamp(spec @ fb, min=LOG_CLIP))
    return mel[0] if squeeze else mel


def mel_spectrogram_cuda(
    signal: torch.Tensor,  # (n,) or (B, n) float32, contiguous, on a CUDA device
    n_fft: int = HIFIGAN_NFFT,
    hop: int = HIFIGAN_HOP_LENGTH,
    win_length: int = HIFIGAN_WIN_LENGTH,
    n_mels: int = HIFIGAN_MEL_CHANNELS,
) -> torch.Tensor:
    """Kernel A (``csrc/mel.cu``): the same function in one launch.  It has
    no backward: on a signal that requires grad, with grad mode on, it
    raises rather than return a mel that autograd would not follow."""
    if not signal.is_cuda:
        raise ValueError(f"mel_spectrogram_cuda takes a CUDA tensor, got {signal.device}")
    if signal.dtype != torch.float32:
        raise ValueError(f"mel_spectrogram_cuda takes float32, got {signal.dtype}")
    if signal.dim() not in (1, 2) or not signal.is_contiguous():
        raise ValueError("mel_spectrogram_cuda takes a contiguous (n,) or (B, n) signal")
    if (n_fft, hop, win_length) != (1024, 256, 1024):
        raise ValueError("the mel kernel is built for n_fft 1024, hop 256, win_length 1024")
    if n_mels % 2 or n_mels > 2 * FFT_THREADS:
        raise ValueError(f"the mel kernel takes an even n_mels up to {2 * FFT_THREADS}, got {n_mels}")
    n = signal.shape[-1]
    if n <= n_fft // 2:
        raise ValueError(f"reflect padding needs more than {n_fft // 2} samples, got {n}")
    if signal.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            "mel_spectrogram: kernel A has no backward yet, so a gradient through the mel of a "
            "CUDA signal cannot be recorded; detach the signal or compute under torch.no_grad()")
    from ..csrc.build import check, load_library

    lib = load_library()
    squeeze = signal.dim() == 1
    sig = signal[None] if squeeze else signal
    B = sig.shape[0]
    T = num_frames(n, hop)
    window, tw, tasks, weights = _kernel_tables(n_mels, signal.device)
    out = torch.empty((B, T, n_mels), dtype=torch.float32, device=signal.device)
    with torch.cuda.device(signal.device):
        err = lib.mt_mel_forward(
            sig.data_ptr(), window.data_ptr(), tw.data_ptr(), tasks.data_ptr(), weights.data_ptr(),
            out.data_ptr(), B, n, T, n_mels, torch.cuda.current_stream().cuda_stream,
        )
    check(err, "mel kernel")
    mel_spectrogram_cuda.launches += 1
    return out[0] if squeeze else out


mel_spectrogram_cuda.launches = 0


def mel_spectrogram(
    signal: torch.Tensor,
    n_fft: int = HIFIGAN_NFFT,
    hop: int = HIFIGAN_HOP_LENGTH,
    win_length: int = HIFIGAN_WIN_LENGTH,
    n_mels: int = HIFIGAN_MEL_CHANNELS,
) -> torch.Tensor:
    """Log-mel spectrogram: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor.  Never falls back from one to the other."""
    if signal.is_cuda:
        return mel_spectrogram_cuda(signal, n_fft, hop, win_length, n_mels)
    if signal.device.type == "cpu":
        return mel_spectrogram_plain(signal, n_fft, hop, win_length, n_mels)
    raise ValueError(f"mel_spectrogram: no implementation for device {signal.device}")
