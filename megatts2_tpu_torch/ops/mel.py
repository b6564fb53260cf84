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
  :func:`kernel_twiddles`, :func:`filterbank_tasks`).  On a signal that
  requires grad it records :class:`MelFunction`, whose backward is kernel
  A's backward, :func:`mel_spectrogram_bwd_cuda` (its bin table and
  block plan stated here: :func:`bin_tasks`, :func:`bwd_plan`, with the
  adjoint the plan equals, :func:`fold_sources`).
* :func:`mel_spectrogram` — dispatch by device: CPU → plain (autograd
  through the plain ops is the backward's plain version,
  :func:`mel_spectrogram_bwd_plain`), CUDA → kernel.

The numpy filterbank and window helpers are copies of the JAX module's,
which cannot be imported without importing JAX.
"""
from __future__ import annotations

import contextlib
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


def bin_tasks(fb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The filterbank by bin, in the layout kernel A's backward reads for
    g_|X|[k] = sum_m fb[k, m] g_mel_lin[m]: ``mels`` (n_bins, 2) int32 and
    ``weights`` (n_bins, 2) fp32, the (at most two) mels whose filter
    holds bin k and their weights, padded with mel 0 at weight 0.  Slaney
    filters are triangles over consecutive band edges, so a bin lies in at
    most two; a filterbank with more raises."""
    nz = fb != 0
    if nz.sum(1).max() > 2:
        raise ValueError(f"kernel A's backward takes at most 2 filters a bin, got {nz.sum(1).max()}")
    mels = np.zeros((fb.shape[0], 2), np.int32)
    weights = np.zeros((fb.shape[0], 2), np.float32)
    for k in range(fb.shape[0]):
        for d, m in enumerate(np.flatnonzero(nz[k])):
            mels[k, d], weights[k, d] = m, fb[k, m]
    return mels, weights


def fold_sources(n: int, n_fft: int = 1024) -> list[tuple[np.ndarray, np.ndarray]]:
    """Where sample i of the signal's gradient gathers from.  ``center=True``
    pads the signal by n_fft/2 on each side by reflection (no edge repeat),
    so sample i sits at padded position q = i + n_fft/2, and also at q =
    n_fft/2 - i (1 <= i <= n_fft/2) and q = 2 (n - 1) - i + n_fft/2 (n - 1 -
    n_fft/2 <= i <= n - 2); padded position q holds the sum over the frames
    t in [t_lo(q), t_hi(q)] that cover it, of frame t's gradient at q - t
    hop.  Returns, for each of the three positions, (the samples i that have
    it, their q): the adjoint of reflect-pad and unfold, which kernel A's
    backward computes in that order (:func:`bwd_plan`)."""
    half = n_fft // 2
    i = np.arange(n)
    left = (i >= 1) & (i <= half)
    right = (i <= n - 2) & (i >= n - 1 - half)
    return [(i, i + half), (i[left], half - i[left]), (i[right], 2 * (n - 1) - i[right] + half)]


def frames_covering(q: np.ndarray, T: int, n_fft: int = 1024, hop: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """(t_lo, t_hi), the first and last frame whose window holds padded
    position q: t hop <= q < t hop + n_fft, 0 <= t < T (empty if t_lo > t_hi)."""
    t_lo = np.where(q >= n_fft, (q - n_fft) // hop + 1, 0)
    t_hi = np.minimum(q // hop, T - 1)
    return t_lo, t_hi


# ---- kernel A's backward: the block, cluster and halo plan ------------------
#
# Padded hop slot h (positions 256 h .. 256 h + 255) is the sum of frames
# h - 3 .. h.  A block computes BWD_FRAMES consecutive frames of one row and
# owns a run of slots; what the 3 frames before its first slot add to that
# slot and the next two (the carry) comes from the block before it through
# distributed shared memory, or, at a cluster's first block, from 3 frames it
# computes itself (the halo) in place of 3 of its own.  Each sample is
# written by the block owning its padded position i + 512, which also owns
# its reflected partners' slots.  csrc/mel.cu computes these formulas.

BWD_FRAMES = 6  # frames a block computes, 64 threads each (csrc/mel.cu BWD_FRAMES)
BWD_CLUSTER = 4  # blocks a thread-block cluster, laid along the row; 1: halo only
BWD_HALO = 3  # frames before a slot that reach into it


def bwd_owned_start(j: int, T: int, cluster: int = BWD_CLUSTER) -> int:
    """First slot (and first frame) that block j of a T-frame row owns:
    BWD_FRAMES a block, 3 fewer at each cluster's first block after the
    row's first, T past the row's end.  Never T - 1: where the last block
    would own one frame the block before it gives one up, so the last block
    owns slots T - 2 .. T + 2, every slot the right edge's fold reads, as the
    first owns slots 0 .. 4 (BWD_FRAMES >= 6)."""
    o = 0 if j == 0 else j * BWD_FRAMES - BWD_HALO * ((j - 1) // cluster)
    return T - 2 if o == T - 1 else min(o, T)


def bwd_clusters(T: int, cluster: int = BWD_CLUSTER) -> int:
    """Clusters a row: the first owns ``cluster * BWD_FRAMES`` frames, each
    later one 3 fewer; the grid is this times ``cluster`` blocks a row."""
    per = cluster * BWD_FRAMES - BWD_HALO
    return 1 if T <= per + BWD_HALO else -(-(T - BWD_HALO) // per)


def bwd_plan(n: int, cluster: int = BWD_CLUSTER) -> list[dict]:
    """Kernel A's backward on a row of n samples, block by block (the grid's
    x): ``first``, the first of the BWD_FRAMES frames it computes; its
    frames ``own`` = [lo, hi); ``slots`` = [lo, end), past the row's last
    frame the 3 slots its tail reaches; ``carry``: ``"none"`` (the row's
    first block), ``"peer"`` (the block before it, in its cluster) or
    ``"halo"`` (a cluster's first block: frames lo - 3 .. lo - 1 are its own
    first three); ``samples`` = [i_lo, i_hi), those whose padded position
    i + 512 lies in its slots.  Blocks past the row's end own nothing
    (``own`` empty) and only join their cluster's syncs."""
    if not 1 <= cluster <= 8:
        raise ValueError(f"the kernel takes clusters of 1-8 blocks, got {cluster}")
    T = num_frames(n)
    blocks = []
    for j in range(bwd_clusters(T, cluster) * cluster):
        lo, hi = bwd_owned_start(j, T, cluster), bwd_owned_start(j + 1, T, cluster)
        halo = j > 0 and j % cluster == 0
        end = hi if hi < T else T + BWD_HALO
        blocks.append({
            "first": lo - BWD_HALO if halo else lo,
            "own": (lo, hi),
            "slots": (lo, end) if lo < T else (lo, lo),
            "carry": "none" if j == 0 else "halo" if halo else "peer",
            "samples": (max(0, 256 * (lo - 2)), min(n, 256 * (end - 2))) if lo < T else (n, n),
        })
    return blocks


@functools.lru_cache(maxsize=8)
def _kernel_tables(n_mels: int, device: torch.device):
    """Kernel A's tables on ``device``, built once: window (1024,) fp32,
    twiddles (1088, 2) fp32, filterbank tasks and weights, and the
    backward's bin mels and weights."""
    fb = mel_filterbank(n_mels=n_mels)
    tasks, weights = filterbank_tasks(fb)
    mels, bin_weights = bin_tasks(fb)
    tw = kernel_twiddles()
    return (
        _tables(1024, 1024, n_mels, device)[0],  # the window
        torch.from_numpy(np.stack([tw.real, tw.imag], 1)).to(device),
        torch.from_numpy(tasks).to(device),
        torch.from_numpy(weights).to(device),
        torch.from_numpy(mels).to(device),
        torch.from_numpy(bin_weights).to(device),
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


def _check_kernel_args(signal: torch.Tensor, n_fft: int, hop: int, win_length: int,
                       n_mels: int) -> None:
    if not signal.is_cuda:
        raise ValueError(f"mel_spectrogram_cuda takes a CUDA tensor, got {signal.device}")
    if signal.dtype != torch.float32:
        raise ValueError(f"mel_spectrogram_cuda takes float32, got {signal.dtype}")
    if signal.dim() not in (1, 2):
        raise ValueError("mel_spectrogram_cuda takes an (n,) or (B, n) signal")
    if (n_fft, hop, win_length) != (1024, 256, 1024):
        raise ValueError("the mel kernel is built for n_fft 1024, hop 256, win_length 1024")
    if n_mels % 2 or n_mels > 2 * FFT_THREADS:
        raise ValueError(f"the mel kernel takes an even n_mels up to {2 * FFT_THREADS}, got {n_mels}")
    n = signal.shape[-1]
    if n <= n_fft // 2:
        raise ValueError(f"reflect padding needs more than {n_fft // 2} samples, got {n}")


def _mel_forward(sig: torch.Tensor, n_mels: int) -> torch.Tensor:
    """One launch of kernel A's forward on a contiguous (B, n) fp32 signal."""
    from ..csrc.build import check, load_library

    if not sig.is_contiguous():
        raise ValueError("the mel kernel takes a contiguous signal")
    lib = load_library()
    B, n = sig.shape
    T = num_frames(n)
    window, tw, tasks, weights, _, _ = _kernel_tables(n_mels, sig.device)
    out = torch.empty((B, T, n_mels), dtype=torch.float32, device=sig.device)
    with torch.cuda.device(sig.device):
        err = lib.mt_mel_forward(
            sig.data_ptr(), window.data_ptr(), tw.data_ptr(), tasks.data_ptr(), weights.data_ptr(),
            out.data_ptr(), B, n, T, n_mels, torch.cuda.current_stream().cuda_stream,
        )
    check(err, "mel kernel")
    mel_spectrogram_cuda.launches += 1
    if mel_spectrogram_cuda.shapes is not None:
        mel_spectrogram_cuda.shapes.add((B, n))
    return out


# the backward's table (:func:`bwd_table`), offsets in floats (csrc/mel.cu TB_*)
BWD_TABLE_TW, BWD_TABLE_BIN_MELS, BWD_TABLE_BIN_WEIGHTS, BWD_TABLE_TASKS = 1024, 3200, 4228, 5256


def bwd_table(n_mels: int, device: torch.device) -> torch.Tensor:
    """Kernel A's backward reads its tables as one fp32 array, which each
    block copies into shared memory at its start: the window (1024), the
    twiddles (1088 complex), the bin mels (513 int2, as their bits) and
    weights (513 float2), each padded by 2 floats to a 16-byte boundary, the
    filterbank tasks (int4) and their weights (depth x n_mels / 2), padded
    to a multiple of 4 floats; :func:`_kernel_tables`' entries, laid end to
    end (csrc/mel.cu TB_*)."""
    window, tw, tasks, weights, mels, bin_weights = _kernel_tables(n_mels, device)
    pad = torch.zeros(2, device=device)
    parts = [window, tw.flatten(), mels.view(torch.float32).flatten(), pad, bin_weights.flatten(), pad,
             tasks.view(torch.float32).flatten(), weights.flatten()]
    n = sum(p.numel() for p in parts)
    return torch.cat(parts + [torch.zeros(-n % 4, device=device)])


_BWD_LAUNCH: dict = {}  # device index -> (n_mels, library, the table's pointer and length, the table)


def _bwd_launch(index: int, n_mels: int) -> tuple:
    """What a launch on device ``index`` reads that does not change between
    calls: the library and :func:`bwd_table`'s pointer and length (the
    entry holds the table); one entry a device."""
    from ..csrc.build import load_library

    table = bwd_table(n_mels, torch.device("cuda", index))
    entry = (n_mels, load_library(), table.data_ptr(), table.numel(), table)
    _BWD_LAUNCH[index] = entry
    return entry


def mel_spectrogram_bwd_cuda(signal: torch.Tensor, g_mel: torch.Tensor,
                             cluster: int = BWD_CLUSTER) -> torch.Tensor:
    """Kernel A's backward: the gradient of ``sum(g_mel * mel(signal))``
    with respect to the (B, n) fp32 contiguous CUDA ``signal``, for
    ``g_mel`` (B, 1 + n // 256, n_mels).  One launch (``csrc/mel.cu``
    ``mel_bwd_kernel``): each frame's gradient stays in shared memory, and
    blocks hand on the overlap-add's carry through thread-block clusters of
    ``cluster`` blocks (:func:`bwd_plan`; 1 is the halo-only variant, the
    same bits).  The clamp follows ``torch.clamp``: a mel at exactly 1e-5
    passes its whole gradient (JAX's ``clip`` passes half).

    The launcher is kept light: it allocates g_sig alone, copies g_mel only
    if it is not fp32 and contiguous, enters the signal's device only if it
    is not current, and finds the tables by device index."""
    n_mels = g_mel.shape[-1]
    if not (signal.is_cuda and signal.dtype == torch.float32 and signal.dim() == 2
            and signal.is_contiguous() and not n_mels % 2 and n_mels <= 2 * FFT_THREADS
            and signal.shape[1] > 512):
        _check_kernel_args(signal, 1024, 256, 1024, n_mels)
        raise ValueError("mel_spectrogram_bwd_cuda takes a contiguous (B, n) signal")
    B, n = signal.shape
    index = signal.get_device()
    if g_mel.shape != (B, 1 + n // 256, n_mels) or g_mel.get_device() != index:
        raise ValueError(f"g_mel {tuple(g_mel.shape)} on {g_mel.device} does not match the "
                         f"signal's mel ({B}, {num_frames(n)}, {n_mels}) on {signal.device}")
    if g_mel.dtype != torch.float32 or not g_mel.is_contiguous():
        g_mel = g_mel.float().contiguous()
    entry = _BWD_LAUNCH.get(index)
    if entry is None or entry[0] != n_mels:
        entry = _bwd_launch(index, n_mels)
    _, lib, table, table_len, _ = entry
    g_sig = torch.empty_like(signal)
    current = index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(index):
        err = lib.mt_mel_backward(signal.data_ptr(), g_mel.data_ptr(), table, g_sig.data_ptr(), B, n,
                                  n_mels, table_len, cluster, torch._C._cuda_getCurrentRawStream(index))
    if err:
        from ..csrc.build import check

        check(err, "mel backward kernel")
    mel_spectrogram_bwd_cuda.launches += 1
    if mel_spectrogram_bwd_cuda.shapes is not None:
        mel_spectrogram_bwd_cuda.shapes.add((B, n))
    return g_sig


mel_spectrogram_bwd_cuda.launches = 0
mel_spectrogram_bwd_cuda.shapes = None  # as mel_spectrogram_cuda.shapes


class MelFunction(torch.autograd.Function):
    """Kernel A with its backward kernel, on a contiguous (B, n) signal."""

    @staticmethod
    def forward(ctx, sig: torch.Tensor, n_mels: int) -> torch.Tensor:
        ctx.save_for_backward(sig)
        return _mel_forward(sig, n_mels)

    @staticmethod
    def backward(ctx, g_mel: torch.Tensor):
        (sig,) = ctx.saved_tensors
        return mel_spectrogram_bwd_cuda(sig, g_mel), None


def mel_spectrogram_cuda(
    signal: torch.Tensor,  # (n,) or (B, n) float32 on a CUDA device
    n_fft: int = HIFIGAN_NFFT,
    hop: int = HIFIGAN_HOP_LENGTH,
    win_length: int = HIFIGAN_WIN_LENGTH,
    n_mels: int = HIFIGAN_MEL_CHANNELS,
) -> torch.Tensor:
    """Kernel A (``csrc/mel.cu``): the same function in one launch.  When
    autograd records (a signal that requires grad, grad mode on), through
    :class:`MelFunction`, whose backward launches
    :func:`mel_spectrogram_bwd_cuda`; the signal is made contiguous first
    (a vocoder's output is a slice of its overlap-add), and autograd
    carries the gradient back through that copy to the view."""
    _check_kernel_args(signal, n_fft, hop, win_length, n_mels)
    squeeze = signal.dim() == 1
    sig = (signal[None] if squeeze else signal).contiguous()
    if sig.requires_grad and torch.is_grad_enabled():
        out = MelFunction.apply(sig, n_mels)
    else:
        out = _mel_forward(sig, n_mels)
    return out[0] if squeeze else out


mel_spectrogram_cuda.launches = 0
# a set that each launch adds its signal's (B, n) to, or None: lets a caller
# check the kernel at every shape a path gave it
mel_spectrogram_cuda.shapes = None


def mel_spectrogram_bwd_plain(signal: torch.Tensor, g_mel: torch.Tensor) -> torch.Tensor:
    """The backward's plain version: autograd through
    :func:`mel_spectrogram_plain` (``torch.clamp``'s tie convention)."""
    sig = signal.detach().requires_grad_()
    with torch.enable_grad():
        mel = mel_spectrogram_plain(sig)
    return torch.autograd.grad(mel, sig, g_mel)[0]


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
