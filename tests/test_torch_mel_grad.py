"""Kernel A's gradient on the CPU: the port's plain backward (autograd
through ``mel_spectrogram_plain``) against ``jax.vjp`` of the JAX package's
golden ``mel_spectrogram``, and the backward kernel's plan executed in
numpy.

The CUDA kernel cannot run here; ``tests/test_torch_cuda.py`` holds it
against the plain backward on the card.  What it computes is stated twice
on this side: the bin table and the block, cluster and halo plan it
follows (``ops/mel.py`` ``bin_tasks``, ``bwd_plan``; ``fold_sources`` and
``frames_covering`` state the adjoint the plan must equal) and, below, its
per-frame arithmetic written out in numpy with the forward's FFT plan run
in the inverse direction.

Tolerances, as fractions of the largest gradient magnitude: 1e-5 against
JAX (both fp32, FFTs and sums in other orders; log's 1/mel amplifies where
a mel is small, far from the 1e-5 clamp on these signals) and 1e-5 for the
numpy plan against the plain backward (a complex64 FFT in the kernel's
order against pocketfft).
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megatts2_tpu_torch.ops import mel as tmel
from tests.test_torch_ops import _run_fft_plan

REL = 1e-5


def _signal(shape, seed):
    return (np.random.RandomState(seed).randn(*shape) * 0.1).astype(np.float32)


def _cotangent(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_grad(y, g, T=None):
    from megatts2_tpu.ops.mel import mel_spectrogram

    def f(x):
        m = mel_spectrogram(x)
        return m if T is None else m[..., :T, :]

    _, vjp = jax.vjp(f, jnp.asarray(y))
    return np.asarray(vjp(jnp.asarray(g))[0])


def _torch_grad(y, g, T=None):
    x = torch.from_numpy(y).requires_grad_()
    m = tmel.mel_spectrogram(x)
    if T is not None:
        m = m[..., :T, :]
    m.backward(torch.from_numpy(g))
    return x.grad.numpy()


def _assert_rel(got, want, rel):
    top = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * top, (err, top)


@pytest.mark.parametrize("shape,T", [((2, 2048), None), ((1, 513), None), ((3, 777), None),
                                     ((2, 16384), 64), ((1500,), None)])
def test_plain_gradient_matches_jax_vjp(shape, T):
    """(2, 16384) keeps the trainer's 64 of 65 frames: the last frame gets
    no gradient; (1, 513) is the shortest signal the reflect pad takes."""
    y = _signal(shape, 1)
    frames = tmel.num_frames(shape[-1])
    g = _cotangent(shape[:-1] + (frames if T is None else T, 80), 2)
    got, want = _torch_grad(y, g, T), _jax_grad(y, g, T)
    assert got.shape == y.shape
    _assert_rel(got, want, REL)


def test_gradient_on_the_cpu_records_and_never_touches_the_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CUDA wrapper was called for a CPU tensor")

    monkeypatch.setattr(tmel, "mel_spectrogram_cuda", refuse)
    monkeypatch.setattr(tmel, "mel_spectrogram_bwd_cuda", refuse)
    x = torch.from_numpy(_signal((2, 3000), 3)).requires_grad_()
    m = tmel.mel_spectrogram(x)
    assert m.grad_fn is not None
    m.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_plain_backward_equals_autograd_of_the_plain_forward():
    y = _signal((2, 3000), 4)
    g = _cotangent((2, tmel.num_frames(3000), 80), 5)
    got = tmel.mel_spectrogram_bwd_plain(torch.from_numpy(y), torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got, _torch_grad(y, g))


# ---- the backward kernel's plan, in numpy ----------------------------------


def test_bin_tasks_is_the_filterbank_by_bin():
    fb = tmel.mel_filterbank()
    mels, weights = tmel.bin_tasks(fb)
    g = _cotangent((80,), 6)
    want = fb @ g
    got = (weights * g[mels]).sum(1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    dense = np.zeros_like(fb)
    for d in range(2):
        np.add.at(dense, (np.arange(fb.shape[0]), mels[:, d]), weights[:, d])
    np.testing.assert_array_equal(dense, fb)
    with pytest.raises(ValueError, match="at most 2"):
        tmel.bin_tasks(np.ones((4, 3), np.float32))


@pytest.mark.parametrize("n", [513, 777, 1024, 2049, 5000])
def test_fold_gather_is_the_adjoint_of_pad_and_frame(n):
    """Each sample sums the frames that cover its padded positions
    (``frames_covering``) at its direct and reflected positions
    (``fold_sources``): the adjoint of reflect-pad and unfold."""
    T = tmel.num_frames(n)
    gf = _cotangent((T, 1024), 7)
    x = torch.zeros(1, n, requires_grad=True)
    tmel.frame_signal(x, 1024, 256).backward(torch.from_numpy(gf)[None])
    got = np.zeros(n, np.float64)
    for i, q in tmel.fold_sources(n):
        t_lo, t_hi = tmel.frames_covering(q, T)
        for di in range(4):  # at most 4 frames of hop 256 cover a position
            t = t_lo + di
            ok = t <= t_hi
            got[i[ok]] += gf[t[ok], q[ok] - 256 * t[ok]]
    np.testing.assert_allclose(got, x.grad[0].numpy(), rtol=0, atol=1e-5)


def _gather(gf, n):
    """The adjoint as ``fold_sources`` and ``frames_covering`` state it, for
    gradients ``gf`` (..., T, 1024): each sample's direct, then left, then
    right position, each the sum of its covering frames in ascending order,
    in gf's dtype."""
    T = gf.shape[-2]
    got = np.zeros(gf.shape[:-2] + (n,), gf.dtype)
    for i, q in tmel.fold_sources(n):
        t_lo, t_hi = tmel.frames_covering(q, T)
        acc = np.zeros(gf.shape[:-2] + (len(i),), gf.dtype)
        for di in range(4):  # at most 4 frames of hop 256 cover a position
            t = t_lo + di
            ok = t <= t_hi
            acc[..., ok] += gf[..., t[ok], q[ok] - 256 * t[ok]]
        got[..., i] += acc
    return got


def _run_bwd_plan(gf, n, cluster=tmel.BWD_CLUSTER):
    """The kernel's overlap-add and folds as ``bwd_plan`` lays them out, in
    numpy, in the kernel's order and in gf's dtype: each block sees only the
    frames it computes (and a peer's carry), writes only its samples, and
    every sample is written once."""
    T = gf.shape[-2]
    lead = gf.shape[:-2]
    blocks = tmel.bwd_plan(n, cluster)
    assert len(blocks) == tmel.bwd_clusters(T, cluster) * cluster

    def computed(blk, t):
        assert blk["first"] <= t < blk["first"] + tmel.BWD_FRAMES and 0 <= t < T, (blk, t)
        return gf[..., t, :]

    def partial(blk, s):  # slots s .. s + 2 from frames s - 3 .. s - 1, ascending
        out = np.zeros(lead + (3, 256), gf.dtype)
        for k in range(3):
            for t in range(max(0, s + k - 3), s):
                out[..., k, :] += computed(blk, t)[..., 256 * (s + k - t):256 * (s + k - t + 1)]
        return out

    carry_out = [partial(b, b["own"][1]) if b["own"][0] < b["own"][1] < T else None for b in blocks]
    out = np.full(lead + (n,), np.nan, gf.dtype)
    for j, blk in enumerate(blocks):
        lo, hi = blk["own"]
        if lo >= T:
            assert blk["samples"][0] == blk["samples"][1]
            continue
        if blk["carry"] == "peer":
            assert j % cluster and carry_out[j - 1] is not None  # a peer of its cluster
            carry = carry_out[j - 1]
        elif blk["carry"] == "halo":
            carry = partial(blk, lo)
        else:
            carry = np.zeros(lead + (3, 256), gf.dtype)
        s_lo, s_hi = blk["slots"]

        def padded(q):
            h = q // 256
            assert ((h >= s_lo) & ((h < s_hi) | (h >= T + 3))).all(), (blk, q)
            acc = np.where(h < lo + 3, carry[..., np.minimum(h - lo, 2), q % 256], 0).astype(gf.dtype)
            for t in range(lo, min(s_hi, T)):
                ok = (h - 3 <= t) & (t <= h)
                acc += np.where(ok, computed(blk, t)[..., np.clip(q - 256 * t, 0, 1023)], 0)
            return acc

        i = np.arange(*blk["samples"])
        assert np.isnan(out[..., i]).all()  # written once
        acc = padded(i + 512)
        left, right = (i >= 1) & (i <= 512), (i <= n - 2) & (i >= n - 513)
        acc[..., left] += padded(512 - i[left])
        acc[..., right] += padded(2 * (n - 1) - i[right] + 512)
        out[..., i] = acc
    assert not np.isnan(out).any()  # every sample written
    return out


BWD_LENGTHS = [513, 777, 1024, 1025, 1279, 1536, 6144, 16384, 16640, 131000]


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("n", BWD_LENGTHS)
def test_bwd_plan_is_the_adjoint_of_pad_and_frame(n, cluster):
    """The block plan summed over integer gradients (exact in float64, in
    any order) equals autograd's adjoint of reflect-pad and unfold.  n 513
    (3 frames) to 1279 (5) are rows shorter than one block; 1536 (7 frames)
    and 6144 (25, at a cluster's edge) make the block before the last give
    up a frame; 16384 (65) and 16640 (66) are the trainer's crops, T a
    multiple of neither the block nor the cluster; 131000 (512) the batched
    front end; cluster 1 is the halo-only variant."""
    T = tmel.num_frames(n)
    gf = np.random.RandomState(n % 1000 + cluster).randint(-1000, 1000, (T, 1024)).astype(np.float64)
    x = torch.zeros(1, n, dtype=torch.float64, requires_grad=True)
    tmel.frame_signal(x, 1024, 256).backward(torch.from_numpy(gf)[None])
    got = _run_bwd_plan(gf, n, cluster=cluster)
    assert np.array_equal(got, x.grad[0].numpy())
    assert np.array_equal(got, _gather(gf, n))


@pytest.mark.parametrize("n", BWD_LENGTHS)
def test_bwd_plan_gives_the_bits_of_the_gather_at_every_cluster_size(n):
    """In fp32 the plan's sums (the carry, then the owned frames, ascending;
    then the reflected partners) are the gather's, term for term: the same
    bits at cluster sizes 1, 2, 4 and 8 and as ``fold_sources`` states."""
    gf = _cotangent((2, tmel.num_frames(n), 1024), 11)
    want = _gather(gf, n)
    for cluster in (1, 2, 4, 8):
        got = _run_bwd_plan(gf, n, cluster=cluster)
        assert got.dtype == np.float32 and np.array_equal(got, want), cluster


def test_bwd_table_holds_each_table_at_its_offset():
    """The backward's one table (what each block copies into shared memory)
    holds the forward's and the backward's tables at the offsets the kernel
    reads (csrc/mel.cu TB_*), ints as their bits, padded to 16 bytes."""
    t = tmel.bwd_table(80, torch.device("cpu")).numpy()
    fb = tmel.mel_filterbank()
    tasks, weights = tmel.filterbank_tasks(fb)
    mels, bin_weights = tmel.bin_tasks(fb)
    tw = tmel.kernel_twiddles()
    at = {"window": 0, "tw": tmel.BWD_TABLE_TW, "mels": tmel.BWD_TABLE_BIN_MELS,
          "bin_weights": tmel.BWD_TABLE_BIN_WEIGHTS, "tasks": tmel.BWD_TABLE_TASKS}
    assert np.array_equal(t[:1024], tmel.padded_window(1024, 1024))
    assert np.array_equal(t[at["tw"]:at["mels"]].reshape(-1, 2), np.stack([tw.real, tw.imag], 1))
    assert np.array_equal(t[at["mels"]:at["mels"] + 1026].view(np.int32).reshape(-1, 2), mels)
    assert np.array_equal(t[at["bin_weights"]:at["bin_weights"] + 1026].reshape(-1, 2), bin_weights)
    w0 = at["tasks"] + tasks.size
    assert np.array_equal(t[at["tasks"]:w0].view(np.int32).reshape(-1, 4), tasks)
    assert np.array_equal(t[w0:w0 + weights.size].reshape(weights.shape), weights)
    assert len(t) % 4 == 0 and not t[w0 + weights.size:].any() and at["tasks"] % 4 == 0


def test_bwd_plan_blocks():
    """The grid at the trainer's (., 16384): 3 clusters of 4 a row, every
    block 6 frames, the cluster-first blocks 3 of them a halo; the row's
    first block owns slots 0-4 and the last slots T - 2 .. T + 2."""
    blocks = tmel.bwd_plan(16384)
    assert len(blocks) == 12
    assert [b["own"] for b in blocks] == [(0, 6), (6, 12), (12, 18), (18, 24), (24, 27), (27, 33),
                                          (33, 39), (39, 45), (45, 48), (48, 54), (54, 60), (60, 65)]
    assert [b["carry"] for b in blocks[:5]] == ["none", "peer", "peer", "peer", "halo"]
    assert blocks[4]["first"] == 21 and blocks[-1]["slots"] == (60, 68)
    short = tmel.bwd_plan(1536)  # 7 frames: the first gives up its 6th
    assert [b["own"] for b in short[:2]] == [(0, 5), (5, 7)] and short[1]["slots"] == (5, 10)
    assert tmel.bwd_clusters(65, 1) == 21 and tmel.bwd_clusters(24, 4) == 1
    with pytest.raises(ValueError, match="clusters of 1-8"):
        tmel.bwd_plan(16384, cluster=9)


def _kernel_backward_frames(frames, g_mel):
    """The backward kernel's first launch in numpy: per windowed frame
    (..., 1024), recompute X through the forward's plan (``_run_fft_plan``
    and the split), the mel and its clamp, then g_|X| by ``bin_tasks``,
    G = g_|X| X / |X|, the adjoint rfft as one more run of the same plan on
    conj(Zc) (the even/odd split undone with conjugate twiddles), and the
    window: the frame's gradient (..., 1024)."""
    w = tmel.padded_window(1024, 1024)
    fb = tmel.mel_filterbank()
    tw_s = tmel.kernel_twiddles()[576:]  # W_1024^k, k < 512
    xw = frames * w
    z = (xw[..., 0::2] + 1j * xw[..., 1::2]).astype(np.complex64)
    Z = _run_fft_plan(z)
    k = np.arange(512)
    zk, zm = Z, Z[..., (512 - k) & 511]
    e = 0.5 * (zk.real + zm.real) + 0.5j * (zk.imag - zm.imag)
    o = 0.5 * (zk.imag + zm.imag) - 0.5j * (zk.real - zm.real)
    X = np.concatenate([e + tw_s * o, (Z[..., :1].real - Z[..., :1].imag).astype(np.complex64)], -1)
    mag = np.abs(X)
    lin = mag @ fb
    g_lin = np.where(lin >= 1e-5, g_mel / np.maximum(lin, 1e-5), 0.0)
    mels, weights = tmel.bin_tasks(fb)
    g_mag = (weights * g_lin[..., mels]).sum(-1)
    G = np.where(mag > 0, g_mag / np.where(mag > 0, mag, 1) * X, 0)
    # Zc[k] = (G[k] + conj G[512-k]) / 2 + i W^-k (G[k] - conj G[512-k]) / 2,
    # k = 1..511; Zc[0] = (G0 + G512) + i (G0 - G512), both real parts
    Gm = np.conj(G[..., 512 - k])
    zc = 0.5 * (G[..., :512] + Gm) + 0.5j * np.conj(tw_s) * (G[..., :512] - Gm)
    g0, gn = G[..., 0].real, G[..., 512].real
    zc[..., 0] = (g0 + gn) + 1j * (g0 - gn)
    y = np.conj(_run_fft_plan(np.conj(zc).astype(np.complex64)))
    out = np.empty(frames.shape, np.float32)
    out[..., 0::2], out[..., 1::2] = y.real * w[0::2], y.imag * w[1::2]
    return out


@pytest.mark.parametrize("n", [777, 4000])
def test_backward_kernel_plan_in_numpy(n):
    """Each frame's arithmetic, then the block plan's overlap-add and folds,
    in numpy, against the plain backward."""
    y = _signal((2, n), 8)
    T = tmel.num_frames(n)
    g = _cotangent((2, T, 80), 9)
    frames = tmel.frame_signal(torch.from_numpy(y), 1024, 256).numpy()
    gf = _kernel_backward_frames(frames.astype(np.float32), g)
    got = _run_bwd_plan(gf, n)
    want = tmel.mel_spectrogram_bwd_plain(torch.from_numpy(y), torch.from_numpy(g)).numpy()
    _assert_rel(got, want, REL)


def test_backward_plan_gives_zero_on_silence():
    """|X| = 0 and every mel under the clamp: no gradient, no NaN."""
    frames = np.zeros((3, 1024), np.float32)
    gf = _kernel_backward_frames(frames, _cotangent((3, 80), 10))
    assert np.array_equal(gf, np.zeros_like(gf))


def test_stage_tool_names_each_stamp_of_the_kernel():
    """``tools/mel_bwd_stages.py`` names one stage for each clock stamp the
    kernel writes under ``-DMEL_BWD_STAGES`` (0, the block's start, then 1 ..
    13 in order), and without a card it refuses to run."""
    from megatts2_tpu_torch.csrc.build import CSRC
    from megatts2_tpu_torch.tools import mel_bwd_stages

    stamps = [int(k) for k in re.findall(r"STAGE(?:_SYNC)?\((\d+)\);", (CSRC / "mel.cu").read_text())]
    assert stamps == list(range(len(mel_bwd_stages.STAGES) + 1))
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA device"):
            mel_bwd_stages.main([])
