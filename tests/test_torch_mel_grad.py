"""Kernel A's gradient on the CPU: the port's plain backward (autograd
through ``mel_spectrogram_plain``) against ``jax.vjp`` of the JAX package's
golden ``mel_spectrogram``, and the backward kernel's plan executed in
numpy.

The CUDA kernel cannot run here; ``tests/test_torch_cuda.py`` holds it
against the plain backward on the card.  What it computes is stated twice
on this side: the bin table and the overlap-add gather it reads
(``ops/mel.py`` ``bin_tasks``, ``fold_sources``, ``frames_covering``) and,
below, its per-frame arithmetic written out in numpy with the forward's FFT
plan run in the inverse direction.

Tolerances, as fractions of the largest gradient magnitude: 1e-5 against
JAX (both fp32, FFTs and sums in other orders; log's 1/mel amplifies where
a mel is small, far from the 1e-5 clamp on these signals) and 1e-5 for the
numpy plan against the plain backward (a complex64 FFT in the kernel's
order against pocketfft).
"""
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
    """The first launch's arithmetic, then the gather, in numpy, against
    the plain backward."""
    y = _signal((2, n), 8)
    T = tmel.num_frames(n)
    g = _cotangent((2, T, 80), 9)
    frames = tmel.frame_signal(torch.from_numpy(y), 1024, 256).numpy()
    gf = _kernel_backward_frames(frames.astype(np.float32), g)
    got = np.zeros((2, n), np.float64)
    for i, q in tmel.fold_sources(n):
        t_lo, t_hi = tmel.frames_covering(q, T)
        for di in range(4):
            t = t_lo + di
            ok = t <= t_hi
            got[:, i[ok]] += gf[:, t[ok], q[ok] - 256 * t[ok]]
    want = tmel.mel_spectrogram_bwd_plain(torch.from_numpy(y), torch.from_numpy(g)).numpy()
    _assert_rel(got, want, REL)


def test_backward_plan_gives_zero_on_silence():
    """|X| = 0 and every mel under the clamp: no gradient, no NaN."""
    frames = np.zeros((3, 1024), np.float32)
    gf = _kernel_backward_frames(frames, _cotangent((3, 80), 10))
    assert np.array_equal(gf, np.zeros_like(gf))
