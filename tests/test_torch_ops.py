"""The port's ops held against the JAX package on the CPU: the plain
versions of the two kernels (log-mel, masked flash attention), the masks,
the length regulator and the iSTFT.  The same numpy-seeded inputs go
through both; JAX reaches its Pallas kernels in interpret mode."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from megatts2_tpu_torch import ops as tops
from megatts2_tpu_torch.ops import attention as tatt
from megatts2_tpu_torch.ops import mel as tmel


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# --- kernel A's plain version -------------------------------------------


@pytest.mark.parametrize("shape", [(8192,), (2, 4100), (3, 777)])
def test_mel_plain_matches_jax_golden(shape):
    """rfft-based plain mel == jnp golden mel_spectrogram; atol 1e-4 covers
    two fp32 FFT implementations summing in different orders."""
    from megatts2_tpu.ops import mel_spectrogram

    y = (np.random.RandomState(0).randn(*shape) * 0.1).astype(np.float32)
    ref = np.asarray(mel_spectrogram(jnp.asarray(y)))
    got = tmel.mel_spectrogram_plain(_t(y)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("shape", [(8192,), (2, 4100)])
def test_mel_plain_matches_fused_pallas_interpret(shape):
    """... and == the Pallas kernel it replaces, run in interpret mode."""
    from jax.experimental.pallas import tpu as pltpu

    from megatts2_tpu.ops.mel import mel_spectrogram_fused

    y = (np.random.RandomState(1).randn(*shape) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(mel_spectrogram_fused(jnp.asarray(y)))
    got = tmel.mel_spectrogram_plain(_t(y)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_mel_helpers_equal_jax_copies():
    """The copied numpy filterbank and window are the JAX ones, bit for bit."""
    from megatts2_tpu.ops import mel as jmel

    np.testing.assert_array_equal(tmel.mel_filterbank(), jmel.mel_filterbank())
    np.testing.assert_array_equal(tmel._hann_window(1024), jmel._hann_window(1024))
    assert tmel.num_frames(4100) == jmel.num_frames(4100)


# --- kernel A's tables and index plan ---------------------------------------


def test_mel_kernel_filterbank_tables_rebuild_the_filterbank():
    """The compact tables hold every nonzero weight where the dense
    filterbank has it, bit for bit, and that filterbank is JAX's."""
    from megatts2_tpu.ops import mel as jmel

    fb = tmel.mel_filterbank()
    tasks, weights = tmel.filterbank_tasks(fb)
    n_mels = fb.shape[1]
    rebuilt = np.zeros_like(fb)
    for p, (la, ca, lb, cb) in enumerate(tasks):
        rebuilt[la : la + ca, p] = weights[:ca, p]
        rebuilt[lb : lb + cb, n_mels - 1 - p] = weights[ca : ca + cb, p]
    np.testing.assert_array_equal(rebuilt, fb)
    np.testing.assert_array_equal(rebuilt, jmel.mel_filterbank())
    assert int((weights != 0).sum()) == int((fb != 0).sum()) == 1001
    assert tasks.shape == (40, 4) and weights.shape[1] == 40


def test_mel_kernel_twiddles():
    w = tmel.twiddles_1024()
    t = np.arange(1024)
    np.testing.assert_allclose(w, np.exp(-2j * np.pi * t / 1024), rtol=0, atol=1e-7)
    plan, table = tmel.fft_plan(), tmel.kernel_twiddles()
    assert table.shape == (512 + 64 + 512,)
    tt, r = np.meshgrid(np.arange(64), np.arange(8))  # [r][t]
    np.testing.assert_allclose(table[:512], np.exp(-2j * np.pi * (tt * r).ravel() / 512), atol=1e-7)
    m2, r = np.meshgrid(np.arange(8), np.arange(8))  # [r][m2]
    np.testing.assert_allclose(table[512:576], np.exp(-2j * np.pi * (m2 * r).ravel() / 64), atol=1e-7)
    np.testing.assert_array_equal(table[576:], w[:512])
    assert plan["tws"].tolist() == list(range(512))


SQRT_HALF = np.float32(0.70710678118654752)


def _dft8(a):
    """csrc/mel.cu's dft8 over the last axis, operation for operation, in
    complex64 (a * -i written as (y, -x))."""
    def negi(x):
        return (x.imag - 1j * x.real).astype(np.complex64)

    def w1(x):
        return (SQRT_HALF * (x.real + x.imag) + 1j * SQRT_HALF * (x.imag - x.real)).astype(np.complex64)

    def w3(x):
        return (SQRT_HALF * (x.imag - x.real) - 1j * SQRT_HALF * (x.real + x.imag)).astype(np.complex64)

    a = a.astype(np.complex64)
    u = [a[..., n] + a[..., n + 4] for n in range(4)]
    v = [a[..., n] - a[..., n + 4] for n in range(4)]
    v[1], v[2], v[3] = w1(v[1]), negi(v[2]), w3(v[3])
    out = np.empty_like(a)
    for (x0, x1, x2, x3), (e0, e1) in ((u, (0, 4)), (v, (1, 5))):
        s, t, d, e = x0 + x2, x1 + x3, x0 - x2, negi(x1 - x3)
        out[..., e0], out[..., e1] = s + t, s - t
        out[..., e0 + 2], out[..., e1 + 2] = d + e, d - e
    return out


def _run_fft_plan(z):
    """The kernel's three passes over z (..., 512) complex64, as the plan's
    index arrays say, with the kernel's twiddle table: returns Z (..., 512)
    in natural order, read back from exchange A through zpos."""
    plan = tmel.fft_plan()
    tw = tmel.kernel_twiddles()
    tw1, tw2 = tw[:512].reshape(8, 64).T, tw[512:576].reshape(8, 8).T  # [t][r], [m2][r]
    lead = z.shape[:-1]
    ex_a = np.zeros(lead + (tmel.FFT_ZSLOTS,), np.complex64)
    ex_b = np.zeros(lead + (8 * tmel.FFT_ROW,), np.complex64)
    a = _dft8(z[..., plan["load1"]]) * tw1
    ex_a[..., plan["store1"]] = a
    a = _dft8(ex_a[..., plan["load2"]]) * tw2[np.arange(64) & 7]
    ex_b[..., plan["store2"]] = a
    a = _dft8(ex_b[..., plan["load3"]])
    ex_a[..., tmel.zpos(plan["out3"])] = a
    return ex_a[..., tmel.zpos(np.arange(512))]


def _split(Z):
    """The kernel's split of Z (..., 512) into |X| (..., 513)."""
    tw = tmel.kernel_twiddles()[576:]
    k = np.arange(512)
    zk, zm = Z, Z[..., (512 - k) & 511]
    e = 0.5 * (zk.real + zm.real) + 0.5j * (zk.imag - zm.imag)
    o = 0.5 * (zk.imag + zm.imag) - 0.5j * (zk.real - zm.real)
    x = e + tw * o
    nyq = np.abs(Z[..., :1].real - Z[..., :1].imag)
    return np.concatenate([np.abs(x), nyq], -1).astype(np.float32)


def test_mel_kernel_fft_plan_in_numpy():
    """The plan the kernel mirrors, executed in numpy on seeded windowed
    frames, gives np.fft.rfft's magnitudes within 1e-4 and, through the
    compact filterbank and the log clamp, mel_spectrogram_plain within 1e-4."""
    plan = tmel.fft_plan()
    for name in ("store1", "store2"):  # every exchange slot written once
        assert len(np.unique(plan[name])) == 512
    assert sorted(plan["out3"].ravel()) == list(range(512))
    assert len(np.unique(tmel.zpos(np.arange(512)))) == 512 and tmel.zpos(511) < tmel.FFT_ZSLOTS

    y = (np.random.RandomState(8).randn(2, 5000) * 0.1).astype(np.float32)
    frames = tmel.frame_signal(_t(y), 1024, 256).numpy() * tmel.padded_window(1024, 1024)
    z = (frames[..., 0::2] + 1j * frames[..., 1::2]).astype(np.complex64)
    mags = _split(_run_fft_plan(z))
    np.testing.assert_allclose(mags, np.abs(np.fft.rfft(frames.astype(np.float64), axis=-1)),
                               rtol=0, atol=1e-4)

    tasks, weights = tmel.filterbank_tasks(tmel.mel_filterbank())
    mel = np.zeros(mags.shape[:-1] + (80,), np.float32)
    for p, (la, ca, lb, cb) in enumerate(tasks):
        mel[..., p] = mags[..., la : la + ca] @ weights[:ca, p]
        mel[..., 79 - p] = mags[..., lb : lb + cb] @ weights[ca : ca + cb, p]
    got = np.log(np.maximum(mel, 1e-5))
    np.testing.assert_allclose(got, tmel.mel_spectrogram_plain(_t(y)).numpy(), rtol=0, atol=1e-4)


# --- kernel B's plain version -------------------------------------------


def _qkv(rng, B, Tq, Tk, H, Dh):
    q = rng.randn(B, Tq, H, Dh).astype(np.float32)
    k = rng.randn(B, Tk, H, Dh).astype(np.float32)
    v = rng.randn(B, Tk, H, Dh).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "causal,Tq,Tk,lens",
    [
        (False, 37, 37, [20, 37, 0]),  # ragged k_lens, a k_len=0 row, Tq % block != 0
        (True, 37, 37, [20, 37, 0]),
        (False, 21, 45, [45, 3, 0]),  # cross-length q/k
        (True, 5, 5, None),  # no k_lens, Tq < block
    ],
)
def test_flash_plain_matches_pallas_interpret(causal, Tq, Tk, lens):
    """flash_attention_plain == the Pallas flash_attention (interpret mode);
    atol 2e-5 covers fp32 sums in different orders."""
    from megatts2_tpu.ops.attention_pallas import flash_attention

    q, k, v = _qkv(np.random.RandomState(2), 3, Tq, Tk, 2, 16)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    ref = np.asarray(
        flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), k_lens=jl,
                        causal=causal, block_q=16, interpret=True)
    )
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    got = tatt.flash_attention_plain(_t(q), _t(k), _t(v), tl, causal).numpy()
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_zero_len_row_gives_mean_of_v(causal):
    """A row whose keys are all masked averages all Tk rows of V: no NaN."""
    q, k, v = _qkv(np.random.RandomState(3), 1, 9, 9, 2, 8)
    got = tatt.flash_attention_plain(
        _t(q), _t(k), _t(v), torch.tensor([0], dtype=torch.int32), causal
    ).numpy()
    mean_v = np.broadcast_to(v.mean(axis=1, keepdims=True), got.shape)
    np.testing.assert_allclose(got, mean_v, atol=1e-6)


def test_flash_dispatch_on_cpu_is_plain_and_keeps_dtype():
    q, k, v = _qkv(np.random.RandomState(4), 2, 6, 6, 2, 8)
    lens = torch.tensor([4, 6])
    before = tatt.flash_attention_cuda.launches
    got = tops.flash_attention(_t(q), _t(k), _t(v), lens, causal=True)
    ref = tatt.flash_attention_plain(_t(q), _t(k), _t(v), lens.to(torch.int32), True)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    bf = tops.flash_attention(_t(q).bfloat16(), _t(k).bfloat16(), _t(v).bfloat16(), lens)
    assert bf.dtype == torch.bfloat16
    assert tatt.flash_attention_cuda.launches == before


# --- no fallback -----------------------------------------------------------


def test_cuda_wrappers_raise_on_cpu_tensors():
    """The kernel wrappers refuse CPU tensors instead of falling back, and
    count no launch."""
    y = torch.zeros(4096)
    q = torch.zeros(1, 4, 2, 64)
    n_mel, n_att = tmel.mel_spectrogram_cuda.launches, tatt.flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tmel.mel_spectrogram_cuda(y)
    with pytest.raises(ValueError, match="CUDA"):
        tatt.flash_attention_cuda(q, q, q)
    assert tmel.mel_spectrogram_cuda.launches == n_mel
    assert tatt.flash_attention_cuda.launches == n_att


def test_mel_dispatch_on_cpu_is_plain():
    y = _t((np.random.RandomState(5).randn(2, 3000) * 0.1).astype(np.float32))
    before = tmel.mel_spectrogram_cuda.launches
    torch.testing.assert_close(tops.mel_spectrogram(y), tmel.mel_spectrogram_plain(y), rtol=0, atol=0)
    assert tmel.mel_spectrogram_cuda.launches == before


# --- masks, length regulator, iSTFT ----------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_attn_mask_matches_jax(causal):
    from megatts2_tpu.ops import make_attn_mask

    lens = np.array([3, 7, 5], np.int32)
    ref = np.asarray(make_attn_mask(jnp.asarray(lens), 7, causal=causal))
    got = tops.make_attn_mask(torch.from_numpy(lens), 7, causal=causal).numpy()
    np.testing.assert_array_equal(got, np.broadcast_to(ref, got.shape))


def test_length_regulator_exact():
    """Exact: a gather, so equal bit for bit; frames beyond sum(durations) are 0."""
    from megatts2_tpu.ops import regulate_length

    rng = np.random.RandomState(6)
    x = rng.randn(3, 7, 5).astype(np.float32)
    dur = rng.randint(0, 5, (3, 7)).astype(np.int32)
    dur[2] = 0
    for T_out in (10, 40):
        ref = np.asarray(regulate_length(jnp.asarray(x), jnp.asarray(dur), T_out))
        got = tops.regulate_length(_t(x), torch.from_numpy(dur), T_out).numpy()
        np.testing.assert_array_equal(got, ref)


def test_istft_matches_jax():
    """irfft + overlap-add + envelope division; atol 1e-5 (fp32)."""
    from megatts2_tpu.ops.istft import istft

    rng = np.random.RandomState(7)
    re = rng.randn(2, 9, 513).astype(np.float32)
    im = rng.randn(2, 9, 513).astype(np.float32)
    ref = np.asarray(istft(jnp.asarray(re), jnp.asarray(im)))
    got = tops.istft(_t(re), _t(im)).numpy()
    assert got.shape == ref.shape == (2, 8 * 256)
    np.testing.assert_allclose(got, ref, atol=1e-5)
