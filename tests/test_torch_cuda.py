"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: without a CUDA device every test here skips.  On a
machine with a card and no JAX, run them with

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

(``--noconftest`` because the suite's conftest configures JAX).  Tolerances:
fp32 attention atol 1e-4 and bf16 atol 2e-2 (same inputs, sums in another
order; bf16 output rounding); the forward's row statistics atol 1e-4 (row
max) and rtol 1e-5 (row sum), fp32 sums in another order; the backward
1e-4 (fp32) and 2e-2 (bf16) of each gradient's largest magnitude, since P
and ds are rounded to bf16 before their products and a rounding that flips
moves a term by one bf16 ulp; log-mel atol 1e-3, because the kernel's FFT
and ``torch.fft`` sum 1024 terms in different orders and log(clamp(.,
1e-5)) magnifies that near the clamp; kernel A's backward 1e-4 of the
gradient's largest magnitude, for the same reasons; the copy pump (kernel D) exactly, since both its
outputs are integer sums."""
import numpy as np
import pytest
import torch

from megatts2_tpu_torch.ops import attention as tatt
from megatts2_tpu_torch.ops import mel as tmel
from megatts2_tpu_torch.ops import pump as tpump

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain references in full fp32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _lens(B, Tk):
    lens = [Tk, 0, max(1, Tk // 3), 1] * B
    return torch.tensor(lens[:B], dtype=torch.int32)


# (B, Tq, H, Dh[, Tk]): in bf16 the tensor-core path's edges at Dh 64 (Tq
# of 1, 32, 300 and 1000 inside 64-row tiles; one query row against 70
# keys), Dh 128, and Dh 256, where two blocks split the output columns: the
# MRTE's (8, 64, 2, 256) and (1, 3, 2, 256), several key tiles, one row
# against 70 keys; Dh 96 (the ADM at tc_emb_dim 512: 128-wide tiles whose
# columns 96-127 TMA fills with zeros) and 80, zero-padded to 96, on the
# same path; 33, zero-padded to 64.  fp32 runs every shape on the SIMT path
FLASH_SHAPES = [(8, 64, 2, 256), (4, 1, 2, 64, 70), (4, 32, 2, 64), (4, 300, 2, 64),
                (2, 1000, 16, 64), (3, 77, 4, 128), (1, 3, 2, 256), (2, 300, 4, 256),
                (4, 1, 2, 256, 70), (8, 64, 8, 96), (3, 150, 2, 96), (2, 50, 3, 80), (3, 70, 2, 33)]


def _qkv(shape, n, g, dev, dtype):
    """n tensors: q (B, Tq, H, Dh), then k and v (B, Tk, H, Dh), then the rest
    shaped as q; shape is (B, Tq, H, Dh) or (B, Tq, H, Dh, Tk)."""
    B, Tq, H, Dh, *rest = shape
    Tk = rest[0] if rest else Tq
    shapes = [(B, Tq, H, Dh), (B, Tk, H, Dh), (B, Tk, H, Dh)] + [(B, Tq, H, Dh)] * (n - 3)
    return [torch.randn(sh, generator=g).to(dev, dtype) for sh in shapes[:n]]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("stats", [False, True])
def test_flash_kernel_matches_plain(cuda, shape, dtype, causal, stats):
    g = torch.Generator().manual_seed(0)
    q, k, v = _qkv(shape, 3, g, cuda, dtype)
    lens = _lens(k.shape[0], k.shape[1]).to(cuda)
    before = tatt.flash_attention_cuda.launches
    got = tatt.flash_attention_cuda(q, k, v, lens, causal, return_stats=stats)
    torch.cuda.synchronize()
    assert tatt.flash_attention_cuda.launches == before + 1
    ref = tatt.flash_attention_plain(q, k, v, lens, causal, return_stats=stats)
    if stats:
        (got, m, l), (ref, ref_m, ref_l) = got, ref
        torch.testing.assert_close(m, ref_m, rtol=0, atol=1e-4)
        torch.testing.assert_close(l, ref_l, rtol=1e-5, atol=0)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=atol)


def _misaligned(x):
    """x's values in a view whose base sits 2 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    view = buf.as_strided(x.shape, x.stride(), storage_offset=1)
    view.copy_(x)
    assert not tatt.tma_aligned(view.data_ptr(), view.element_size(), view.shape, view.stride())
    return view


def test_flash_kernels_copy_views_that_tma_cannot_read(cuda):
    """bf16 views off the 16-byte rule are copied (and counted), then run on
    the tensor-core path with the plain results."""
    g = torch.Generator().manual_seed(7)
    shape = (2, 70, 2, 64)
    q, k, v, go = (torch.randn(shape, generator=g).to(cuda, torch.bfloat16) for _ in range(4))
    lens = torch.tensor([70, 1], dtype=torch.int32, device=cuda)
    fc, bc = tatt.flash_attention_cuda.layout_copies, tatt.flash_attention_bwd_cuda.layout_copies
    out, m, l = tatt.flash_attention_cuda(_misaligned(q), k, v, lens, True, return_stats=True)
    got = tatt.flash_attention_bwd_cuda(q, _misaligned(k), v, lens, True, _misaligned(go), m, l)
    torch.cuda.synchronize()
    assert tatt.flash_attention_cuda.layout_copies == fc + 1
    assert tatt.flash_attention_bwd_cuda.layout_copies == bc + 2
    torch.testing.assert_close(out.float(), tatt.flash_attention_plain(q, k, v, lens, True).float(),
                               rtol=0, atol=2e-2)
    want = tatt.flash_attention_bwd_plain(q, k, v, lens, True, go, m, l)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close_to_max(a, b, 2e-2, name)


@pytest.mark.parametrize("dtype,head_dim,tc,bwd_tc", [
    (torch.bfloat16, 64, True, True), (torch.bfloat16, 96, True, True),
    (torch.bfloat16, 128, True, True), (torch.bfloat16, 256, True, True),
    (torch.bfloat16, 320, False, False), (torch.float32, 64, False, False),
    (torch.float32, 96, False, False), (torch.float32, 128, False, False)])
def test_tensor_core_counters_follow_the_dispatch(cuda, dtype, head_dim, tc, bwd_tc):
    g = torch.Generator().manual_seed(8)
    q, k, v, go = (torch.randn(2, 40, 2, head_dim, generator=g).to(cuda, dtype) for _ in range(4))
    f0, b0 = tatt.flash_attention_cuda.tc_launches, tatt.flash_attention_bwd_cuda.tc_launches
    _, m, l = tatt.flash_attention_cuda(q, k, v, None, True, return_stats=True)
    tatt.flash_attention_bwd_cuda(q, k, v, None, True, go, m, l)
    torch.cuda.synchronize()
    assert tatt.flash_attention_cuda.tc_launches == f0 + tc
    assert tatt.flash_attention_bwd_cuda.tc_launches == b0 + bwd_tc
    # the SIMT path on request gives the same function
    simt = tatt.flash_attention_cuda(q, k, v, None, True, simt=True)
    assert tatt.flash_attention_cuda.tc_launches == f0 + tc
    torch.testing.assert_close(simt.float(), tatt.flash_attention_plain(q, k, v, None, True).float(),
                               rtol=0, atol=1e-4 if dtype == torch.float32 else 2e-2)


def test_tensor_core_kernels_launch_from_a_fresh_thread(cuda):
    """The first launch from a thread that has made no CUDA call of its own
    (as PyTorch's autograd worker may be): the launcher binds the context
    before it encodes the tensor maps."""
    import threading

    g = torch.Generator().manual_seed(13)
    q, k, v, go = (torch.randn(3, 70, 2, 128, generator=g).to(cuda, torch.bfloat16) for _ in range(4))
    got, errors = [], []

    def run():
        try:
            out, m, l = tatt.flash_attention_cuda(q, k, v, None, False, return_stats=True)
            got.append((out, tatt.flash_attention_bwd_cuda(q, k, v, None, False, go, m, l), m, l))
            torch.cuda.synchronize()
        except Exception as e:  # handed to the test's thread
            errors.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert not errors, errors
    out, grads, m, l = got[0]
    torch.testing.assert_close(out.float(), tatt.flash_attention_plain(q, k, v).float(), rtol=0, atol=2e-2)
    for name, a, b in zip(("dq", "dk", "dv"), grads,
                          tatt.flash_attention_bwd_plain(q, k, v, None, False, go, m, l)):
        _close_to_max(a, b, 2e-2, f"fresh thread {name}")


def test_flash_kernel_reads_strided_views(cuda):
    """q, k, v as views into one packed (B, T, 3, H, Dh) tensor."""
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(2, 50, 3, 4, 64, generator=g).to(cuda)
    q, k, v = qkv.unbind(2)
    lens = torch.tensor([50, 17], dtype=torch.int32, device=cuda)
    got = tatt.flash_attention_cuda(q, k, v, lens, causal=True)
    ref = tatt.flash_attention_plain(q, k, v, lens, causal=True)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(1, 8, 2, 320, device=cuda)  # above 256: the SIMT kernels run it as two chunks of 256
    out = tatt.flash_attention_cuda(x, x, x)
    torch.cuda.synchronize()
    assert out.shape == x.shape and not out.any()
    with pytest.raises(ValueError, match="head dim"):
        tatt.flash_attention_cuda(x[..., :0], x[..., :0], x[..., :0])
    y = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        tatt.flash_attention_cuda(y, y.bfloat16(), y)
    with pytest.raises(ValueError, match="unit stride"):
        tatt.flash_attention_cuda(y.transpose(1, 3).contiguous().transpose(1, 3), y, y)


BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _close_to_max(got, ref, rel, what):
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    assert torch.isfinite(got).all(), what
    assert err <= rel * ref.abs().max().item(), f"{what}: err {err} vs max {ref.abs().max().item()}"


@pytest.mark.parametrize("shape", [(4, 1, 2, 64, 70), (4, 32, 2, 64), (2, 300, 4, 64),
                                   (4, 1000, 2, 64), (3, 77, 4, 128), (2, 40, 2, 256),
                                   (2, 300, 4, 256), (8, 64, 8, 96), (3, 150, 2, 96),
                                   (2, 50, 3, 80), (3, 70, 2, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_kernel_matches_plain(cuda, shape, dtype, causal):
    g = torch.Generator().manual_seed(3)
    q, k, v, go = _qkv(shape, 4, g, cuda, dtype)
    lens = _lens(k.shape[0], k.shape[1]).to(cuda)
    out, m, l = tatt.flash_attention_cuda(q, k, v, lens, causal, return_stats=True)
    ref_out, ref_m, ref_l = tatt.flash_attention_plain(q, k, v, lens, causal, return_stats=True)
    torch.testing.assert_close(m, ref_m, rtol=0, atol=1e-4)
    torch.testing.assert_close(l, ref_l, rtol=1e-5, atol=0)
    before = tatt.flash_attention_bwd_cuda.launches
    got = tatt.flash_attention_bwd_cuda(q, k, v, lens, causal, go, m, l)
    torch.cuda.synchronize()
    assert tatt.flash_attention_bwd_cuda.launches == before + 1
    want = tatt.flash_attention_bwd_plain(q, k, v, lens, causal, go, m, l)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _close_to_max(a, b, BWD_RTOL[dtype], f"{name} {shape} {dtype} causal={causal}")


def test_flash_backward_kernel_reads_strided_views(cuda):
    """q, k, v as views into one packed (B, T, 3, H, Dh) tensor, g a
    transposed view: read in place through their strides."""
    g = torch.Generator().manual_seed(4)
    q, k, v = torch.randn(2, 50, 3, 4, 64, generator=g).to(cuda).unbind(2)
    go = torch.randn(2, 4, 50, 64, generator=g).to(cuda).transpose(1, 2)
    lens = torch.tensor([50, 17], dtype=torch.int32, device=cuda)
    _, m, l = tatt.flash_attention_cuda(q, k, v, lens, True, return_stats=True)
    got = tatt.flash_attention_bwd_cuda(q, k, v, lens, True, go, m, l)
    want = tatt.flash_attention_bwd_plain(q, k, v, lens, True, go, m, l)
    for a, b in zip(got, want):
        _close_to_max(a, b, 1e-4, "strided")


def test_autograd_on_the_card_matches_the_cpu(cuda):
    """The Function launches kernels B and C once each and gives the CPU
    (plain) gradients."""
    g = torch.Generator().manual_seed(5)
    x = [torch.randn(2, 64, 2, 64, generator=g) for _ in range(4)]
    lens = torch.tensor([64, 0], dtype=torch.int32)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).detach().requires_grad_() for t in x[:3]]
        fb, bb = tatt.flash_attention_cuda.launches, tatt.flash_attention_bwd_cuda.launches
        tatt.flash_attention(*leaves, lens.to(dev), True).backward(x[3].to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert tatt.flash_attention_cuda.launches == fb + 1
            assert tatt.flash_attention_bwd_cuda.launches == bb + 1
        grads[str(dev)] = [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        _close_to_max(a, b, 1e-4, "autograd")


def test_autograd_at_head_dim_256_bf16_matches_the_cpu(cuda):
    """bf16 at head dim 256: the tensor-core forward and backward (each
    launched once) against the plain versions on the CPU; 2e-2 on the
    output and of each gradient's largest magnitude (bf16 roundings)."""
    g = torch.Generator().manual_seed(9)
    x = [torch.randn(3, 70, 2, 256, generator=g).bfloat16() for _ in range(4)]
    lens = torch.tensor([70, 0, 9], dtype=torch.int32)
    out, grads = {}, {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).detach().requires_grad_() for t in x[:3]]
        f0, b0 = tatt.flash_attention_cuda.tc_launches, tatt.flash_attention_bwd_cuda.launches
        bt0 = tatt.flash_attention_bwd_cuda.tc_launches
        y = tatt.flash_attention(*leaves, lens.to(dev), False)
        y.backward(x[3].to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert tatt.flash_attention_cuda.tc_launches == f0 + 1
            assert tatt.flash_attention_bwd_cuda.launches == b0 + 1
            assert tatt.flash_attention_bwd_cuda.tc_launches == bt0 + 1
        out[str(dev)] = y.detach().float().cpu()
        grads[str(dev)] = [t.grad.cpu() for t in leaves]
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=0, atol=2e-2)
    for name, a, b in zip(("dq", "dk", "dv"), grads["cuda"], grads["cpu"]):
        _close_to_max(a, b, 2e-2, f"autograd bf16 Dh 256 {name}")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_kernel_at_the_mrte_shape_bf16(cuda, causal):
    """The GAN step's phone encoder under ``use_flash``: (8, 64, 2, 256)
    bf16 with edge lengths (0, 1, partial tiles), on kernel C's tensor-core
    path (two blocks split the output columns), and on its SIMT path when
    asked."""
    g = torch.Generator().manual_seed(10)
    q, k, v, go = _qkv((8, 64, 2, 256), 4, g, cuda, torch.bfloat16)
    lens = torch.tensor([64, 0, 33, 63, 1, 17, 64, 48], dtype=torch.int32, device=cuda)
    _, m, l = tatt.flash_attention_cuda(q, k, v, lens, causal, return_stats=True)
    want = tatt.flash_attention_bwd_plain(q, k, v, lens, causal, go, m, l)
    for simt in (False, True):
        before, tc = tatt.flash_attention_bwd_cuda.launches, tatt.flash_attention_bwd_cuda.tc_launches
        got = tatt.flash_attention_bwd_cuda(q, k, v, lens, causal, go, m, l, simt=simt)
        torch.cuda.synchronize()
        assert tatt.flash_attention_bwd_cuda.launches == before + 1
        assert tatt.flash_attention_bwd_cuda.tc_launches == tc + (not simt)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            _close_to_max(a, b, BWD_RTOL[torch.bfloat16], f"MRTE {name} causal={causal} simt={simt}")


@pytest.mark.parametrize("head_dim", [257, 320, 512, 640])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_above_head_dim_256(cuda, head_dim, dtype, causal):
    """Head dims above 256 on the SIMT path, zero-padded to the next
    multiple of 256 and run as chunks of 256 columns (257, 320 and 512 as
    two, 640 as three); forward, row statistics and backward against the
    plain versions."""
    g = torch.Generator().manual_seed(12)
    q, k, v, go = _qkv((3, 70, 2, head_dim), 4, g, cuda, dtype)
    lens = _lens(3, 70).to(cuda)
    tc = tatt.flash_attention_cuda.tc_launches, tatt.flash_attention_bwd_cuda.tc_launches
    out, m, l = tatt.flash_attention_cuda(q, k, v, lens, causal, return_stats=True)
    ref, ref_m, ref_l = tatt.flash_attention_plain(q, k, v, lens, causal, return_stats=True)
    got = tatt.flash_attention_bwd_cuda(q, k, v, lens, causal, go, m, l)
    torch.cuda.synchronize()
    assert (tatt.flash_attention_cuda.tc_launches, tatt.flash_attention_bwd_cuda.tc_launches) == tc
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=1e-4 if dtype == torch.float32 else 2e-2)
    torch.testing.assert_close(m, ref_m, rtol=0, atol=1e-4)
    torch.testing.assert_close(l, ref_l, rtol=1e-5, atol=0)
    want = tatt.flash_attention_bwd_plain(q, k, v, lens, causal, go, m, l)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape
        _close_to_max(a, b, BWD_RTOL[dtype], f"{name} Dh {head_dim} {dtype} causal={causal}")


def test_flash_backward_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(1, 8, 2, 320, device=cuda)  # above 256: the SIMT kernels run it as two chunks of 256
    st = torch.ones(1, 2, 8, device=cuda)
    grads = tatt.flash_attention_bwd_cuda(x, x, x, None, False, x, st, st)
    torch.cuda.synchronize()
    assert all(t.shape == x.shape and not t.any() for t in grads)
    y = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="m must be"):
        tatt.flash_attention_bwd_cuda(y, y, y, None, False, y, st.double(), st)
    with pytest.raises(ValueError, match="g must match"):
        tatt.flash_attention_bwd_cuda(y, y, y, None, False, y.bfloat16(), st, st)


@pytest.mark.parametrize("shape", [(1, 64001), (8, 131000), (2, 777), (5000,), (1, 513), (3, 131000)])
def test_mel_kernel_matches_plain(cuda, shape):
    g = torch.Generator().manual_seed(2)
    y = (torch.randn(shape, generator=g) * 0.1).to(cuda)
    before = tmel.mel_spectrogram_cuda.launches
    got = tmel.mel_spectrogram_cuda(y)
    torch.cuda.synchronize()
    assert tmel.mel_spectrogram_cuda.launches == before + 1
    ref = tmel.mel_spectrogram_plain(y)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-3)


# the training path's (8, 16384) and the shipped config's (16, 16384), with
# the trainer's [:, :64] slice and whole; the signals of the forward's
# checks; the block plan's edges (ops/mel.py::bwd_plan): rows of 5 frames
# (shorter than a block), 7 and 28 frames (the block before the last gives
# up one), 24 (one whole cluster), 25 (the last block a cluster's first,
# giving up one), 66
MEL_BWD_SHAPES = [((8, 16384), 64), ((8, 16384), None), ((16, 16384), 64), ((16, 16384), None),
                  ((1, 513), None), ((3, 777), None), ((8, 131000), None), ((2, 1024), None),
                  ((2, 1025), None), ((2, 1279), None), ((2, 1536), None), ((3, 5888), None),
                  ((2, 6144), None), ((2, 6912), None), ((2, 16640), None)]


@pytest.mark.parametrize("shape,keep", MEL_BWD_SHAPES)
def test_mel_backward_kernel_matches_plain(cuda, shape, keep):
    """Kernel A's backward against autograd through the plain mel, within
    1e-4 of the gradient's largest magnitude (the FFTs and sums in other
    orders; log's 1/mel amplifies where a mel is small); one device kernel
    a call; a second call, and the halo-only variant (clusters of one
    block), give the same bits."""
    from megatts2_tpu_torch.tools.kernel_times import device_kernels

    g = torch.Generator().manual_seed(3)
    y = (torch.randn(shape, generator=g) * 0.1).to(cuda)
    T = tmel.num_frames(shape[-1])
    g_mel = torch.randn(shape[0], T, 80, generator=g).to(cuda)
    if keep is not None:
        g_mel[:, keep:] = 0  # what the slice's backward hands on
    before = tmel.mel_spectrogram_bwd_cuda.launches
    got = tmel.mel_spectrogram_bwd_cuda(y, g_mel)
    torch.cuda.synchronize()
    assert tmel.mel_spectrogram_bwd_cuda.launches == before + 1
    ref = tmel.mel_spectrogram_bwd_plain(y, g_mel)
    assert got.shape == ref.shape == y.shape
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    names = device_kernels(lambda: tmel.mel_spectrogram_bwd_cuda(y, g_mel))
    assert len(names) == 1 and "mel_bwd" in names[0], names
    assert torch.equal(tmel.mel_spectrogram_bwd_cuda(y, g_mel), got)
    assert torch.equal(tmel.mel_spectrogram_bwd_cuda(y, g_mel, cluster=1), got)


def test_mel_records_a_grad_fn_that_launches_the_backward(cuda):
    """On a CUDA signal that requires grad, ``mel_spectrogram`` records
    kernel A's Function; a non-contiguous view (a vocoder's output is a
    slice) gets its gradient back through the copy."""
    g = torch.Generator().manual_seed(7)
    base = (torch.randn(2, 4200, generator=g) * 0.1).to(cuda).requires_grad_()
    y = base[:, 50:4150]
    assert not y.is_contiguous()
    fwd, bwd = tmel.mel_spectrogram_cuda.launches, tmel.mel_spectrogram_bwd_cuda.launches
    mel = tmel.mel_spectrogram(y)
    assert mel.grad_fn is not None
    g_mel = torch.randn(mel.shape, generator=g).to(cuda)
    mel.backward(g_mel)
    torch.cuda.synchronize()
    assert tmel.mel_spectrogram_cuda.launches == fwd + 1
    assert tmel.mel_spectrogram_bwd_cuda.launches == bwd + 1
    ref = tmel.mel_spectrogram_bwd_plain(y.detach().contiguous(), g_mel)
    want = torch.zeros_like(base)
    want[:, 50:4150] = ref
    assert (base.grad - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_mel_backward_on_silence_is_zero(cuda):
    """|X| = 0 and every mel under the clamp: no gradient, no NaN."""
    got = tmel.mel_spectrogram_bwd_cuda(torch.zeros(2, 3000, device=cuda),
                                        torch.ones(2, tmel.num_frames(3000), 80, device=cuda))
    assert torch.equal(got, torch.zeros_like(got))


def test_mel_backward_rejects_what_it_does_not_take(cuda):
    y = torch.zeros(2, 3000, device=cuda)
    g_mel = torch.zeros(2, tmel.num_frames(3000), 80, device=cuda)
    with pytest.raises(ValueError, match="g_mel"):
        tmel.mel_spectrogram_bwd_cuda(y, torch.zeros(2, 5, 80, device=cuda))
    with pytest.raises(ValueError, match="g_mel"):
        tmel.mel_spectrogram_bwd_cuda(y, g_mel.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        tmel.mel_spectrogram_bwd_cuda(torch.zeros(3000, 2, device=cuda).t(), g_mel)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmel.mel_spectrogram_bwd_cuda(y.cpu(), g_mel)
    with pytest.raises(ValueError, match="float32"):
        tmel.mel_spectrogram_bwd_cuda(y.double(), g_mel)
    with pytest.raises(ValueError, match="more than 512"):
        tmel.mel_spectrogram_bwd_cuda(torch.zeros(2, 500, device=cuda), torch.zeros(2, 2, 80, device=cuda))
    with pytest.raises(RuntimeError, match="mel backward kernel"):  # the launcher refuses clusters above 8
        tmel.mel_spectrogram_bwd_cuda(y, g_mel, cluster=9)


def test_mel_backward_takes_a_g_mel_of_another_type_or_layout(cuda):
    """A bf16 or non-contiguous g_mel is copied to fp32 first: the same bits."""
    g = torch.Generator().manual_seed(9)
    y = (torch.randn(2, 3000, generator=g) * 0.1).to(cuda)
    g_mel = torch.randn(2, tmel.num_frames(3000), 80, generator=g).to(cuda)
    want = tmel.mel_spectrogram_bwd_cuda(y, g_mel.bfloat16().float())
    assert torch.equal(tmel.mel_spectrogram_bwd_cuda(y, g_mel.bfloat16()), want)
    strided = g_mel.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous()
    assert torch.equal(tmel.mel_spectrogram_bwd_cuda(y, strided), tmel.mel_spectrogram_bwd_cuda(y, g_mel))


def test_mel_kernel_launches_without_grad(cuda):
    """Under ``no_grad``, or on a detached signal, the forward kernel runs
    alone and records nothing."""
    y = (torch.randn(2, 4000, generator=torch.Generator().manual_seed(8)) * 0.1).to(cuda)
    y.requires_grad_()
    before = tmel.mel_spectrogram_cuda.launches
    with torch.no_grad():
        a = tmel.mel_spectrogram(y)
    b = tmel.mel_spectrogram(y.detach())
    torch.cuda.synchronize()
    assert tmel.mel_spectrogram_cuda.launches == before + 2
    ref = tmel.mel_spectrogram_plain(y.detach())
    for got in (a, b):
        assert not got.requires_grad
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-3)


def test_mel_kernel_on_silence_hits_the_clamp(cuda):
    got = tmel.mel_spectrogram_cuda(torch.zeros(1, 3000, device=cuda))
    np.testing.assert_allclose(got.cpu().numpy(), np.log(1e-5), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(3, 16, 256), (144, 256, 4096)])
@pytest.mark.parametrize("steps", [1, 2, 16])
def test_pump_kernel_matches_plain(cuda, shape, steps):
    g = torch.Generator().manual_seed(6)
    w = torch.randint(-127, 127, shape, generator=g, dtype=torch.int8).to(cuda)
    before = tpump.pump_cuda.launches
    head, total = tpump.pump_cuda(w, steps)
    torch.cuda.synchronize()
    assert tpump.pump_cuda.launches == before + 1
    want_head, want_total = tpump.pump_plain(w, steps)
    assert head.shape == (1, 1) and head.dtype == torch.float32 and total.dtype == torch.int64
    assert torch.equal(head, want_head) and torch.equal(total, want_total)


def test_pump_kernel_rejects_what_it_does_not_take(cuda):
    w = torch.zeros(3, 16, 256, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tpump.pump_cuda(w.transpose(1, 2), 1)
    with pytest.raises(ValueError, match="int8"):
        tpump.pump_cuda(w.float(), 1)
    with pytest.raises(ValueError, match="cols"):
        tpump.pump_cuda(torch.zeros(3, 16, 64, dtype=torch.int8, device=cuda), 1)


def test_wrappers_record_launch_shapes_only_when_asked(cuda):
    """With ``.shapes`` a set, each launch adds its signature; with None
    (the default) nothing is kept."""
    g = torch.Generator().manual_seed(5)
    fns = (tmel.mel_spectrogram_cuda, tmel.mel_spectrogram_bwd_cuda, tatt.flash_attention_cuda,
           tatt.flash_attention_bwd_cuda)
    assert all(fn.shapes is None for fn in fns)
    y = torch.randn(2, 3000, generator=g).to(cuda)
    q, k, v, go = _qkv((2, 40, 2, 64, 50), 4, g, cuda, torch.bfloat16)
    lens = _lens(2, 50).to(cuda)
    try:
        for fn in fns:
            fn.shapes = set()
        tmel.mel_spectrogram_cuda(y)
        tmel.mel_spectrogram_bwd_cuda(y, torch.ones(2, tmel.num_frames(3000), 80, device=cuda))
        _, m, l = tatt.flash_attention_cuda(q, k, v, lens, return_stats=True)
        tatt.flash_attention_cuda(q, k, v, None, True, simt=True)
        tatt.flash_attention_bwd_cuda(q, k, v, lens, False, go, m, l)
        assert fns[0].shapes == {(2, 3000)} and fns[1].shapes == {(2, 3000)}
        assert fns[2].shapes == {(2, 40, 50, 2, 64, torch.bfloat16, False, True, True, True),
                                 (2, 40, 50, 2, 64, torch.bfloat16, True, False, False, False)}
        assert fns[3].shapes == {(2, 40, 50, 2, 64, torch.bfloat16, False, True, True)}
    finally:
        for fn in fns:
            fn.shapes = None


def test_generator_loader_reads_the_ema_weights_of_a_card_trained_state(cuda, tmp_path):
    """A GAN train state on the card whose ``g_ema`` differs from G: the
    loader gives the ``g_ema`` parameters and G's buffers (the codebook)."""
    from megatts2_tpu_torch.config import load_gan_config
    from megatts2_tpu_torch.models.pretrained import megag_from_pretrained
    from megatts2_tpu_torch.training import create_gan_state
    from megatts2_tpu_torch.training.checkpoints import save_checkpoint
    from pipeline_fixtures import GAN_YAML

    cfg = tmp_path / "gan.yaml"
    cfg.write_text(GAN_YAML.format(steps=1, val=1, ds="unused").replace(
        "trainer:\n", "trainer:\n  g_ema_decay: 0.9\n", 1))
    state = create_gan_state(*load_gan_config(str(cfg)), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        state.g.vqpe.vq.layers[0]._codebook.embed.normal_(generator=gen)
        state.g_ema = {n: p + 0.01 * torch.randn(p.shape, generator=gen, device=cuda)
                       for n, p in state.g.named_parameters()}
    path = save_checkpoint(str(tmp_path / "ck"), state, 1)
    _, g = megag_from_pretrained(path, str(cfg))
    g = g.to(cuda)
    for name, p in g.named_parameters():
        assert torch.equal(p, state.g_ema[name]), name
    want = dict(state.g.named_buffers())
    for name, b in g.named_buffers():
        assert torch.equal(b, want[name]), name
