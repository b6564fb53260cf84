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
moves a term by one bf16 ulp; log-mel atol 1e-3, because a direct DFT and an
FFT sum 1024 terms in different orders and log(clamp(., 1e-5)) magnifies
that near the clamp; the copy pump (kernel D) exactly, since both its
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
    lens = [Tk, 0, max(1, Tk // 3)] * B
    return torch.tensor(lens[:B], dtype=torch.int32)


@pytest.mark.parametrize("shape", [(8, 64, 2, 256), (2, 1000, 16, 64), (3, 77, 4, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_matches_plain(cuda, shape, dtype, causal):
    B, T, H, Dh = shape
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g).to(cuda, dtype) for _ in range(3))
    lens = _lens(B, T).to(cuda)
    before = tatt.flash_attention_cuda.launches
    got = tatt.flash_attention_cuda(q, k, v, lens, causal)
    torch.cuda.synchronize()
    assert tatt.flash_attention_cuda.launches == before + 1
    ref = tatt.flash_attention_plain(q, k, v, lens, causal)
    assert got.dtype == dtype and got.shape == shape
    assert torch.isfinite(got).all()
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=atol)


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
    x = torch.zeros(1, 8, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        tatt.flash_attention_cuda(x, x, x)
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


@pytest.mark.parametrize("shape", [(2, 300, 4, 64), (3, 77, 4, 128), (2, 40, 2, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_kernel_matches_plain(cuda, shape, dtype, causal):
    B, T, H, Dh = shape
    g = torch.Generator().manual_seed(3)
    q, k, v, go = (torch.randn(shape, generator=g).to(cuda, dtype) for _ in range(4))
    lens = _lens(B, T).to(cuda)
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


def test_flash_backward_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(1, 8, 2, 96, device=cuda)  # the ADM's head dim at tc_emb_dim=512
    st = torch.ones(1, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        tatt.flash_attention_bwd_cuda(x, x, x, None, False, x, st, st)
    y = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="m must be"):
        tatt.flash_attention_bwd_cuda(y, y, y, None, False, y, st.double(), st)
    with pytest.raises(ValueError, match="g must match"):
        tatt.flash_attention_bwd_cuda(y, y, y, None, False, y.bfloat16(), st, st)


@pytest.mark.parametrize("shape", [(1, 64001), (8, 131000), (2, 777), (5000,)])
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
