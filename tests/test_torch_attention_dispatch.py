"""Host logic of the port's attention kernels that runs without a card: which
(dtype, head dim) takes the tensor-core path of kernels B and C, the
16-byte rule a TMA tensor map sets on a tensor's base and strides, the copy
a view off that rule gets, and the dtype code the C entry points take."""
import pytest
import torch

from megatts2_tpu_torch.ops import attention as att


@pytest.mark.parametrize("dtype,head_dim,tc", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 96, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 256, True), (torch.float32, 64, False), (torch.float32, 128, False),
    (torch.float32, 256, False), (torch.float16, 64, False), (torch.bfloat16, 512, False),
])
def test_dispatch_table(dtype, head_dim, tc):
    """Kernel B's forward: bf16 at every instance up to 256 on the tensor
    cores (96 on 128-wide tiles); fp32, and bf16 above 256, on SIMT."""
    assert att.uses_tensor_cores(dtype, head_dim) is tc


@pytest.mark.parametrize("dtype,head_dim,tc", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 96, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 256, True), (torch.float32, 64, False), (torch.float32, 96, False),
    (torch.float32, 256, False), (torch.bfloat16, 768, False),
])
def test_backward_dispatch_table(dtype, head_dim, tc):
    """Kernel C takes the route of kernel B: bf16 96 (the ADM) and 256 (the
    MRTE) on the tensor cores too; fp32 stays on SIMT."""
    assert att.uses_tensor_cores(dtype, head_dim) is tc


def test_tensor_core_head_dims_are_kernel_instances():
    assert set(att.TC_HEAD_DIMS) <= set(att.HEAD_DIMS)


@pytest.mark.parametrize("ptr,shape,strides,ok", [
    (4096, (8, 1024, 16, 64), (1024 * 1024, 1024, 64, 1), True),  # contiguous (B, T, H, Dh)
    (4096 + 512, (2, 50, 4, 64), (50 * 768, 768, 64, 1), True),   # one of q, k, v of packed qkv
    (4096 + 2, (8, 1024, 16, 64), (1024 * 1024, 1024, 64, 1), False),  # base off by one element
    (4096 + 8, (8, 1024, 16, 64), (1024 * 1024, 1024, 64, 1), False),  # base 8 bytes off
    (4096, (2, 50, 4, 64), (50 * 4 * 65, 4 * 65, 65, 1), False),  # odd head stride
    (4096, (2, 50, 4, 64), (50 * 260 + 4, 260, 64, 1), False),  # t stride 520 bytes
    (4096, (2, 50, 4, 64), (1, 1, 50, 200), False),  # Dh not innermost
    (4096, (1, 1, 1, 64), (3, 5, 7, 1), True),  # extent-1 dims: strides unused
    (4096, (2, 1, 1, 128), (131, 7, 3, 1), False),  # ... but B = 2 uses its odd stride
])
def test_tma_rule(ptr, shape, strides, ok):
    assert att.tma_aligned(ptr, 2, shape, strides) is ok


def test_tma_rule_in_fp32_bytes():
    # 4-byte elements: a t stride of 4 elements is 16 bytes, of 2 is 8
    assert att.tma_aligned(4096, 4, (2, 8, 1, 64), (512, 4, 64, 1))
    assert not att.tma_aligned(4096, 4, (2, 8, 1, 64), (512, 2, 64, 1))


def test_views_off_the_rule_are_copied_and_counted():
    x = torch.randn(2, 10, 3, 64).to(torch.bfloat16)

    class Wrapper:
        layout_copies = 0

    assert att._tma_ready(x, Wrapper) is x and Wrapper.layout_copies == 0
    buf = torch.empty(x.numel() + 8, dtype=x.dtype)
    view = buf.as_strided(x.shape, x.stride(), storage_offset=1)
    view.copy_(x)
    got = att._tma_ready(view, Wrapper)
    assert Wrapper.layout_copies == 1
    assert got.data_ptr() % 16 == 0 and got.is_contiguous() and torch.equal(got, x)


def _fake_launcher(calls):
    """A launcher that, as the C entry points do, refuses a tensor off TMA's
    rule before launching anything, and records what it was given."""
    def launch(*tensors):
        calls.append(tensors)
        ok = all(att.tma_aligned(t.data_ptr(), t.element_size(), t.shape, t.stride()) for t in tensors)
        return 0 if ok else att._MISALIGNED
    return launch


def test_aligned_launch_is_made_once_without_copies():
    x, y = (torch.randn(2, 10, 3, 64).to(torch.bfloat16) for _ in range(2))

    class Wrapper:
        layout_copies = 0

    calls = []
    assert att._launch_tma(_fake_launcher(calls), (x, y), Wrapper) == 0
    assert len(calls) == 1 and calls[0][0] is x and calls[0][1] is y
    assert Wrapper.layout_copies == 0


def test_refused_launch_copies_the_views_off_the_rule_and_launches_again():
    x, y = (torch.randn(2, 10, 3, 64).to(torch.bfloat16) for _ in range(2))
    buf = torch.empty(y.numel() + 8, dtype=y.dtype)
    view = buf.as_strided(y.shape, y.stride(), storage_offset=1)
    view.copy_(y)

    class Wrapper:
        layout_copies = 0

    calls = []
    assert att._launch_tma(_fake_launcher(calls), (x, view), Wrapper) == 0
    assert len(calls) == 2 and Wrapper.layout_copies == 1
    assert calls[1][0] is x and calls[1][1] is not view and torch.equal(calls[1][1], y)


def test_refusal_with_nothing_to_copy_is_returned():
    """A misaligned-address error the copies cannot cure (a fault left by an
    earlier kernel) comes back to the caller, launched once."""
    x = torch.randn(2, 10, 3, 64).to(torch.bfloat16)

    class Wrapper:
        layout_copies = 0

    calls = []
    assert att._launch_tma(lambda *t: calls.append(t) or att._MISALIGNED, (x,), Wrapper) == att._MISALIGNED
    assert len(calls) == 1 and Wrapper.layout_copies == 0


def test_dtype_code():
    q32, q16 = torch.zeros(1), torch.zeros(1, dtype=torch.bfloat16)
    assert att._dtype_code(q32, False) == 0 and att._dtype_code(q32, True) == 0
    assert att._dtype_code(q16, False) == 1 and att._dtype_code(q16, True) == 2

