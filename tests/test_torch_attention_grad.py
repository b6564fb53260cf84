"""The port's attention backward held against the JAX package on the CPU.

``flash_attention_bwd_plain`` (kernel C's plain version) against JAX
``_fa_bwd`` (the backward of ``flash_attention_vjp``) at T=37 with
block_q=16, so the JAX scan iterates: causal and not, ragged lengths and a
``k_len = 0`` row.  Tolerances: fp32 atol 3e-5 (the same sums in another
order, as ``tests/test_parity_extra.py`` holds ``_fa_bwd`` against the
einsum grads); bf16 2e-2 of each gradient's largest magnitude, since P and
ds are rounded to bf16 on both sides and a rounding flip moves a term by
one bf16 ulp (2^-8 relative).  The autograd Function's CPU gradients are
the plain backward's exactly, and float64 gradcheck holds on rows with
``k_len > 0`` (a ``k_len = 0`` row spreads its gradient over every key, as
``_fa_bwd`` does, which is not the derivative of its forward).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megatts2_tpu_torch.ops import attention as tatt

B, T, H, DH = 3, 37, 2, 16
LENS = [20, 37, 0]


def _inputs(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, DH).astype(np.float32).astype(dtype) for _ in range(4)]


def _jax_bwd(q, k, v, g, lens, causal, dtype=jnp.float32):
    from megatts2_tpu.ops.attention_pallas import _fa_bwd

    j = [jnp.asarray(x, dtype) for x in (q, k, v, g)]
    out = _fa_bwd(causal, (j[0], j[1], j[2], jnp.asarray(lens, jnp.int32)), j[3], block_q=16)
    return [np.asarray(x.astype(jnp.float32)) for x in out[:3]]


def _torch_bwd(q, k, v, g, lens, causal, dtype=torch.float32):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v, g)]
    k_lens = torch.tensor(lens, dtype=torch.int32)
    _, m, l = tatt.flash_attention_plain(t[0], t[1], t[2], k_lens, causal, return_stats=True)
    return tatt.flash_attention_bwd_plain(t[0], t[1], t[2], k_lens, causal, t[3], m, l)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_jax_fa_bwd(causal):
    q, k, v, g = _inputs(3)
    got = _torch_bwd(q, k, v, g, LENS, causal)
    want = _jax_bwd(q, k, v, g, LENS, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=3e-5, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_bf16_rounds_as_jax(causal):
    q, k, v, g = _inputs(4)
    got = _torch_bwd(q, k, v, g, LENS, causal, torch.bfloat16)
    want = _jax_bwd(q, k, v, g, LENS, causal, jnp.bfloat16)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16, name
        np.testing.assert_allclose(a.float().numpy(), b, rtol=0, atol=2e-2 * np.abs(b).max(),
                                   err_msg=name)


def test_zero_length_row_spreads_over_every_key():
    """A k_len = 0 row: m = -1e9 and l = Tk from the forward, so P = 1/Tk on
    every key (a log-sum-exp would give 1), and dv = sum_q g / Tk."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(5))
    k_lens = torch.tensor(LENS, dtype=torch.int32)
    out, m, l = tatt.flash_attention_plain(q, k, v, k_lens, causal=True, return_stats=True)
    assert torch.all(m[2] == -1e9) and torch.all(l[2] == T)
    assert np.float32(-1e9) + np.float32(np.log(T)) == np.float32(-1e9)  # why l is kept apart
    torch.testing.assert_close(out[2], v[2].mean(0, keepdim=True).expand(T, H, DH))
    _, _, dv = tatt.flash_attention_bwd_plain(q, k, v, k_lens, True, g, m, l)
    torch.testing.assert_close(dv[2], g[2].sum(0, keepdim=True).expand(T, H, DH) / T,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_function_grads_equal_plain_backward_on_cpu(causal):
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(6))
    k_lens = torch.tensor(LENS, dtype=torch.int32)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tatt.flash_attention(*leaves, k_lens, causal)
    assert out.grad_fn is not None and "FlashAttentionFunction" in type(out.grad_fn).__name__
    out.backward(g)
    _, m, l = tatt.flash_attention_plain(q, k, v, k_lens, causal, return_stats=True)
    want = tatt.flash_attention_bwd_plain(q, k, v, k_lens, causal, g, m, l)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    torch.testing.assert_close(out.detach(), tatt.flash_attention_plain(q, k, v, k_lens, causal))


def test_inference_keeps_the_forward_alone():
    q, k, v, _ = (torch.from_numpy(x).requires_grad_() for x in _inputs(7))
    with torch.no_grad():
        out = tatt.flash_attention(q, k, v, torch.tensor(LENS), causal=True)
    assert out.grad_fn is None
    assert torch.equal(out, tatt.flash_attention_plain(q, k, v, torch.tensor(LENS, dtype=torch.int32),
                                                       causal=True))


@pytest.mark.parametrize("causal", [False, True])
def test_gradcheck_float64_on_nonempty_rows(causal):
    rng = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(rng.randn(2, 6, 2, 8)).requires_grad_() for _ in range(3))
    k_lens = torch.tensor([6, 3], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda q, k, v: tatt.flash_attention(q, k, v, k_lens, causal), (q, k, v)
    )
