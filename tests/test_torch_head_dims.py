"""Kernels B and C at every head dim: the wrappers zero-pad a head dim that
is no kernel instance to the next one (above 256, to the next multiple of
256, which the SIMT kernels run in chunks) and pass the true head dim's
softmax scale.  Here the same plan runs through the plain versions on the
CPU and is held against plain attention at the true head dim, and the
plain versions at head dim 320 against JAX's Pallas kernel; the kernels
themselves are held on the card (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from megatts2_tpu_torch.ops import attention as att


@pytest.mark.parametrize("dh,inst", [(1, 64), (48, 64), (64, 64), (80, 96), (96, 96),
                                     (100, 128), (200, 256), (256, 256)])
def test_instance_head_dim(dh, inst):
    assert att.instance_head_dim(dh) == inst


@pytest.mark.parametrize("dh,inst", [(257, 512), (320, 512), (512, 512), (513, 768),
                                     (640, 768)])
def test_instance_head_dim_above_256(dh, inst):
    """The next multiple of 256, run by the SIMT kernels as chunks of 256
    columns."""
    assert att.instance_head_dim(dh) == inst
    assert inst % att.WIDE_CHUNK == 0
    assert not att.uses_tensor_cores(torch.bfloat16, inst)


def test_plain_versions_at_head_dim_320_match_jax():
    """Head dim 320, fp32: the plain forward and backward against JAX's
    ``flash_attention`` in Pallas interpret mode and ``flash_attention_vjp``
    (its custom backward, with the Pallas forward) under ``FLASH_ON_CPU``.
    1e-5: the same fp32 products summed in other orders."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from megatts2_tpu.nn import transformer as jtr
    from megatts2_tpu.ops.attention_pallas import flash_attention, flash_attention_vjp

    rng = np.random.RandomState(0)
    q, k, v, go = (rng.randn(2, 20, 2, 320).astype(np.float32) for _ in range(4))
    lens = np.array([20, 7], np.int32)
    for causal in (False, True):
        want = np.asarray(flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(lens), causal, interpret=True))
        jtr.FLASH_ON_CPU = True
        try:
            with pltpu.force_tpu_interpret_mode():
                _, vjp = jax.vjp(lambda a, b, c: flash_attention_vjp(a, b, c, jnp.asarray(lens), causal),
                                 jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
                want_grads = [np.asarray(x) for x in vjp(jnp.asarray(go))]
        finally:
            jtr.FLASH_ON_CPU = False
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        out = att.flash_attention(tq, tk, tv, torch.from_numpy(lens), causal)
        out.backward(torch.from_numpy(go))
        np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=1e-5)
        for name, t, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want_grads):
            np.testing.assert_allclose(t.grad.numpy(), w, rtol=0, atol=1e-5,
                                       err_msg=f"{name} causal={causal}")


def _inputs(dh, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v, go = (torch.randn(3, 37, 2, dh, generator=g).to(dtype) for _ in range(4))
    return q, k, v, go, torch.tensor([37, 0, 20], dtype=torch.int32)


@pytest.mark.parametrize("dh", [80, 96, 33])
@pytest.mark.parametrize("causal", [False, True])
def test_padding_plan_forward_and_backward(dh, causal):
    """fp32: zero columns add exact zeros to each q.k and each product, so
    the padded plan agrees with the true head dim to fp32 rounding of the
    sum order (1e-6); the padded output and gradient columns are zero."""
    q, k, v, go, lens = _inputs(dh, torch.float32)
    D = att.instance_head_dim(dh)
    scale = dh**-0.5
    pq, pk, pv, pg = (att.pad_head_dim(t, D) for t in (q, k, v, go))
    out, m, l = att.flash_attention_plain(pq, pk, pv, lens, causal, return_stats=True, scale=scale)
    ref, rm, rl = att.flash_attention_plain(q, k, v, lens, causal, return_stats=True)
    torch.testing.assert_close(out[..., :dh], ref, rtol=0, atol=1e-6)
    torch.testing.assert_close(m, rm, rtol=0, atol=1e-6)
    torch.testing.assert_close(l, rl, rtol=1e-6, atol=0)
    assert not out[..., dh:].any()
    grads = att.flash_attention_bwd_plain(pq, pk, pv, lens, causal, pg, m, l, scale=scale)
    want = att.flash_attention_bwd_plain(q, k, v, lens, causal, go, rm, rl)
    for got, ref in zip(grads, want):
        torch.testing.assert_close(got[..., :dh], ref, rtol=0, atol=1e-6)
        assert not got[..., dh:].any()


def test_padding_plan_needs_the_true_scale():
    """The control: the instance's own scale (96^-0.5) misses at Dh 80."""
    q, k, v, _, lens = _inputs(80, torch.float32)
    pq, pk, pv = (att.pad_head_dim(t, 96) for t in (q, k, v))
    wrong = att.flash_attention_plain(pq, pk, pv, lens)[..., :80]
    assert (wrong - att.flash_attention_plain(q, k, v, lens)).abs().max() > 1e-3


def test_padding_plan_bf16():
    """bf16 inputs: the products run in fp32 over the same bf16 values, so
    the padded plan equals the true head dim's output to one bf16 rounding."""
    q, k, v, _, lens = _inputs(80, torch.bfloat16)
    pq, pk, pv = (att.pad_head_dim(t, 96) for t in (q, k, v))
    got = att.flash_attention_plain(pq, pk, pv, lens, scale=80**-0.5)[..., :80]
    ref = att.flash_attention_plain(q, k, v, lens)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=1e-2)
    assert (got != ref).float().mean() < 0.01
