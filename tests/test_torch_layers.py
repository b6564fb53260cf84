"""The port's layers held against the JAX package on the CPU at tiny
widths: the transformer encoder (conv and linear FF, flash on and off,
cross-attention), the conv stacks and the embeddings.  JAX parameters are
initialised, perturbed with numpy noise (so biases and norms are not at
their defaults) and carried across with the weight bridge; both sides
compute in fp32.  Tolerance atol 1e-4: fp32 with different reduction
orders through a few layers."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from megatts2_tpu_torch.bridge import load_flax_params

KEY = jax.random.PRNGKey(0)


def _perturbed(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + np.float32(0.1) * np.asarray(rng.randn(*np.shape(x)), np.float32),
        tree,
    )


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.mark.parametrize(
    "use_flash,causal,with_lens",
    [(False, False, True), (True, False, True), (True, True, True), (False, True, True),
     (True, True, False)],
)
def test_transformer_encoder_matches_jax(use_flash, causal, with_lens):
    """Conv-FF encoder (norm2 outside the residual); the flash path takes
    k_lens, or full lengths when only causal."""
    from jax.experimental.pallas import tpu as pltpu

    from megatts2_tpu.nn import TransformerEncoder as JEnc
    from megatts2_tpu.nn import transformer as jtr
    from megatts2_tpu_torch.nn import TransformerEncoder

    B, T, D, H = 2, 11, 16, 2
    rng = np.random.RandomState(1)
    x = rng.randn(B, T, D).astype(np.float32)
    lens = np.array([6, 11], np.int32) if with_lens else None
    jlens = None if lens is None else jnp.asarray(lens)
    jenc = JEnc(dim=D, ff_dim=32, num_layers=2, conv_ff=True, n_heads=H, use_flash=use_flash)
    params = _perturbed(jenc.init(KEY, jnp.asarray(x), x_lens=jlens)["params"], 2)
    jtr.FLASH_ON_CPU = use_flash
    try:
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(
                jenc.apply({"params": params}, jnp.asarray(x), x_lens=jlens, causal=causal)
            )
    finally:
        jtr.FLASH_ON_CPU = False

    enc = load_flax_params(TransformerEncoder(D, 32, 2, n_heads=H, use_flash=use_flash), params)
    tlens = None if lens is None else torch.from_numpy(lens)
    got = enc(_t(x), x_lens=tlens, causal=causal).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_cross_attention_matches_jax():
    from megatts2_tpu.nn import MultiHeadAttention as JMHA
    from megatts2_tpu_torch.nn import MultiHeadAttention

    rng = np.random.RandomState(3)
    q = rng.randn(2, 5, 16).astype(np.float32)
    kv = rng.randn(2, 7, 16).astype(np.float32)
    jm = JMHA(qkv_dim=16, n_heads=1)
    params = _perturbed(jm.init(KEY, jnp.asarray(q), kv=jnp.asarray(kv))["params"], 4)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(q), kv=jnp.asarray(kv)))
    m = load_flax_params(MultiHeadAttention(16, n_heads=1), params)
    np.testing.assert_allclose(m(_t(q), kv=_t(kv)).detach().numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("stride,T", [(16, 37), (16, 48), (8, 21)])
def test_convnet_double_matches_jax(stride, T):
    """Two summed branches share one strided-conv middle layer; ragged T
    checks its ceil(T / stride) output length."""
    from megatts2_tpu.nn import ConvNetDouble as JCND
    from megatts2_tpu_torch.nn import ConvNetDouble

    args = dict(in_channels=10, out_channels=12, hidden_size=16, n_layers=2, n_stacks=2,
                n_blocks=2, kernel_size=3, activation="ReLU", middle_kind="conv",
                middle_stride=stride)
    x = np.random.RandomState(5).randn(2, T, 10).astype(np.float32)
    jm = JCND(**args)
    params = _perturbed(jm.init(KEY, jnp.asarray(x))["params"], 6)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    m = load_flax_params(ConvNetDouble(**args), params)
    got = m(_t(x)).detach().numpy()
    assert got.shape == ref.shape == (2, -(-T // stride), 12)
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("T", [45, 48, 3])
def test_convnet_double_maxpool_matches_jax(T):
    """The VQPE's middle: MaxPool1d(8, ceil_mode), whose last window takes
    the frames left (JAX pads it with -inf); no weights of its own."""
    from megatts2_tpu.nn import ConvNetDouble as JCND
    from megatts2_tpu_torch.nn import ConvNetDouble

    args = dict(in_channels=20, out_channels=8, hidden_size=16, n_layers=3, n_stacks=1,
                n_blocks=2, kernel_size=5, activation="ReLU", middle_kind="maxpool",
                middle_stride=8)
    x = np.random.RandomState(11).randn(2, T, 20).astype(np.float32)
    jm = JCND(**args)
    params = _perturbed(jm.init(KEY, jnp.asarray(x))["params"], 12)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = load_flax_params(ConvNetDouble(**args), params)(_t(x)).detach().numpy()
    assert got.shape == ref.shape == (2, -(-T // 8), 8)
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("activation", ["ReLU", "GELU"])
def test_convnet_matches_jax(activation):
    from megatts2_tpu.nn import ConvNet as JCN
    from megatts2_tpu_torch.nn import ConvNet

    args = dict(in_channels=24, out_channels=10, hidden_size=16, n_stacks=2, n_blocks=2,
                kernel_size=5, activation=activation)
    x = np.random.RandomState(7).randn(2, 19, 24).astype(np.float32)
    jm = JCN(**args)
    params = _perturbed(jm.init(KEY, jnp.asarray(x))["params"], 8)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = load_flax_params(ConvNet(**args), params)(_t(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_embeddings_match_jax():
    from megatts2_tpu.nn import SinePositionalEmbedding as JPos
    from megatts2_tpu.nn import TokenEmbedding as JTok
    from megatts2_tpu.nn import sinusoidal_table as jtable
    from megatts2_tpu_torch.nn import (SinePositionalEmbedding, TokenEmbedding,
                                       sinusoidal_table)

    np.testing.assert_array_equal(sinusoidal_table(64, 16), jtable(64, 16))
    ids = np.random.RandomState(9).randint(0, 30, (2, 7)).astype(np.int32)
    jtok = JTok(dim_model=16, vocab_size=30)
    params = _perturbed(jtok.init(KEY, jnp.asarray(ids))["params"], 10)
    emb = jtok.apply({"params": params}, jnp.asarray(ids))
    ref = np.asarray(JPos(dim_model=16).apply({}, emb))
    tok = load_flax_params(TokenEmbedding(16, 30), params)
    got = SinePositionalEmbedding(16)(tok(torch.from_numpy(ids).long())).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
