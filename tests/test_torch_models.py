"""The port's models held against the JAX package on the CPU, in fp32, at
tiny widths: MRTE ``tc_latent`` with the flash phone encoder, the codebook
lookup, ``decode_latents`` and the Vocos vocoder (the decodes are in
test_torch_decode.py).  JAX parameters are initialised, perturbed with
numpy noise and carried across with the weight bridge.  Tolerance atol
1e-4: fp32 through a few layers with different reduction orders."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from megatts2_tpu_torch import config as tcfg
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


def _torch_cfg(jax_cfg):
    """The port's config with the same values as a JAX config (nested too)."""
    import dataclasses

    kw = {}
    for f in dataclasses.fields(jax_cfg):
        v = getattr(jax_cfg, f.name)
        kw[f.name] = _torch_cfg(v) if dataclasses.is_dataclass(v) else v
    return getattr(tcfg, type(jax_cfg).__name__)(**kw)


@pytest.fixture(scope="module")
def megag():
    from megatts2_tpu import config as jcfg
    from megatts2_tpu.models import MegaG as JMegaG

    mrte = jcfg.MRTEConfig(
        mel_n_layer=2, mel_n_stack=1, mel_n_block=1, content_ff_dim=32, content_n_heads=2,
        content_n_layers=2, hidden_size=16, phone_vocab_size=40, dropout=0.0, use_flash=True,
    )
    vqpe = jcfg.VQPEConfig(hidden_size=16, kernel_size=3, n_layers=1, n_stacks=1, n_blocks=1,
                           vq_bins=32, vq_dim=8)
    jc = jcfg.MegaGConfig(mrte=mrte, vqpe=vqpe, kernel_size=3, hidden_size=16,
                          decoder_n_stack=1, decoder_n_block=1)
    jg = JMegaG(jc)
    v = jax.jit(jg.init)(
        {"params": KEY, "vq": KEY}, jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32),
        jnp.asarray([4]), jnp.zeros((1, 32, 80)), jnp.zeros((1, 16, 80)),
    )
    g_vars = {"params": _perturbed(v["params"], 1), "vq_stats": _perturbed(v["vq_stats"], 2)}
    from megatts2_tpu_torch.models import MegaG

    return jg, g_vars, load_flax_params(MegaG(_torch_cfg(jc)), g_vars)


def test_mrte_tc_latent_flash_matches_jax(megag):
    """JAX runs the Pallas flash kernel in interpret mode (FLASH_ON_CPU)."""
    from jax.experimental.pallas import tpu as pltpu

    from megatts2_tpu.nn import transformer as jtr

    jg, g_vars, g = megag
    rng = np.random.RandomState(3)
    phone = rng.randint(1, 40, (3, 9)).astype(np.int32)
    lens = np.array([9, 5, 7], np.int32)
    mel = rng.randn(3, 45, 80).astype(np.float32)
    jtr.FLASH_ON_CPU = True
    try:
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jg.apply(
                g_vars, jnp.asarray(phone), jnp.asarray(mel), jnp.asarray(lens),
                method=lambda m, p, x, pl: m.mrte.tc_latent(p, x, pl),
            ))
    finally:
        jtr.FLASH_ON_CPU = False
    got = g.mrte.tc_latent(torch.from_numpy(phone).long(), _t(mel), torch.from_numpy(lens))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-4)


def test_codebook_decode_and_decode_latents_match_jax(megag):
    jg, g_vars, g = megag
    rng = np.random.RandomState(4)
    codes = rng.randint(0, 32, (2, 5)).astype(np.int32)
    ref_zq = np.asarray(jg.apply(g_vars, jnp.asarray(codes)[None],
                                 method=lambda m, c: m.vqpe.vq.decode(c)))
    zq = g.vqpe.vq.decode(torch.from_numpy(codes).long()[None])
    np.testing.assert_array_equal(zq.numpy(), ref_zq)

    tc = rng.randn(2, 37, 16).astype(np.float32)
    zq_rep = np.repeat(ref_zq, 8, axis=1)
    ref = np.asarray(jg.apply(g_vars, jnp.asarray(tc), jnp.asarray(zq_rep),
                              method=lambda m, a, b: m.decode_latents(a, b)))
    got = g.decode_latents(_t(tc), _t(zq_rep)).detach().numpy()
    assert got.shape == ref.shape == (2, 37, 80)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_vocos_matches_jax():
    """Tanh GELU, LayerNorm eps 1e-6, fp32 head, last frame repeated:
    (B, T, 80) → (B, T*256)."""
    from megatts2_tpu import config as jcfg
    from megatts2_tpu.models import Vocos as JVocos
    from megatts2_tpu_torch.models import Vocos

    jc = jcfg.VocosConfig(dim=16, intermediate_dim=32, num_layers=2)
    jv = JVocos(jc)
    params = _perturbed(jv.init(KEY, jnp.zeros((1, 4, 80)))["params"], 9)
    mel = np.random.RandomState(10).randn(2, 13, 80).astype(np.float32)
    ref = np.asarray(jv.apply({"params": params}, jnp.asarray(mel)))
    model = load_flax_params(Vocos(_torch_cfg(jc)), params)
    got = model(_t(mel)).detach().numpy()
    assert got.shape == ref.shape == (2, 13 * 256)
    np.testing.assert_allclose(got, ref, atol=1e-4)
