"""The port's PLM and ADM train steps held against ``megatts2_tpu``'s
``training/lm_trainers.py`` on the CPU, fp32 on both sides, dropout 0, at
tiny widths.  JAX reaches the Pallas flash attention (and its
``custom_vjp`` backward) with ``FLASH_ON_CPU`` in interpret mode; the port
takes the plain versions of kernels B and C.  Both start from the JAX
initial parameters, carried across with the weight bridge, which also
carries the JAX gradient tree (``w_q``/``w_k``/``w_v`` merged into ``qkv``)
for comparison with ``.grad``.

Tolerances: metrics rtol 1e-5; gradients atol 1e-5 of each tree's largest
gradient; parameters after 3 AdamW steps atol 1e-6 (the first update has
lr 0 under warmup 1, the next two move each weight by ~lr = 1e-3 with an
update normalised by Adam, so a relative gradient error of 1e-5 moves it
by ~1e-8).  The one exception is the key-projection bias: softmax is
invariant to a shift of a row's logits, so its true gradient is 0 and both
sides hold rounding residue of ~1e-9, which Adam's normalisation turns into
steps of up to ~1.004 lr in either direction in the first three updates.
It is held to 2.1 lr per update.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from megatts2_tpu_torch import config as tcfg
from megatts2_tpu_torch.bridge import load_flax_params
from megatts2_tpu_torch.training import (create_adm_state, create_plm_state, make_adm_train_step,
                                         make_plm_train_step)

KEY = jax.random.PRNGKey(0)
LR = 1e-3
N_UPDATES = 3
TCFG = tcfg.TrainConfig(max_steps=100, warmup_steps=1, initial_learning_rate=LR,
                        train_dtype="float32")


def _torch_cfg(jax_cfg):
    return getattr(tcfg, type(jax_cfg).__name__)(
        **{f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)}
    )


def _grab_grads():
    """An optax transformation that leaves the parameters and keeps the
    gradients as its state, so a JAX train step hands them back."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, u), u),
    )


def _jax_run(create, make_step, cfg, batch, n, flash=True, **kw):
    """(initial params, grads, metrics of the first step, params after n AdamW steps)."""
    from jax.experimental.pallas import tpu as pltpu

    from megatts2_tpu.config import TrainConfig
    from megatts2_tpu.nn import transformer as tr

    jtc = TrainConfig(max_steps=100, warmup_steps=1, initial_learning_rate=LR,
                      train_dtype="float32")
    state, tx = create(KEY, cfg, jtc, batch)
    params0 = jax.tree_util.tree_map(np.asarray, state.params)
    tr.FLASH_ON_CPU = flash
    try:
        with pltpu.force_tpu_interpret_mode():
            grab = make_step(cfg, jtc, _grab_grads(), **kw)[0]
            grabbed, m = grab(state.replace(opt=_grab_grads().init(state.params)), batch)
            grads = jax.tree_util.tree_map(np.asarray, grabbed.opt)
            step = jax.jit(make_step(cfg, jtc, tx, **kw)[0])
            for _ in range(n):
                state, _ = step(state, batch)
    finally:
        tr.FLASH_ON_CPU = False
    return params0, grads, {k: float(v) for k, v in m.items()}, state.params


def _torch_state(create, cfg, params0):
    st = create(_torch_cfg(cfg), TCFG, device="cpu")
    load_flax_params(st.model, params0)
    return st


def _assert_grads(model, grads, template):
    want = load_flax_params(template, grads)
    scale = max(p.abs().max().item() for p in want.parameters())
    for (name, p), w in zip(model.named_parameters(), want.parameters()):
        np.testing.assert_allclose(p.grad.numpy(), w.detach().numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def _assert_params(model, jax_params, template, d_model):
    want = dict(load_flax_params(template, jax.tree_util.tree_map(np.asarray, jax_params))
                .named_parameters())
    for name, p in model.named_parameters():
        a, b = p.detach().numpy(), want[name].detach().numpy()
        if name.endswith("attn.qkv.bias"):  # key bias: true gradient 0, see module docstring
            kb = slice(d_model, 2 * d_model)
            np.testing.assert_allclose(a[kb], b[kb], rtol=0, atol=2.1 * LR * (N_UPDATES - 1),
                                       err_msg=name)
            a, b = np.delete(a, np.s_[kb]), np.delete(b, np.s_[kb])
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------- PLM


def _plm_cfg():
    from megatts2_tpu.config import MegaPLMConfig

    return MegaPLMConfig(n_layers=2, n_heads=2, vq_dim=8, tc_latent_dim=8, vq_bins=16, dropout=0.0)


def _plm_batch(cfg, lens=(12, 7, 0), seed=1):
    """PLMBatchBuilder's layout: BOS, codes, eos padding; fp16 latents."""
    rng = np.random.RandomState(seed)
    B, T = len(lens), 12
    p_codes = np.full((B, T + 1), cfg.eos_id, np.int32)
    tc = np.zeros((B, T, cfg.tc_latent_dim), np.float16)
    for i, n in enumerate(lens):
        p_codes[i, 0] = cfg.bos_id
        p_codes[i, 1 : 1 + n] = rng.randint(0, cfg.vq_bins, n)
        tc[i, :n] = rng.randn(n, cfg.tc_latent_dim)
    return {"tc_latents": tc, "p_codes": p_codes, "lens": np.asarray(lens, np.int32)}


def test_plm_step_metrics_and_grads_match_jax():
    from megatts2_tpu.training import create_plm_state as jcreate
    from megatts2_tpu.training import make_plm_train_step as jmake
    from megatts2_tpu_torch.models import MegaPLM

    cfg = _plm_cfg()
    assert cfg.use_flash
    batch = _plm_batch(cfg)
    params0, grads, jm, _ = _jax_run(jcreate, jmake, cfg, batch, 0)
    st = _torch_state(create_plm_state, cfg, params0)
    step, evaluate = make_plm_train_step(_torch_cfg(cfg), TCFG)
    ev = {k: float(v) for k, v in evaluate(st, batch).items()}
    tm = {k: float(v) for k, v in step(st, batch).items()}
    for k in ("loss", "loss_sum", "ac10"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(ev[k], jm[k], rtol=1e-5, err_msg=k)
    _assert_grads(st.model, grads, MegaPLM(_torch_cfg(cfg)))


def test_plm_params_after_adamw_steps_match_jax():
    from megatts2_tpu.training import create_plm_state as jcreate
    from megatts2_tpu.training import make_plm_train_step as jmake
    from megatts2_tpu_torch.models import MegaPLM

    cfg = _plm_cfg()
    batch = _plm_batch(cfg, lens=(12, 9, 4), seed=2)
    params0, _, _, jparams = _jax_run(jcreate, jmake, cfg, batch, N_UPDATES)
    st = _torch_state(create_plm_state, cfg, params0)
    step, _ = make_plm_train_step(_torch_cfg(cfg), TCFG)
    for _ in range(N_UPDATES):
        step(st, batch)
    assert st.step == N_UPDATES
    _assert_params(st.model, jparams, MegaPLM(_torch_cfg(cfg)), cfg.d_model)


def test_plm_eos_only_batch_has_zero_loss():
    cfg = _torch_cfg(_plm_cfg())
    st = create_plm_state(cfg, TCFG, device="cpu")
    batch = {"tc_latents": np.zeros((2, 6, 8), np.float16),
             "p_codes": np.full((2, 7), cfg.eos_id, np.int32), "lens": np.zeros((2,), np.int32)}
    step, evaluate = make_plm_train_step(cfg, TCFG)
    assert float(evaluate(st, batch)["loss"]) == 0.0
    m = step(st, batch)
    assert float(m["loss"]) == 0.0 and float(m["loss_sum"]) == 0.0 and float(m["ac10"]) == 0.0


# ---------------------------------------------------------------- ADM


def _adm_cfg():
    from megatts2_tpu.config import MegaADMConfig

    return MegaADMConfig(n_layers=2, n_heads=2, emb_dim=8, tc_latent_dim=8, tc_emb_dim=8,
                         dropout=0.0)


def _adm_batch(seed=3, lens=(7, 4, 1)):
    """ADMBatchBuilder's layout: leading 0, durations, zero padding; fp16 latents."""
    rng = np.random.RandomState(seed)
    B, T = len(lens), 8
    dur = np.zeros((B, T + 1, 1), np.float32)
    tc = np.zeros((B, T, 8), np.float16)
    for i, n in enumerate(lens):
        dur[i, 1 : 1 + n, 0] = rng.randint(1, 9, n)
        tc[i, :n] = rng.randn(n, 8)
    return {"duration_tokens": dur, "tc_latents": tc, "lens": np.asarray(lens, np.int32)}


@pytest.mark.parametrize("mask_padding", [False, True])
def test_adm_step_metrics_grads_and_params_match_jax(mask_padding):
    from megatts2_tpu.training import create_adm_state as jcreate
    from megatts2_tpu.training import make_adm_train_step as jmake
    from megatts2_tpu_torch.models import MegaADM

    cfg = _adm_cfg()
    batch = _adm_batch()
    params0, grads, jm, jparams = _jax_run(jcreate, jmake, cfg, batch, N_UPDATES, flash=False,
                                           mask_padding=mask_padding)
    st = _torch_state(create_adm_state, cfg, params0)
    step, evaluate = make_adm_train_step(_torch_cfg(cfg), TCFG, mask_padding=mask_padding)
    ev = {k: float(v) for k, v in evaluate(st, batch).items()}
    for i in range(N_UPDATES):
        m = {k: float(v) for k, v in step(st, batch).items()}
        if i == 0:
            for k in ("loss", "loss_sum"):
                np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, err_msg=k)
                np.testing.assert_allclose(ev[k], jm[k], rtol=1e-5, err_msg=k)
            _assert_grads(st.model, grads, MegaADM(_torch_cfg(cfg)))
    _assert_params(st.model, jparams, MegaADM(_torch_cfg(cfg)), cfg.d_model)


def test_adm_padding_counts_unless_masked():
    """The reference's quirk: padded positions enter the summed MSE."""
    cfg = _torch_cfg(_adm_cfg())
    st = create_adm_state(cfg, TCFG, device="cpu")
    batch = _adm_batch(lens=(8, 2, 1))
    full = float(make_adm_train_step(cfg, TCFG)[1](st, batch)["loss_sum"])
    masked = float(make_adm_train_step(cfg, TCFG, mask_padding=True)[1](st, batch)["loss_sum"])
    assert full > masked > 0.0
