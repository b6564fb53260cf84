"""The ADM's train step with ``use_flash`` at head dim 96 (emb_dim 64 +
tc_emb_dim 128 over 2 heads: the shipped ADM's head dim at a small width),
the port against ``megatts2_tpu``'s ``training/lm_trainers.py`` on the CPU,
fp32, dropout 0, 3 AdamW steps from the JAX initial parameters.  JAX takes
its Pallas flash attention and ``_fa_bwd`` under ``FLASH_ON_CPU`` in
interpret mode; the port the plain versions of kernels B and C, on the
route the card runs with kernels.

Tolerances: the first step's metrics rtol 1e-4 and its gradients 1e-5 of
each tree's largest gradient; parameters after the 3 steps atol 1e-5,
except the key-projection bias, held to 2.1 lr per update as in
``test_torch_train.py`` (its true gradient is 0: Adam turns each side's
rounding residue into steps of up to lr).
"""
import numpy as np
import torch

import jax

from megatts2_tpu_torch.bridge import load_flax_params
from megatts2_tpu_torch.training import create_adm_state, make_adm_train_step
from pipeline_fixtures import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from test_torch_train import (LR, N_UPDATES, TCFG, _adm_batch, _assert_grads, _jax_run,
                              _torch_cfg, _torch_state)


def _adm_flash_cfg():
    from megatts2_tpu.config import MegaADMConfig

    return MegaADMConfig(n_layers=2, n_heads=2, emb_dim=64, tc_latent_dim=8, tc_emb_dim=128,
                         dropout=0.0, use_flash=True)


def test_adm_use_flash_head_dim_96_matches_jax():
    from megatts2_tpu.training import create_adm_state as jcreate
    from megatts2_tpu.training import make_adm_train_step as jmake
    from megatts2_tpu_torch.models import MegaADM

    cfg = _adm_flash_cfg()
    assert cfg.d_model // cfg.n_heads == 96
    batch = _adm_batch()
    params0, grads, jm, jparams = _jax_run(jcreate, jmake, cfg, batch, N_UPDATES, flash=True)
    st = _torch_state(create_adm_state, cfg, params0)
    assert st.model.adm.use_flash
    step, _ = make_adm_train_step(_torch_cfg(cfg), TCFG)
    for i in range(N_UPDATES):
        m = {k: float(v) for k, v in step(st, batch).items()}
        if i == 0:
            for k in ("loss", "loss_sum"):
                np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, err_msg=k)
            _assert_grads(st.model, grads, MegaADM(_torch_cfg(cfg)))
    want = dict(load_flax_params(MegaADM(_torch_cfg(cfg)), jax.tree_util.tree_map(np.asarray, jparams))
                .named_parameters())
    for name, p in st.model.named_parameters():
        a, b = p.detach().numpy(), want[name].detach().numpy()
        if name.endswith("attn.qkv.bias"):  # key bias: true gradient 0
            kb = slice(cfg.d_model, 2 * cfg.d_model)
            np.testing.assert_allclose(a[kb], b[kb], rtol=0, atol=2.1 * LR * (N_UPDATES - 1),
                                       err_msg=name)
            a, b = np.delete(a, np.s_[kb]), np.delete(b, np.s_[kb])
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=name)
    assert torch.isfinite(torch.tensor(m["loss"]))
