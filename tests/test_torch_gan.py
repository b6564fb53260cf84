"""The port's GAN stage held against the JAX package on the CPU at tiny
widths: ``VQProsodyEncoder``, ``MRTE.forward``, ``MegaG.forward`` (eval and
train) and ``s2_latent``, the discriminator, the full
``make_gan_train_step`` and its eval step, the bridge on scan-stacked
trees, the MRTE's flash path against JAX's Pallas kernel in interpret mode,
and one bf16 step.

JAX's random draws (dropout masks, the codebook's kmeans seeds and expiry
replacements) are recorded by ``record_jax_draws`` (JAX under
``jax.disable_jit()``) and replayed into the port through a ``Draws``; the
window starts replay the step's ``jax.random.split``.  The port must ask
for exactly as many masks as JAX drew.

Tolerances, fp32 unless stated: forward outputs atol 1e-5; codes equal;
the discriminator's outputs and running statistics after three passes
atol 1e-5; the train step's nine metrics rtol 1e-4 at each of 3 steps, and
after step 3 the codebook, the running statistics and the parameters atol
1e-5, except the parameters whose true gradient is 0 (see
``_assert_params``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megatts2_tpu_torch import config as tcfg
from megatts2_tpu_torch.bridge import load_flax_params
from megatts2_tpu_torch.nn import Draws
from tests.test_torch_vq import record_jax_draws
from tests.test_training import TINY_D, TINY_G, gan_batch

KEY = jax.random.PRNGKey(0)
# TINY_G with dropout in the MRTE as well (the conv blocks drop at 0.1 always)
G_CFG = dataclasses.replace(TINY_G, mrte=dataclasses.replace(TINY_G.mrte, dropout=0.1))
LR = 1e-3


def _torch_cfg(jax_cfg):
    kw = {}
    for f in dataclasses.fields(jax_cfg):
        v = getattr(jax_cfg, f.name)
        kw[f.name] = _torch_cfg(v) if dataclasses.is_dataclass(v) else v
    return getattr(tcfg, type(jax_cfg).__name__)(**kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + np.float32(0.1) * np.asarray(rng.randn(*np.shape(x)), np.float32),
        tree)


def _batch():
    b = gan_batch()
    b["mel_target_lens"] = np.array([12, 10], np.int32)  # the 16-frame window scores zero
    return b


def _g_args(b):
    return (b["duration_tokens"], b["phone_tokens"], b["tokens_lens"], b["mel_timbres"],
            b["mel_targets"])


def _t_args(b):
    return tuple(torch.from_numpy(np.asarray(a)) for a in _g_args(b))


def _jax_g_vars(cfg, random_stats: bool):
    """JAX MegaG variables: perturbed parameters; the codebook random
    (eval) or empty, kmeans on the first train batch."""
    from megatts2_tpu.models import MegaG as JMegaG

    b = _batch()
    v = jax.jit(JMegaG(cfg).init)({"params": KEY, "vq": KEY}, *map(jnp.asarray, _g_args(b)))
    stats = _perturbed(v["vq_stats"], 2) if random_stats else _np(v["vq_stats"])
    return {"params": _perturbed(v["params"], 1), "vq_stats": stats}


def _port_g(cfg, g_vars):
    from megatts2_tpu_torch.models import MegaG

    return load_flax_params(MegaG(_torch_cfg(cfg)), g_vars)


def _consumed(draws: Draws, rec: dict) -> None:
    """The port drew exactly what JAX drew, of each kind."""
    for kind, values in rec.items():
        assert draws.calls[kind] == len(values), (kind, draws.calls[kind], len(values))
    assert not any(draws.replay.values())


def _assert_close_tree(module, template, tree, atol, skip=()):
    """``module``'s parameters and buffers against ``tree`` loaded into ``template``."""
    want = load_flax_params(template, tree)
    got = dict(module.named_parameters()) | dict(module.named_buffers())
    for name, w in list(want.named_parameters()) + list(want.named_buffers()):
        if name in got and not any(name.endswith(s) for s in skip):
            np.testing.assert_allclose(got[name].detach().numpy(), w.detach().numpy(), rtol=0,
                                       atol=atol, err_msg=name)


# ------------------------------------------------------------- forwards


@pytest.mark.parametrize("train", [False, True])
def test_vqpe_matches_jax(train, monkeypatch):
    """T = 45, not a multiple of 8: the ceil-mode max-pool, the ×8 repeat
    cut to 45 frames, codes, both losses, and in train mode the kmeans
    init and EMA update of the codebook."""
    from megatts2_tpu.models import VQProsodyEncoder as JVQPE
    from megatts2_tpu_torch.models import VQProsodyEncoder

    cfg = G_CFG.vqpe
    mel = np.random.RandomState(5).randn(2, 45, 80).astype(np.float32)
    jm = JVQPE(cfg)
    v = jm.init({"params": KEY, "vq": KEY}, jnp.asarray(mel))
    vs = {"params": _perturbed(v["params"], 3),
          "vq_stats": _np(v["vq_stats"]) if train else _perturbed(v["vq_stats"], 4)}
    m = load_flax_params(VQProsodyEncoder(_torch_cfg(cfg)), vs)
    with record_jax_draws(monkeypatch) as rec:
        out, mut = jm.apply(vs, jnp.asarray(mel), train=train,
                            rngs={"dropout": KEY, "vq": KEY}, mutable=["vq_stats"])
    draws = Draws(replay=rec)
    got = m(torch.from_numpy(mel), train=train, draws=draws)
    if train:
        _consumed(draws, rec)
    assert len(rec["masks"]) == (2 * cfg.n_layers * cfg.n_stacks * cfg.n_blocks if train else 0)
    zq, commit, vq_loss, codes = got
    assert zq.shape == (2, 45, cfg.vq_dim)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(out[3]))
    for a, b in ((zq, out[0]), (commit, out[1]), (vq_loss, out[2])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-5)
    _assert_close_tree(m.vq, type(m.vq)(cfg.vq_dim, 1, cfg.vq_bins),
                       _np(mut["vq_stats"]["vq"]), 1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_mrte_forward_matches_jax(train, monkeypatch):
    """tc_latent, then length regulation to 64 frames; in train mode with
    dropout in the embeddings, conv blocks and both attentions."""
    g_vars = _jax_g_vars(G_CFG, random_stats=True)
    g = _port_g(G_CFG, g_vars)
    from megatts2_tpu.models import MRTE as JMRTE

    b = _batch()
    jm = JMRTE(G_CFG.mrte)
    params = {"params": g_vars["params"]["mrte"]}
    with record_jax_draws(monkeypatch) as rec:
        ref = jm.apply(params, b["duration_tokens"], b["phone_tokens"], b["tokens_lens"],
                       b["mel_timbres"], 64, deterministic=not train, rngs={"dropout": KEY})
    draws = Draws(replay=rec)
    a = _t_args(b)
    got = g.mrte(a[0].long(), a[1].long(), a[2], a[3], 64, train=train, draws=draws)
    if train:
        _consumed(draws, rec)
        assert len(rec["masks"]) > 0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_megag_forward_matches_jax(train, monkeypatch):
    """(mel_hat, commit, vq_loss) in eval and train mode (masks and codebook
    samples injected), and the codebook after the train forward."""
    from megatts2_tpu.models import MegaG as JMegaG

    g_vars = _jax_g_vars(G_CFG, random_stats=not train)
    g = _port_g(G_CFG, g_vars)
    b = _batch()
    with record_jax_draws(monkeypatch) as rec:
        (ref, jc, jv), mut = JMegaG(G_CFG).apply(
            g_vars, *_g_args(b), train=train, rngs={"dropout": KEY, "vq": KEY},
            mutable=["vq_stats"])
    draws = Draws(replay=rec)
    a = _t_args(b)
    mel_hat, commit, vq_loss = g(a[0].long(), a[1].long(), *a[2:], train=train,
                                 draws=draws)
    if train:
        _consumed(draws, rec)
    assert mel_hat.shape == (2, 64, 80)
    np.testing.assert_allclose(mel_hat.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(commit.item(), float(jc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(vq_loss.item(), float(jv), rtol=0, atol=1e-5)
    from megatts2_tpu_torch.models import MegaG

    _assert_close_tree(g, MegaG(_torch_cfg(G_CFG)),
                       {"params": g_vars["params"], "vq_stats": _np(mut["vq_stats"])}, 1e-5)


def test_s2_latent_matches_jax():
    from megatts2_tpu.models import MegaG as JMegaG

    g_vars = _jax_g_vars(G_CFG, random_stats=True)
    g = _port_g(G_CFG, g_vars)
    b = _batch()
    lens = np.array([6, 4], np.int32)
    tc, codes = JMegaG(G_CFG).apply(g_vars, b["phone_tokens"], lens, b["mel_timbres"],
                                    b["mel_targets"], method=lambda m, *x: m.s2_latent(*x))
    a = _t_args(b)
    got_tc, got_codes = g.s2_latent(a[1].long(), torch.from_numpy(lens), a[3], a[4])
    np.testing.assert_array_equal(got_codes.numpy(), np.asarray(codes))
    np.testing.assert_allclose(got_tc.detach().numpy(), np.asarray(tc), rtol=0, atol=1e-5)


def _jax_d_vars(cfg):
    from megatts2_tpu.models import Discriminator as JD

    v = jax.jit(JD(cfg).init)(KEY, jnp.zeros((2, 64, 80)))
    return {"params": _perturbed(v["params"], 7), "batch_stats": _np(v["batch_stats"])}


def test_discriminator_matches_jax(monkeypatch):
    """Three train passes chaining the running statistics, windows 8 and 16
    at given starts with a longest true length of 12 (the 16-frame window
    scores zero), then an eval pass on the running statistics."""
    from megatts2_tpu.models import Discriminator as JD
    from megatts2_tpu_torch.models import Discriminator

    d_vars = _jax_d_vars(TINY_D)
    d = load_flax_params(Discriminator(_torch_cfg(TINY_D)), d_vars)
    rng = np.random.RandomState(8)
    bstats = d_vars["batch_stats"]
    for i, starts in enumerate(([3, 0], [0, 48], [56, 7])):
        mel = rng.randn(2, 64, 80).astype(np.float32)
        with record_jax_draws(monkeypatch) as rec:
            out, mut = JD(TINY_D).apply({"params": d_vars["params"], "batch_stats": bstats},
                                        jnp.asarray(mel), starts=starts, train=True,
                                        max_true_len=jnp.int32(12),
                                        rngs={"dropout": jax.random.fold_in(KEY, i)},
                                        mutable=["batch_stats"])
        bstats = _np(mut["batch_stats"])
        draws = Draws(replay=rec)
        got = d(torch.from_numpy(mel), starts, train=True, max_true_len=12, draws=draws)
        _consumed(draws, rec)
        assert len(rec["masks"]) == 3 * len(TINY_D.time_lengths)
        np.testing.assert_allclose(got["y"].detach().numpy(), np.asarray(out["y"]), rtol=0, atol=1e-5)
        for h, jh in zip(got["h"], out["h"]):
            np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    _assert_close_tree(d, Discriminator(_torch_cfg(TINY_D)),
                       {"params": d_vars["params"], "batch_stats": bstats}, 1e-5)
    ref = JD(TINY_D).apply({"params": d_vars["params"], "batch_stats": bstats},
                           jnp.asarray(mel), starts=[5, 9])
    got = d(torch.from_numpy(mel), [5, 9])
    np.testing.assert_allclose(got["y"].detach().numpy(), np.asarray(ref["y"]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("scan_stacks", [False, True])
def test_bridge_loads_generator_and_discriminator(scan_stacks):
    """Full G trees (the VQPE, the codebook) and D trees (params and
    running statistics), the conv stacks scan-stacked (``n_stacks`` on a
    leading axis, as ``configs/config_gan.yaml`` ships) or not: the port
    gives JAX's outputs."""
    from megatts2_tpu.models import Discriminator as JD
    from megatts2_tpu.models import MegaG as JMegaG
    from megatts2_tpu_torch.models import Discriminator

    cfg = dataclasses.replace(G_CFG, scan_stacks=scan_stacks,
                              vqpe=dataclasses.replace(G_CFG.vqpe, n_stacks=2),
                              decoder_n_stack=3)
    g_vars = _jax_g_vars(cfg, random_stats=True)
    stacked = g_vars["params"]["decoder"]["conv_stack"]
    assert ("conv_stacks" in stacked) == scan_stacks
    b = _batch()
    ref = JMegaG(cfg).apply(g_vars, *_g_args(b))
    got = _port_g(cfg, g_vars)(*(x.long() if i < 2 else x for i, x in enumerate(_t_args(b))))
    for r, x in zip(ref, got):  # three conv stacks deep: fp32 sums to 1e-5 relative
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(r), rtol=1e-5, atol=5e-5)
    d_vars = _jax_d_vars(TINY_D)
    d_vars["batch_stats"] = _perturbed(d_vars["batch_stats"], 9)
    d_vars["batch_stats"] = jax.tree_util.tree_map(np.abs, d_vars["batch_stats"])
    mel = b["mel_targets"]
    ref = JD(TINY_D).apply(d_vars, jnp.asarray(mel), starts=[1, 2])
    got = load_flax_params(Discriminator(_torch_cfg(TINY_D)), d_vars)(torch.from_numpy(mel), [1, 2])
    np.testing.assert_allclose(got["y"].detach().numpy(), np.asarray(ref["y"]), rtol=0, atol=1e-5)
    with pytest.raises(KeyError, match="unconsumed flax collections"):
        load_flax_params(Discriminator(_torch_cfg(TINY_D)), {**d_vars, "cache": {}})


# ------------------------------------------------------------- train step


def _jax_starts(rng, batch, d_cfg):
    """The window starts a JAX train step draws from its state's key."""
    _, _, _, win_rng, _, _, _ = jax.random.split(rng, 7)
    T = batch["mel_targets"].shape[1]
    max_len = min(int(np.max(batch["mel_target_lens"])), T) if "mel_target_lens" in batch else T
    rngs = jax.random.split(win_rng, len(d_cfg.time_lengths))
    return [int(jax.random.randint(r, (), 0, max(max_len - wl, 0) + 1))
            for r, wl in zip(rngs, d_cfg.time_lengths)]


def _jax_gan_run(g_cfg, d_cfg, jtc, batch, n_steps, monkeypatch, perturb=False):
    """(initial state, final state, metrics per step, draws) of the JAX step;
    with ``perturb`` from perturbed G and D parameters (non-zero biases)."""
    from megatts2_tpu.training import create_gan_state, make_gan_train_step

    state, g_tx, d_tx = create_gan_state(KEY, g_cfg, d_cfg, jtc, batch)
    if perturb:
        state = state.replace(g_params=_perturbed(state.g_params, 1),
                              d_params=_perturbed(state.d_params, 3))
    init = state
    step = make_gan_train_step(g_cfg, d_cfg, jtc, g_tx, d_tx)
    metrics, draws = [], {"masks": [], "indices": [], "starts": []}
    for _ in range(n_steps):
        draws["starts"] += _jax_starts(state.rng, batch, d_cfg)
        with record_jax_draws(monkeypatch) as rec:
            state, m = step(state, batch)
        draws["masks"] += rec["masks"]
        draws["indices"] += rec["indices"]
        metrics.append({k: float(v) for k, v in m.items()})
    return init, state, metrics, draws


def _port_gan_state(g_cfg, d_cfg, ttc, init):
    from megatts2_tpu_torch.training import create_gan_state

    st = create_gan_state(_torch_cfg(g_cfg), _torch_cfg(d_cfg), ttc, device="cpu")
    load_flax_params(st.g, {"params": _np(init.g_params), "vq_stats": _np(init.vq_stats)})
    load_flax_params(st.d, {"params": _np(init.d_params), "batch_stats": _np(init.batch_stats)})
    assert st.g_ema is None  # taken by the first step from the loaded weights
    return st


# parameters whose true gradient is 0, so that both sides hold rounding
# residue of ~1e-9 that Adam's normalisation turns into steps of up to ~lr
# in either direction: the key projection's bias (softmax is invariant to a
# shift of a row's logits) and a conv bias that a train-mode BatchNorm
# removes again (it subtracts the batch mean)
ZERO_GRAD = ("w_k.bias", "conv.0.bias", "conv.1.bias")


def _assert_params(module, template, tree, lr_steps):
    _assert_close_tree(module, template, tree, 1e-5, skip=ZERO_GRAD)
    want = dict(load_flax_params(template, tree).named_parameters())
    for name, p in module.named_parameters():
        if name.endswith(ZERO_GRAD):
            np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(), rtol=0,
                                       atol=2.1 * LR * lr_steps, err_msg=name)


@pytest.mark.parametrize("ema", [0.0, 0.5])
def test_gan_train_step_matches_jax(ema, monkeypatch):
    """Three steps of ``make_gan_train_step``: the D step on the detached ŷ
    (real, then fake), the G step against the updated D, the codebook's
    kmeans init and EMA, the optional EMA generator; then the eval step,
    which evaluates ``g_ema`` when it exists."""
    from megatts2_tpu.config import TrainConfig
    from megatts2_tpu.training import make_gan_eval_step as jeval
    from megatts2_tpu_torch.models import Discriminator, MegaG
    from megatts2_tpu_torch.training import make_gan_eval_step, make_gan_train_step

    batch = _batch()
    jtc = TrainConfig(max_steps=100, warmup_steps=1, initial_learning_rate=LR,
                      train_dtype="float32", g_ema_decay=ema)
    init, final, jm, draws = _jax_gan_run(G_CFG, TINY_D, jtc, batch, 3, monkeypatch)
    ttc = _torch_cfg(jtc)
    st = _port_gan_state(G_CFG, TINY_D, ttc, init)
    st.draws = Draws(replay=draws)
    step = make_gan_train_step(_torch_cfg(G_CFG), _torch_cfg(TINY_D), ttc)
    for i in range(3):
        m = step(st, batch)
        assert set(m) == set(jm[i])
        for k, v in jm[i].items():
            np.testing.assert_allclose(float(m[k]), v, rtol=1e-4, atol=1e-7, err_msg=f"{k} step {i}")
    _consumed(st.draws, draws)
    assert st.step == 3
    g_tree = {"params": _np(final.g_params), "vq_stats": _np(final.vq_stats)}
    _assert_params(st.g, MegaG(_torch_cfg(G_CFG)), g_tree, 2)
    _assert_close_tree(st.g, MegaG(_torch_cfg(G_CFG)), g_tree, 1e-5,
                       skip=tuple(n for n, _ in st.g.named_parameters()))
    d_tree = {"params": _np(final.d_params), "batch_stats": _np(final.batch_stats)}
    _assert_params(st.d, Discriminator(_torch_cfg(TINY_D)), d_tree, 2)
    if ema:
        want = load_flax_params(MegaG(_torch_cfg(G_CFG)), {"params": _np(final.g_ema),
                                                           "vq_stats": g_tree["vq_stats"]})
        for name, w in want.named_parameters():
            tol = 2.1 * LR * 2 if name.endswith(ZERO_GRAD) else 1e-5
            np.testing.assert_allclose(st.g_ema[name].numpy(), w.detach().numpy(), rtol=0,
                                       atol=tol, err_msg=name)
    else:
        assert st.g_ema is None and final.g_ema is None
    ref = jax.jit(jeval(G_CFG))(final, batch)["loss_re"]
    got = make_gan_eval_step(_torch_cfg(G_CFG))(st, batch)
    assert got["y_hat"].shape == (2, 64, 80)
    np.testing.assert_allclose(float(got["loss_re"]), float(ref), rtol=1e-5)
    if ema:  # the EMA weights, not the raw ones, are evaluated
        raw = make_gan_eval_step(_torch_cfg(G_CFG))(dataclasses.replace(st, g_ema=None), batch)
        assert float(raw["loss_re"]) != float(got["loss_re"])


def test_gan_train_loop_drives_the_step(tmp_path):
    """``run_training`` drives the port's step and eval step unchanged: the
    eval's ŷ (not a scalar) stays out of the log."""
    import json

    from megatts2_tpu_torch.training import (create_gan_state, make_gan_eval_step,
                                             make_gan_train_step, run_training)

    g_cfg, d_cfg = _torch_cfg(G_CFG), _torch_cfg(TINY_D)
    ttc = tcfg.TrainConfig(max_steps=100, warmup_steps=1, train_dtype="float32")
    st = create_gan_state(g_cfg, d_cfg, ttc, device="cpu")
    batch = _batch()
    run_training("gan", st, make_gan_train_step(g_cfg, d_cfg, ttc), lambda e: [batch],
                 max_steps=3, log_dir=str(tmp_path), log_every=1, val_every=3,
                 eval_step=make_gan_eval_step(g_cfg), valid_loader_factory=lambda e: [batch])
    rows = [json.loads(line) for line in open(tmp_path / "gan_metrics.jsonl")]
    train = [r for r in rows if "train/G_loss_total" in r]
    val = [r for r in rows if "val/loss_re" in r]
    assert len(train) == 3 and len(val) == 1 and "val/y_hat" not in val[0]
    assert all(np.isfinite(r["train/D_loss_total"]) for r in train)
    assert train[-1]["train/vq_code_usage"] > 0 and st.step == 3


def test_gan_state_needs_a_card_unless_asked_for_the_cpu():
    from megatts2_tpu_torch.training import create_gan_state

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_gan_state(_torch_cfg(G_CFG), _torch_cfg(TINY_D), tcfg.TrainConfig())


# ------------------------------------------------------------- flash, bf16


def test_megag_train_flash_matches_jax_pallas(monkeypatch):
    """The MRTE at head dim 64 with ``use_flash=True``: JAX's Pallas kernel
    (interpret mode) and its ``_fa_bwd`` against the port's plain versions
    of kernels B and C, through a train-mode forward and its gradient."""
    from jax.experimental.pallas import tpu as pltpu

    from megatts2_tpu.models import MegaG as JMegaG
    from megatts2_tpu.nn import transformer as jtr
    from megatts2_tpu_torch.models import MegaG

    cfg = dataclasses.replace(G_CFG, mrte=dataclasses.replace(
        G_CFG.mrte, hidden_size=128, content_n_heads=2, use_flash=True))
    g_vars = _jax_g_vars(cfg, random_stats=False)
    b = _batch()
    w = np.random.RandomState(9).randn(2, 64, 80).astype(np.float32)

    def loss(params):
        (mel, commit, vq), _ = JMegaG(cfg).apply(
            {"params": params, "vq_stats": g_vars["vq_stats"]}, *_g_args(b), train=True,
            rngs={"dropout": KEY, "vq": KEY}, mutable=["vq_stats"])
        return jnp.sum(mel * w) + commit + vq

    jtr.FLASH_ON_CPU = True
    try:
        with pltpu.force_tpu_interpret_mode(), record_jax_draws(monkeypatch) as rec:
            jl, jgrads = jax.value_and_grad(loss)(g_vars["params"])
    finally:
        jtr.FLASH_ON_CPU = False
    g = _port_g(cfg, g_vars)
    assert g.mrte.phone_encoder.use_flash
    a = _t_args(b)
    mel, commit, vq = g(a[0].long(), a[1].long(), *a[2:], train=True, draws=Draws(replay=rec))
    total = (mel * torch.from_numpy(w)).sum() + commit + vq
    total.backward()
    np.testing.assert_allclose(float(total), float(jl), rtol=1e-5)
    want = load_flax_params(MegaG(_torch_cfg(cfg)), {"params": _np(jgrads),
                                                     "vq_stats": g_vars["vq_stats"]})
    # fp32 sums in another order through 128-wide layers: up to 1.6e-5 of
    # the largest gradient (346) on the CPU, held to 5e-5 of it
    top = max(p.abs().max().item() for p in want.parameters())
    for (name, p), q in zip(g.named_parameters(), want.parameters()):
        np.testing.assert_allclose(p.grad.numpy(), q.detach().numpy(), rtol=0, atol=5e-5 * top,
                                   err_msg=name)


def test_gan_step_bf16_close_to_jax(monkeypatch):
    """One step with ``train_dtype="bfloat16"``: JAX's flax ``dtype=`` casts
    against the port's written-out ones (Dense and conv products rounded to
    bf16 before their bias is added, LayerNorm and BatchNorm statistics
    fp32, Python scalars rounded to bf16 as JAX rounds them, the codebook
    and the losses fp32), from perturbed weights, so that no bias is zero
    and no bias add exact.  The casts sit where JAX's do, so ŷ is bit-equal
    on the CPU (held to 1e-3 of its largest magnitude, a quarter of one
    bf16 ulp there) and the metrics agree to 4e-7 relative (held to 1e-5:
    fp32 sums in another order).  The control, the same step at fp32 on
    the same draws, must miss both limits: it misses JAX's bf16 rounding,
    8e-3 of ŷ's largest magnitude and up to 4e-3 of a metric."""
    from megatts2_tpu.config import TrainConfig
    from megatts2_tpu.models import MegaG as JMegaG
    from megatts2_tpu_torch.training import make_gan_train_step

    batch = _batch()
    jtc = TrainConfig(max_steps=100, warmup_steps=1, initial_learning_rate=LR,
                      train_dtype="bfloat16")
    init, _, jm, draws = _jax_gan_run(G_CFG, TINY_D, jtc, batch, 1, monkeypatch, perturb=True)
    gaps = {}
    for dtype in ("bfloat16", "float32"):
        ttc = dataclasses.replace(_torch_cfg(jtc), train_dtype=dtype)
        st = _port_gan_state(G_CFG, TINY_D, ttc, init)
        st.draws = Draws(replay=draws)
        m = make_gan_train_step(_torch_cfg(G_CFG), _torch_cfg(TINY_D), ttc)(st, batch)
        _consumed(st.draws, draws)
        gaps[dtype] = {k: abs(float(m[k]) - v) / max(abs(v), 1e-6) for k, v in jm[0].items()}
    assert max(gaps["bfloat16"].values()) <= 1e-5, gaps["bfloat16"]
    assert max(gaps["float32"].values()) > 1e-4, gaps["float32"]

    g_vars = {"params": _np(init.g_params), "vq_stats": _np(init.vq_stats)}
    with record_jax_draws(monkeypatch) as rec:
        (ref, _, _), _ = JMegaG(G_CFG, dtype=jnp.bfloat16).apply(
            g_vars, *_g_args(batch), train=True, rngs={"dropout": KEY, "vq": KEY},
            mutable=["vq_stats"])
    ref = np.asarray(ref, np.float32)
    a = _t_args(batch)
    y_gap = {}
    for dtype in (torch.bfloat16, torch.float32):
        got, _, _ = _port_g(G_CFG, g_vars)(a[0].long(), a[1].long(), *a[2:], train=True,
                                           draws=Draws(replay=rec), dtype=dtype)
        assert got.dtype == dtype
        y_gap[dtype] = np.abs(got.float().detach().numpy() - ref).max() / np.abs(ref).max()
    assert y_gap[torch.bfloat16] <= 1e-3, y_gap
    assert y_gap[torch.float32] > 4e-3, y_gap
