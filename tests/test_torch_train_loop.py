"""The port's schedule, optimizer, dropout and train loop on the CPU.

The schedule is held against JAX ``cosine_schedule_with_warmup`` (rtol
1e-6 and atol 1e-6 lr: JAX computes in fp32, where 1 + cos(pi x) near the
end of the decay cancels) and ``make_adamw``'s steps against
``optax.adamw`` (atol 1e-6, a few fp32 ulps of weights of order 1).  Dropout is
reproducible from its generator's seed; ``run_training`` logs at its
cadence in the JAX loop's JSONL format; training and the KV-cached decode
run on one set of parameters.
"""
import json

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from megatts2_tpu_torch.config import MegaADMConfig, MegaPLMConfig, TrainConfig
from megatts2_tpu_torch.training import (cosine_schedule_with_warmup, create_adm_state,
                                         create_plm_state, make_adamw, make_plm_train_step,
                                         run_training)

LR, WARMUP, TOTAL = 3e-4, 10, 100
PLM = MegaPLMConfig(n_layers=2, n_heads=2, vq_dim=8, tc_latent_dim=8, vq_bins=16, dropout=0.3)
TCFG = TrainConfig(max_steps=100, warmup_steps=1, initial_learning_rate=1e-3, train_dtype="float32")


def _batch(seed=0, B=2, T=10):
    rng = np.random.RandomState(seed)
    p_codes = np.concatenate([np.full((B, 1), PLM.bos_id), rng.randint(0, PLM.vq_bins, (B, T))], 1)
    return {"tc_latents": rng.randn(B, T, PLM.tc_latent_dim).astype(np.float16),
            "p_codes": p_codes.astype(np.int32), "lens": np.full((B,), T, np.int32)}


@pytest.mark.parametrize("step", [0, 1, WARMUP - 1, WARMUP, 55, TOTAL - 1, TOTAL, 150])
def test_schedule_matches_jax(step):
    from megatts2_tpu.training.schedules import cosine_schedule_with_warmup as jax_schedule

    want = float(jax_schedule(LR, WARMUP, TOTAL)(jnp.asarray(step)))
    got = cosine_schedule_with_warmup(LR, WARMUP, TOTAL)(step)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * LR)


def test_adamw_steps_match_optax():
    """Same gradients into both optimizers: the first update reads the
    schedule at 0 (lr 0 in warmup), and weight decay reaches every weight."""
    rng = np.random.RandomState(0)
    w0 = rng.randn(4, 3).astype(np.float32)
    grads = [rng.randn(4, 3).astype(np.float32) for _ in range(5)]
    from megatts2_tpu.training.schedules import make_adamw as jax_adamw

    tx = jax_adamw(LR, 2, 20)
    jw = jnp.asarray(w0)
    opt_state = tx.init(jw)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt, sched = make_adamw([w], LR, 2, 20)
    for i, g in enumerate(grads):
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, jw)
        jw = optax.apply_updates(jw, updates)
        w.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
        if i == 0:
            assert np.array_equal(w.detach().numpy(), w0)  # lr 0 at count 0
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), rtol=0, atol=1e-6)


def _first_loss(gen_seed, train=True):
    st = create_plm_state(PLM, TCFG, device="cpu")
    st.generator.manual_seed(gen_seed)
    step, evaluate = make_plm_train_step(PLM, TCFG)
    out = step(st, _batch()) if train else evaluate(st, _batch())
    return float(out["loss"])


def test_dropout_follows_its_generator():
    assert _first_loss(5) == _first_loss(5)
    assert _first_loss(5) != _first_loss(6)
    assert _first_loss(5, train=False) == _first_loss(6, train=False)
    assert _first_loss(5) != _first_loss(5, train=False)


def test_run_training_logs_at_its_cadence(tmp_path):
    st = create_plm_state(PLM, TCFG, device="cpu")
    step, evaluate = make_plm_train_step(PLM, TCFG)
    batches = [_batch(i) for i in range(3)]
    out = run_training("plm", st, step, lambda epoch: batches, max_steps=7,
                       log_dir=str(tmp_path), log_every=2, val_every=3, eval_step=evaluate,
                       valid_loader_factory=lambda epoch: batches[:2])
    assert out is st and st.step == 7 and st.sched.last_epoch == 7
    rows = [json.loads(line) for line in (tmp_path / "plm_metrics.jsonl").read_text().splitlines()]
    train = [r for r in rows if "train/loss" in r]
    val = [r for r in rows if "val/loss" in r]
    assert [r["step"] for r in train] == [2, 4, 6]
    assert [r["step"] for r in val] == [3, 6]
    assert set(train[0]) == {"step", "time", "train/loss", "train/loss_sum", "train/ac10",
                             "train/steps_per_sec", "train/host_rss_gb"}
    assert set(val[0]) == {"step", "time", "val/loss", "val/loss_sum", "val/ac10"}
    assert all(np.isfinite(r["train/loss"]) and r["train/steps_per_sec"] > 0 for r in train)


def test_run_training_refuses_checkpoints_and_empty_loaders(tmp_path):
    """Checkpoints are no longer refused: a ``ckpt_dir`` gets the final
    save (``tests/test_torch_checkpoints.py`` holds save and resume).  An
    empty loader still raises."""
    st = create_plm_state(PLM, TCFG, device="cpu")
    step, _ = make_plm_train_step(PLM, TCFG)
    run_training("plm", st, step, lambda e: [_batch()], 1, log_dir=str(tmp_path),
                 ckpt_dir=str(tmp_path / "ck"))
    assert sorted(os.listdir(tmp_path / "ck")) == [".save.lock", "scores.json", "step_1.ckpt"]
    with pytest.raises(ValueError, match="no batch"):
        run_training("plm", st, step, lambda e: [], st.step + 1, log_dir=str(tmp_path))


def test_plm_training_and_decode_share_weights():
    """The teacher-forced forward fed the greedy decode's own codes picks
    those codes again: one set of parameters serves both."""
    from megatts2_tpu_torch.models import plm_infer

    st = create_plm_state(PLM, TCFG, device="cpu")
    step, _ = make_plm_train_step(PLM, TCFG)
    for i in range(3):
        step(st, _batch(i))
    tc = torch.from_numpy(np.random.RandomState(9).randn(2, 10, 8).astype(np.float32))
    codes = plm_infer(st.model, tc)
    p_codes = torch.cat([torch.full((2, 1), PLM.bos_id), codes], dim=1)
    with torch.no_grad():
        logits, target = st.model(tc, p_codes, torch.tensor([10, 10]))
    assert torch.equal(logits.argmax(-1), codes) and torch.equal(target, codes)


def test_adm_training_and_decode_share_weights():
    from megatts2_tpu_torch.models.fast_decode import adm_decode_raw

    cfg = MegaADMConfig(n_layers=2, n_heads=2, emb_dim=8, tc_latent_dim=8, tc_emb_dim=8)
    st = create_adm_state(cfg, TCFG, device="cpu")
    tc = torch.from_numpy(np.random.RandomState(10).randn(2, 9, 8).astype(np.float32))
    raw = adm_decode_raw(st.model, tc)
    dur = torch.cat([torch.zeros(2, 1), raw], dim=1)[..., None]
    with torch.no_grad():
        pred, target = st.model(tc, dur, torch.tensor([9, 9]))
    torch.testing.assert_close(pred, raw, rtol=0, atol=1e-5)
