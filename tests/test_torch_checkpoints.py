"""The port's checkpoints (``training/convert.py``, ``training/checkpoints.py``,
``bridge.export_flax_params``) against the JAX package, on the CPU.

* The port's copy of ``convert_*`` gives the JAX module's trees on
  reference state dicts fabricated as ``tests/test_convert.py`` makes them.
* port module → reference state dict → port module is exact.
* JAX's ``load_torch_state_dict`` + ``convert_*`` read a checkpoint file the
  port wrote, and JAX's modules then compute the port's outputs (fp32,
  atol 1e-5: the same weights, sums in another order).
* Retention (top-k by metric + the latest, ``scores.json``), the writers'
  exclusive and the readers' shared lock, and concurrent writers, as
  ``tests/test_checkpoints_topk.py`` holds them for JAX.
* ``run_training`` resumed from ``ckpt_dir`` equals an uninterrupted run.
"""
import dataclasses
import fcntl
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megatts2_tpu_torch import config as tcfg
from megatts2_tpu_torch import models as tm
from megatts2_tpu_torch.training import checkpoints as tck
from megatts2_tpu_torch.training import convert as tconv

sys.path.insert(0, str(Path(__file__).parent))
import test_convert as jfab  # noqa: E402  (the JAX tests' state-dict fabricators)

ROOT = str(Path(__file__).parent.parent)
PLM_CFG = tcfg.MegaPLMConfig(n_layers=2, n_heads=2, vq_dim=8, tc_latent_dim=8, vq_bins=16,
                             dropout=0.1)
ADM_CFG = tcfg.MegaADMConfig(n_layers=2, n_heads=2, emb_dim=8, tc_latent_dim=12, tc_emb_dim=8)
D_CFG = tcfg.DiscriminatorConfig(time_lengths=(16, 32), freq_length=20, hidden_size=4)
HIFI_CFG = tcfg.HiFiGANConfig(in_channels=8, upsample_initial_channel=8, upsample_rates=(4, 4),
                              upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3,),
                              resblock_dilation_sizes=((1, 2),))


def _torch_cfg(jax_cfg):
    kw = {}
    for f in dataclasses.fields(jax_cfg):
        v = getattr(jax_cfg, f.name)
        kw[f.name] = _torch_cfg(v) if dataclasses.is_dataclass(v) else v
    return getattr(tcfg, type(jax_cfg).__name__)(**kw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_same_tree(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _disc_sd(cfg, seed=4):
    rng = np.random.RandomState(seed)
    sd = {}
    fp = (cfg.freq_length + 7) // 8
    for i, wl in enumerate(cfg.time_lengths):
        base = f"discriminator.discriminators.{i}"
        for j in range(3):
            cin = cfg.c_in if j == 0 else cfg.hidden_size
            sd[f"{base}.model.{j}.0.weight"] = rng.randn(cfg.hidden_size, cin, 3, 3).astype(np.float32)
            sd[f"{base}.model.{j}.0.bias"] = rng.randn(cfg.hidden_size).astype(np.float32)
            if j < 2:
                for k in ("weight", "bias", "running_mean", "running_var"):
                    sd[f"{base}.model.{j}.3.{k}"] = rng.rand(cfg.hidden_size).astype(np.float32)
        sd[f"{base}.adv_layer.weight"] = rng.randn(1, cfg.hidden_size * (wl // 8) * fp).astype(np.float32)
        sd[f"{base}.adv_layer.bias"] = rng.randn(1).astype(np.float32)
    return sd


def _lm_sd(kind):
    rng = np.random.RandomState(1)
    sd = {}
    if kind == "plm":
        c = jfab.MegaPLMConfig(n_layers=2, n_heads=2, vq_dim=8, tc_latent_dim=8, vq_bins=16)
        jfab._torch_encoder(rng, sd, "plm", c.n_layers, c.d_model, c.d_model * 4, False)
        sd["predict_layer.weight"] = jfab._rng_tensor(rng, c.vq_bins, c.d_model)
        sd["pc_embedding.weight"] = jfab._rng_tensor(rng, c.vq_bins + 2, c.vq_dim)
    else:
        c = jfab.MegaADMConfig(n_layers=2, n_heads=2, emb_dim=8, tc_latent_dim=12, tc_emb_dim=8)
        jfab._torch_encoder(rng, sd, "adm", c.n_layers, c.d_model, c.emb_dim * 4, False)
        sd["dt_linear_emb.weight"] = jfab._rng_tensor(rng, c.emb_dim, 1)
        sd["tc_linear_emb.weight"] = jfab._rng_tensor(rng, c.tc_emb_dim, c.tc_latent_dim)
        sd["predict_layer.weight"] = jfab._rng_tensor(rng, 1, c.d_model)
    return sd, c


def _hifi_sd():
    rng = np.random.RandomState(3)
    c = HIFI_CFG
    sd = {}

    def wn(name, cin, cout, k):
        sd[f"{name}.weight_v"] = rng.randn(cout, cin, k).astype(np.float32)
        sd[f"{name}.weight_g"] = np.abs(rng.randn(cout, 1, 1)).astype(np.float32) + 0.5
        sd[f"{name}.bias"] = rng.randn(cout).astype(np.float32)

    wn("conv_pre", c.in_channels, c.upsample_initial_channel, 7)
    ch = c.upsample_initial_channel
    for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
        sd[f"ups.{i}.weight_v"] = rng.randn(ch, ch // 2, k).astype(np.float32)
        sd[f"ups.{i}.weight_g"] = np.abs(rng.randn(ch, 1, 1)).astype(np.float32) + 0.5
        sd[f"ups.{i}.bias"] = rng.randn(ch // 2).astype(np.float32)
        ch //= 2
        for j, (kr, ds) in enumerate(zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes)):
            for n in range(len(ds)):
                wn(f"resblocks.{i * len(c.resblock_kernel_sizes) + j}.convs1.{n}", ch, ch, kr)
                wn(f"resblocks.{i * len(c.resblock_kernel_sizes) + j}.convs2.{n}", ch, ch, kr)
    wn("conv_post", ch, 1, 7)
    return sd


@pytest.mark.parametrize("kind", ["megag", "megag_scan", "plm", "adm", "discriminator", "hifigan"])
def test_copied_convert_equals_jax(kind):
    from megatts2_tpu.training import convert as jconv

    if kind.startswith("megag"):
        cfg = dataclasses.replace(jfab.TINY_G, scan_stacks=kind == "megag_scan")
        sd = jfab.make_megag_state_dict(cfg)
        got, want = tconv.convert_megag(sd, cfg), jconv.convert_megag(sd, cfg)
    elif kind in ("plm", "adm"):
        sd, cfg = _lm_sd(kind)
        fn = f"convert_{kind}"
        got, want = getattr(tconv, fn)(sd, cfg), getattr(jconv, fn)(sd, cfg)
    elif kind == "discriminator":
        sd = _disc_sd(D_CFG)
        got, want = tconv.convert_discriminator(sd, D_CFG), jconv.convert_discriminator(sd, D_CFG)
    else:
        sd = _hifi_sd()
        got, want = tconv.convert_hifigan(sd, HIFI_CFG), jconv.convert_hifigan(sd, HIFI_CFG)
    _assert_same_tree(got, want)


def _random(module, seed=0):
    tm.init_random_(module, torch.Generator().manual_seed(seed))
    with torch.no_grad():  # non-default LayerNorm, BatchNorm and codebook values too
        g = torch.Generator().manual_seed(seed + 1)
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            if t.is_floating_point() and not name.endswith(".pe") and name != "pe":
                t.add_(0.1 * torch.randn(t.shape, generator=g))
    return module


def _modules(seed=0):
    g_cfg = _torch_cfg(jfab.TINY_G)
    return {
        "megag": (lambda: tm.MegaG(g_cfg)),
        "megag_scan": (lambda: tm.MegaG(dataclasses.replace(g_cfg, scan_stacks=True))),
        "plm": (lambda: tm.MegaPLM(PLM_CFG)),
        "adm": (lambda: tm.MegaADM(ADM_CFG)),
        "discriminator": (lambda: tm.Discriminator(D_CFG)),
        "hifigan": (lambda: tm.HiFiGAN(HIFI_CFG)),
        "vocos": (lambda: tm.Vocos(tcfg.VocosConfig(dim=8, intermediate_dim=16, num_layers=2))),
        "wave_d": (lambda: tm.WaveDiscriminator(tcfg.WaveDiscConfig(periods=(2, 3), msd_scales=2,
                                                                    mpd_base_ch=2, msd_base_ch=4,
                                                                    max_ch=8))),
    }


@pytest.mark.parametrize("kind", list(_modules()))
def test_port_to_reference_to_port_is_exact(kind):
    make = _modules()[kind]
    src = _random(make())
    sd = tck.model_state_dict(src)
    assert all(v.dtype == torch.float32 for v in sd.values())
    dst = tck.load_model_state_dict(make(), sd)
    a, b = src.state_dict(), dst.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_reference_keys_are_the_reference_layout():
    """The port's MegaG writes exactly the keys a reference checkpoint holds
    (the fabricator's), under ``G.``."""
    sd = tck.model_state_dict(_random(tm.MegaG(_torch_cfg(jfab.TINY_G))))
    want = jfab.make_megag_state_dict(jfab.TINY_G)
    assert sorted(sd) == sorted(f"G.{k}" for k in want)
    for k, v in want.items():
        assert tuple(sd[f"G.{k}"].shape) == np.shape(v), k


def _write(tmp_path, *modules):
    sd = {}
    for m in modules:
        sd.update(tck.model_state_dict(m))
    path = str(tmp_path / "port.ckpt")
    torch.save({"state_dict": sd, "global_step": 0}, path)
    return path


def test_jax_reads_the_port_checkpoint_and_computes_the_same(tmp_path):
    from megatts2_tpu.models import MegaADM, MegaG, MegaPLM
    from megatts2_tpu.models.hifigan import HiFiGAN
    from megatts2_tpu.training import convert as jconv

    g_jcfg = jfab.TINY_G
    g = _random(tm.MegaG(_torch_cfg(g_jcfg))).eval()
    plm = _random(tm.MegaPLM(dataclasses.replace(PLM_CFG, dropout=0.0, use_flash=False))).eval()
    adm = _random(tm.MegaADM(ADM_CFG)).eval()
    hifi = _random(tm.HiFiGAN(HIFI_CFG)).eval()
    path = _write(tmp_path, g, plm, adm, hifi)
    rng = np.random.RandomState(5)

    # MegaG: tc_latent and decode_latents
    jg = jconv.convert_megag(jconv.load_torch_state_dict(path, prefix="G."), g_jcfg)
    phone = rng.randint(1, 11, (2, 6))
    lens = np.array([6, 4])
    mel = rng.randn(2, 16, 8).astype(np.float32)
    JG = MegaG(g_jcfg)
    want = np.asarray(JG.apply(jg, jnp.asarray(phone), jnp.asarray(mel), jnp.asarray(lens),
                               method=lambda m, p, x, ln: m.mrte.tc_latent(p, x, ln)))
    with torch.no_grad():
        got = g.mrte.tc_latent(torch.from_numpy(phone), torch.from_numpy(mel), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    x = rng.randn(2, 16, 8).astype(np.float32)
    z = rng.randn(2, 16, 4).astype(np.float32)
    want = np.asarray(JG.apply(jg, jnp.asarray(x), jnp.asarray(z),
                               method=lambda m, a, b: m.decode_latents(a, b)))
    with torch.no_grad():
        got = g.decode_latents(torch.from_numpy(x), torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    # PLM and ADM teacher-forced forwards
    jcfg = jfab.MegaPLMConfig(n_layers=2, n_heads=2, vq_dim=8, tc_latent_dim=8, vq_bins=16,
                              dropout=0.0, use_flash=False)
    jp = jconv.convert_plm(jconv.load_torch_state_dict(path, prefix="plm."), jcfg)
    tc = rng.randn(2, 5, 8).astype(np.float32)
    codes = np.concatenate([np.full((2, 1), 16), rng.randint(0, 16, (2, 5))], 1)
    plens = np.array([5, 3])
    want = np.asarray(MegaPLM(jcfg).apply({"params": jp}, jnp.asarray(tc), jnp.asarray(codes),
                                          jnp.asarray(plens))[0])
    with torch.no_grad():
        got = plm(torch.from_numpy(tc), torch.from_numpy(codes), torch.from_numpy(plens))[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    acfg = jfab.MegaADMConfig(n_layers=2, n_heads=2, emb_dim=8, tc_latent_dim=12, tc_emb_dim=8)
    ja = jconv.convert_adm(jconv.load_torch_state_dict(path, prefix="adm."), acfg)
    tc = rng.randn(2, 5, 12).astype(np.float32)
    dur = np.concatenate([np.zeros((2, 1, 1)), rng.randint(1, 9, (2, 5, 1))], 1).astype(np.float32)
    want = np.asarray(MegaADM(acfg).apply({"params": ja}, jnp.asarray(tc), jnp.asarray(dur),
                                          jnp.asarray(plens))[0])
    with torch.no_grad():
        got = adm(torch.from_numpy(tc), torch.from_numpy(dur), torch.from_numpy(plens))[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    # HiFi-GAN, read without a prefix as JAX's hifigan_from_pretrained does
    jcfg = jfab.HiFiGANConfig(**{f.name: getattr(HIFI_CFG, f.name)
                                 for f in dataclasses.fields(HIFI_CFG)})
    jh = jconv.convert_hifigan(jconv.load_torch_state_dict(path), jcfg)
    mel = rng.randn(1, 6, 8).astype(np.float32)
    want = np.asarray(HiFiGAN(jcfg).apply({"params": jh}, jnp.asarray(mel)))
    with torch.no_grad():
        got = hifi(torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy().reshape(want.shape), want, atol=1e-5)


# ------------------------------------------------------------ retention


def _state(seed=0):
    from megatts2_tpu_torch.training import create_plm_state

    return create_plm_state(PLM_CFG, tcfg.TrainConfig(seed=seed, warmup_steps=1), device="cpu")


def _kept(d):
    return sorted(n for n in os.listdir(d) if n.startswith("step_"))


def test_keeps_best_plus_last(tmp_path):
    d = str(tmp_path / "ck")
    st = _state()
    for step, m in {10: 1.0, 20: 0.5, 30: 0.2, 40: 0.9, 50: 1.5, 60: 2.0}.items():
        st.step = step
        tck.save_checkpoint(d, st, step, keep=2, metric=m)
    assert _kept(d) == ["step_20.ckpt", "step_30.ckpt", "step_60.ckpt"]
    assert tck.latest_checkpoint(d).endswith("step_60.ckpt")
    assert tck.best_checkpoint(d).endswith("step_30.ckpt")
    assert tck.read_checkpoint(tck.best_checkpoint(d))["global_step"] == 30


def test_unscored_saves_are_kept_only_while_latest(tmp_path):
    d = str(tmp_path / "ck")
    st = _state()
    tck.save_checkpoint(d, st, 5, keep=1, metric=0.3)
    tck.save_checkpoint(d, st, 9, keep=1, metric=None)
    assert _kept(d) == ["step_5.ckpt", "step_9.ckpt"]
    tck.save_checkpoint(d, st, 12, keep=1, metric=None)
    assert _kept(d) == ["step_12.ckpt", "step_5.ckpt"]
    assert tck.best_checkpoint(d).endswith("step_5.ckpt")


def test_retention_survives_resume(tmp_path):
    d = str(tmp_path / "ck")
    st = _state()
    tck.save_checkpoint(d, st, 1, keep=2, metric=0.1)
    tck.save_checkpoint(d, st, 2, keep=2, metric=0.9)
    tck.save_checkpoint(d, st, 3, keep=2, metric=0.8)
    assert _kept(d) == ["step_1.ckpt", "step_3.ckpt"]


def test_restore_fills_a_fresh_state(tmp_path):
    d = str(tmp_path / "ck")
    src = _state(seed=0)
    src.step = 7
    tck.save_checkpoint(d, src, 7)
    dst = tck.restore_checkpoint(d, _state(seed=1))
    assert dst.step == 7
    for (n, a), b in zip(src.model.named_parameters(), dst.model.parameters()):
        assert torch.equal(a, b), n
    assert torch.equal(src.generator.get_state(), dst.generator.get_state())
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(str(tmp_path / "none"), _state())


def test_readers_wait_for_a_writer(tmp_path):
    """A reader takes the shared lock: it waits while a writer holds the
    exclusive one."""
    d = str(tmp_path / "ck")
    path = tck.save_checkpoint(d, _state(), 1)
    done = threading.Event()
    with open(os.path.join(d, tck.LOCK), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        t = threading.Thread(target=lambda: (tck.read_checkpoint(path), done.set()))
        t.start()
        time.sleep(0.3)
        assert not done.is_set()
        fcntl.flock(f, fcntl.LOCK_UN)
    t.join(timeout=30)
    assert done.is_set()


def test_two_processes_saving_one_dir_serialize(tmp_path):
    d = str(tmp_path / "ck")
    prog = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from megatts2_tpu_torch import config as c\n"
        "from megatts2_tpu_torch.training import create_plm_state, save_checkpoint\n"
        "w = int(sys.argv[2])\n"
        "st = create_plm_state(c.MegaPLMConfig(n_layers=1, n_heads=2, vq_dim=8, tc_latent_dim=8,"
        " vq_bins=16), c.TrainConfig(seed=w), device='cpu')\n"
        "for step in (1, 2):\n"
        "    st.step = step\n"
        "    save_checkpoint(sys.argv[1], st, step, keep=2, metric=float(w))\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", prog, d, str(w)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for w in (1, 2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]
    for step in (1, 2):
        ck = tck.read_checkpoint(os.path.join(d, f"step_{step}.ckpt"))
        assert ck["global_step"] == step
    assert not [n for n in os.listdir(d) if "tmp" in n]


# ------------------------------------------------------------ resume


def test_resumed_training_equals_an_uninterrupted_run(tmp_path):
    """4 steps at dropout 0.1, validating every 2: once straight through,
    once cut after 2 steps and resumed in a fresh state (another seed) from
    the checkpoint directory.  Parameters, optimizer moments, the dropout
    generator and the step are equal."""
    from megatts2_tpu_torch.training import make_plm_train_step, run_training

    t = tcfg.TrainConfig(max_steps=4, warmup_steps=1, initial_learning_rate=1e-3)
    rng = np.random.RandomState(0)
    batch = {"tc_latents": rng.randn(2, 6, 8).astype(np.float16),
             "p_codes": np.concatenate([np.full((2, 1), 16), rng.randint(0, 16, (2, 6))], 1),
             "lens": np.array([6, 4], np.int32)}
    step, evaluate = make_plm_train_step(PLM_CFG, t)

    def run(state, max_steps, ckpt_dir, log):
        return run_training("plm", state, step, lambda e: [batch], max_steps, log_dir=str(log),
                            ckpt_dir=ckpt_dir, log_every=1, val_every=2, eval_step=evaluate,
                            valid_loader_factory=lambda e: [batch])

    straight = run(_state(0), 4, None, tmp_path / "a")
    ck = str(tmp_path / "ck")
    run(_state(0), 2, ck, tmp_path / "b")
    assert _kept(ck) == ["step_2.ckpt"]
    resumed = run(_state(1), 4, ck, tmp_path / "c")
    assert resumed.step == straight.step == 4
    assert _kept(ck) == ["step_2.ckpt", "step_4.ckpt"]
    for (n, a), b in zip(straight.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(a, b), n
    sa, sb = straight.opt.state_dict()["state"], resumed.opt.state_dict()["state"]
    for k in sa:
        assert torch.equal(sa[k]["exp_avg_sq"], sb[k]["exp_avg_sq"])
    assert torch.equal(straight.generator.get_state(), resumed.generator.get_state())
