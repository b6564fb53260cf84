"""The port's vocoder-training stage held against the JAX package on the
CPU at tiny widths: ``WaveDiscriminator`` (logits and every feature, on a
length every period divides and one it does not), Vocos and HiFi-GAN at a
compute dtype over fp32 masters, the bridge on wave-discriminator trees,
``make_vocoder_train_step`` for both generator families, its eval step, and
one bf16 step.

Weights are JAX's initial trees perturbed by 0.1·N(0, 1) (so that Vocos'
layer scales and the zero biases take part), loaded into the port through
``bridge.load_flax_params``.  The plain mel (``mel_spectrogram_plain`` and
its autograd) stands in for kernel A on the CPU.

Tolerances: fp32 forwards atol 1e-5 of outputs of order 1 (sums in other
orders); the fp32 train step's six metrics rtol 1e-4 at each of 3 steps and
the parameters after step 3 atol 1e-5 (Adam normalises each update to
about lr = 1e-3, so a gradient's rounding moves a parameter by far less).
bf16 is held against flax with every bf16 op's result rounded (eager, or
jitted with XLA's excess precision off: by default a jitted fusion keeps
fp32 and defines no rounding to match), with an fp32 control of the port
that must miss each bound (``test_generator_bf16_rounds_as_flax``,
``test_vocoder_step_bf16_close_to_jax``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megatts2_tpu_torch import config as tcfg
from megatts2_tpu_torch.bridge import load_flax_params

KEY = jax.random.PRNGKey(0)
SEG = 8  # segment_frames: 2048 samples a row


def _jcfg():
    from megatts2_tpu import config as jcfg

    return jcfg


def tiny_configs():
    c = _jcfg()
    d = c.WaveDiscConfig(periods=(2, 3), msd_scales=2, mpd_base_ch=4, msd_base_ch=8, max_ch=16)
    vocos = c.VocosConfig(dim=16, intermediate_dim=48, num_layers=2)
    # space_to_depth_ch 0: JAX's TPU layout of the resblocks (exact, and at
    # 1-8 channels blocks of 16-128 samples that take minutes to compile) off
    hifi = c.HiFiGANConfig(upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
                           resblock_dilation_sizes=((1, 3), (1, 2)), space_to_depth_ch=0)
    return d, {"vocos": vocos, "hifigan": hifi}


def _torch_cfg(jax_cfg):
    return getattr(tcfg, type(jax_cfg).__name__)(**dataclasses.asdict(jax_cfg))


def _perturbed(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + np.float32(0.1) * np.asarray(rng.randn(*np.shape(x)), np.float32),
        tree)


def _wav(B=2, n=SEG * 256, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    wav = 0.3 * np.sin(2 * np.pi * 220 * t)[None] * np.ones((B, 1))
    return (wav + 0.01 * rng.standard_normal(wav.shape)).astype(np.float32)


def _jax_disc(d_cfg, n, seed=1):
    from megatts2_tpu.models.wave_dscrm import WaveDiscriminator as JD

    wav = jnp.asarray(_wav(n=n))
    return _perturbed(jax.jit(JD(d_cfg).init)(KEY, wav)["params"], seed)


def _jax_gen(family, cfg, seed=2):
    from megatts2_tpu.training.vocoder_trainer import vocode_init

    return _perturbed(vocode_init(cfg, KEY, jnp.zeros((2, SEG, 80), jnp.float32)), seed)


def _nchw(f):
    """A JAX feature (channels last) in the port's layout (channels first)."""
    f = np.asarray(f, np.float32)
    return np.moveaxis(f, -1, 1)


# ------------------------------------------------------------- modules


@pytest.mark.parametrize("n", [2048, 2049])
def test_wave_discriminator_matches_jax(n):
    """2049: every period pads (reflect); the pooled scales have odd lengths."""
    from megatts2_tpu.models.wave_dscrm import WaveDiscriminator as JD
    from megatts2_tpu_torch.models import WaveDiscriminator

    d_cfg, _ = tiny_configs()
    params = _jax_disc(d_cfg, n)
    wav = _wav(n=n, seed=3)
    j_logits, j_feats = JD(d_cfg).apply({"params": params}, jnp.asarray(wav))
    d = load_flax_params(WaveDiscriminator(_torch_cfg(d_cfg)), params)
    logits, feats = d(torch.from_numpy(wav))
    assert len(logits) == len(j_logits) == 4 and [len(f) for f in feats] == [6, 6, 8, 8]
    for a, b in zip(logits, j_logits):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-5)
    for fs, jfs in zip(feats, j_feats):
        for a, b in zip(fs, jfs):
            assert a.shape == _nchw(b).shape
            np.testing.assert_allclose(a.detach().numpy(), _nchw(b), rtol=0, atol=1e-5)


def test_bridge_refuses_a_wave_discriminator_tree_it_cannot_place():
    from megatts2_tpu_torch.models import WaveDiscriminator

    d_cfg, _ = tiny_configs()
    params = _jax_disc(d_cfg, 2048)
    bad = dict(params)
    bad["mpd_7"] = bad.pop("mpd_3")  # a period the module does not have
    with pytest.raises(KeyError):
        load_flax_params(WaveDiscriminator(_torch_cfg(d_cfg)), bad)
    k = params["mpd_2"]["convs_0"]["kernel"]
    assert k.shape == (5, 1, 1, 4)
    d = load_flax_params(WaveDiscriminator(_torch_cfg(d_cfg)), params)
    np.testing.assert_array_equal(d.mpd_2.convs[0].weight.detach().numpy(), k.transpose(3, 2, 0, 1))
    g = params["msd_0"]["convs_1"]["kernel"]  # (41, 8 / 4, 8): grouped 4 ways
    assert g.shape == (41, 2, 8) and d.msd_0.convs[1].groups == 4
    np.testing.assert_array_equal(d.msd_0.convs[1].weight.detach().numpy(), g.transpose(2, 1, 0))


def _generator_outputs(family, jax_dtype, torch_dtypes):
    from megatts2_tpu.models.megatts import vocode as jvocode
    from megatts2_tpu_torch.models import HiFiGAN, Vocos, vocode

    _, gens = tiny_configs()
    cfg = gens[family]
    params = _jax_gen(family, cfg)
    mel = np.random.RandomState(4).randn(2, SEG, 80).astype(np.float32)
    want = np.asarray(jvocode(params, cfg, jnp.asarray(mel), jax_dtype).astype(jnp.float32))
    g = load_flax_params((Vocos if family == "vocos" else HiFiGAN)(_torch_cfg(cfg)), params)
    got = [vocode(g, torch.from_numpy(mel), dt).detach().numpy() for dt in torch_dtypes]
    assert all(x.shape == want.shape == (2, SEG * 256) for x in got)
    return want, got


@pytest.mark.parametrize("family", ["vocos", "hifigan"])
def test_generator_over_fp32_masters_matches_jax(family):
    """The generator at fp32, as the fp32 train step runs it, against
    flax's ``dtype=float32`` module: atol 1e-5."""
    want, (got,) = _generator_outputs(family, jnp.float32, [torch.float32])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("family", ["vocos", "hifigan"])
def test_generator_bf16_rounds_as_flax(family):
    """bf16 compute over fp32 masters against flax's ``dtype=bfloat16``
    module run eagerly, each op rounded: within 1e-5 of the
    output's largest magnitude (seen 3.6e-7 for Vocos, 0 for HiFi-GAN);
    the port's fp32 forward, the control, misses by more than 1e-3 (seen
    7.8e-3, 2.2e-2).  Vocos needs GELU op by op (``nn.layers.gelu_tanh``):
    PyTorch's one-kernel GELU is 2.4e-3 away."""
    want, (bf16, fp32) = _generator_outputs(family, jnp.bfloat16, [torch.bfloat16, torch.float32])
    top = np.abs(want).max()
    assert np.abs(bf16 - want).max() <= 1e-5 * top
    assert np.abs(fp32 - want).max() > 1e-3 * top


# ------------------------------------------------------------- the step


def _jax_run(family, train_dtype, steps, g_params, d_params, wav):
    from megatts2_tpu.training.vocoder_trainer import (create_vocoder_state, make_vocoder_eval_step,
                                                       make_vocoder_train_step)

    d_cfg, gens = tiny_configs()
    cfg = gens[family]
    t = _jcfg().VocoderTrainConfig(initial_learning_rate=1e-3, segment_frames=SEG,
                                   train_dtype=train_dtype, lr_decay_steps=2, lr_decay=0.5)
    state, g_tx, d_tx = create_vocoder_state(KEY, cfg, d_cfg, t, {"wav": wav})
    state = state.replace(g_params=jax.tree_util.tree_map(jnp.asarray, g_params),
                          d_params=jax.tree_util.tree_map(jnp.asarray, d_params),
                          g_opt=g_tx.init(g_params), d_opt=d_tx.init(d_params))
    batch = {"wav": jnp.asarray(wav)}
    # without excess precision XLA rounds every bf16 op's result, as JAX's
    # semantics (and an eager run) do; with it, a fusion keeps fp32
    step = jax.jit(make_vocoder_train_step(cfg, d_cfg, t, g_tx, d_tx)).lower(state, batch).compile(
        compiler_options={"xla_allow_excess_precision": False})
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    ev = make_vocoder_eval_step(cfg, t)(state, batch)
    return metrics, state, float(ev["loss"])


def _port_state(family, train_dtype, g_params, d_params):
    from megatts2_tpu_torch.training import create_vocoder_state

    d_cfg, gens = tiny_configs()
    t = tcfg.VocoderTrainConfig(initial_learning_rate=1e-3, segment_frames=SEG,
                                train_dtype=train_dtype, lr_decay_steps=2, lr_decay=0.5)
    state = create_vocoder_state(_torch_cfg(gens[family]), _torch_cfg(d_cfg), t, device="cpu")
    load_flax_params(state.g, g_params)
    load_flax_params(state.d, d_params)
    return state, t


def _port_run(family, train_dtype, steps, g_params, d_params, wav):
    from megatts2_tpu_torch.training import make_vocoder_eval_step, make_vocoder_train_step

    d_cfg, gens = tiny_configs()
    state, t = _port_state(family, train_dtype, g_params, d_params)
    step = make_vocoder_train_step(_torch_cfg(gens[family]), _torch_cfg(d_cfg), t)
    metrics = [{k: float(v) for k, v in step(state, {"wav": wav}).items()} for _ in range(steps)]
    ev = make_vocoder_eval_step(_torch_cfg(gens[family]), t)(state, {"wav": wav})
    assert ev["y_hat"].shape == wav.shape and state.step == steps
    return metrics, state, float(ev["loss"])


def _inputs(family):
    d_cfg, gens = tiny_configs()
    return _jax_gen(family, gens[family]), _jax_disc(d_cfg, SEG * 256), _wav(seed=5)


def _assert_params(module, tree, atol):
    template = load_flax_params(type(module)(module.cfg), jax.tree_util.tree_map(np.asarray, tree))
    got = dict(module.named_parameters())
    for name, w in template.named_parameters():
        np.testing.assert_allclose(got[name].detach().numpy(), w.detach().numpy(), rtol=0,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("family", ["vocos", "hifigan"])
def test_vocoder_train_step_matches_jax(family):
    """3 fp32 steps from the same weights and batch, the learning rate
    decaying (lr_decay 0.5 over 2 steps): the six metrics each step, then
    both networks' parameters and the eval step's mel loss."""
    g_params, d_params, wav = _inputs(family)
    jm, jstate, jev = _jax_run(family, "float32", 3, g_params, d_params, wav)
    pm, pstate, pev = _port_run(family, "float32", 3, g_params, d_params, wav)
    for a, b in zip(pm, jm):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    _assert_params(pstate.g, jstate.g_params, 1e-5)
    _assert_params(pstate.d, jstate.d_params, 1e-5)
    np.testing.assert_allclose(pev, jev, rtol=1e-4)


def test_vocoder_schedule_and_optimizer_are_optax():
    """exponential_decay is continuous, read at the updates taken (rtol
    1e-5: optax computes it in fp32); AdamW has optax's weight decay 1e-4
    and eps 1e-8."""
    import optax

    from megatts2_tpu_torch.training import exponential_decay

    ours = exponential_decay(2e-4, 1000, 0.999)
    theirs = optax.exponential_decay(2e-4, transition_steps=1000, decay_rate=0.999)
    for s in (0, 1, 999, 1000, 1500, 400_000):
        np.testing.assert_allclose(ours(s), float(theirs(s)), rtol=1e-5)
    state, _ = _port_state("vocos", "float32", *_inputs("vocos")[:2])
    group = state.g_opt.param_groups[0]
    assert group["weight_decay"] == 1e-4 and group["eps"] == 1e-8 and group["betas"] == (0.8, 0.99)


def test_vocoder_step_bf16_close_to_jax():
    """One bf16 step (compute in bf16 over fp32 masters) against JAX's
    ``train_dtype="bfloat16"`` step, each bf16 op rounded, from the same
    perturbed weights.  The metrics the bf16 forwards decide (D_loss_total:
    G and D at the initial weights; G_loss_mel and loss: G) within 2e-6
    relative (seen 2.5e-7 and 8e-8); the port's fp32 step, the control, misses that (seen 7.7e-6
    and 5.3e-4).  G_loss_adv and G_loss_fm read D after its AdamW update,
    whose first step moves each weight by ±lr by the sign of its gradient;
    D's bf16 gradients differ from JAX's on the CPU, which sums a bias's
    bf16 cotangent in bf16 (1.8% of the exact sum on one grouped conv,
    where PyTorch's fp32 sum is off by its final rounding, 0.25%), so a few
    small gradients change sign: those two are held within 5e-3 (seen
    1.2e-3)."""
    family = "vocos"
    g_params, d_params, wav = _inputs(family)
    jm, _, _ = _jax_run(family, "bfloat16", 1, g_params, d_params, wav)
    forward = ("D_loss_total", "G_loss_mel", "loss")

    def errs(train_dtype):
        m, _, _ = _port_run(family, train_dtype, 1, g_params, d_params, wav)
        return {k: abs(m[0][k] - jm[0][k]) / abs(jm[0][k]) for k in jm[0]}

    bf16, fp32 = errs("bfloat16"), errs("float32")
    assert all(bf16[k] <= 2e-6 for k in forward), bf16
    assert all(fp32[k] > 2e-6 for k in forward), fp32
    assert bf16["G_loss_adv"] <= 5e-3 and bf16["G_loss_fm"] <= 5e-3, bf16
