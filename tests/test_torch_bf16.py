"""The port's bf16 synthesis path and bf16 train steps held against the
JAX package on the CPU, at tiny widths.

JAX rounds every bf16 op here: each function is jitted with XLA's excess
precision off (by default a jitted fusion keeps fp32 and defines no
rounding to match).  The port computes bf16 over weights cast to bf16, as
``Megatts`` casts them and as JAX's ``Megatts(cast_params=True)`` does, and
rounds each Dense's and conv's product before adding its bias, as flax's
``dtype=`` does (``nn/layers.product_then_bias``).

Tolerances, each beside an fp32 control of the port that must miss it:

* synthesis: the MRTE's ``tc_latent``, the ADM decode's raw durations
  (before the +0.5 round), the PLM decode's logits at each step fed the
  same codes, and ``decode_latents`` are bit-equal (tolerance 0).  The
  fp32 port misses each (by about 0.2, 0.9, 0.08 and 0.04 here), and so
  does JAX's own default jit (0.12, 1.1, 0.06, 0.06): excess precision
  moves a bf16 result by as much as a different rounding does.
* one teacher-forced train step from the same weights: the PLM's metrics
  rtol 1e-6 and gradients 1e-2 of the largest gradient (the fp32 control
  misses by 1.6e-4 and 7.8e-2); the ADM's metrics rtol 1e-6 and gradients
  5e-3 (control 1.6e-3 and 9.5e-3).  The gradients are not bit-equal:
  JAX sums some bf16 cotangents in bf16 on the CPU, PyTorch in fp32.
"""
import contextlib
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megatts2_tpu_torch import config as tcfg
from megatts2_tpu_torch.bridge import load_flax_params

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_train import (KEY, LR, _adm_batch, _adm_cfg, _grab_grads,  # noqa: E402
                              _plm_batch, _plm_cfg)

NOEX = {"xla_allow_excess_precision": False}
B, TP = 4, 24


def _perturbed(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + np.float32(0.1) * np.asarray(rng.randn(*np.shape(x)), np.float32),
        tree)


def _torch_cfg(jax_cfg):
    kw = {}
    for f in dataclasses.fields(jax_cfg):
        v = getattr(jax_cfg, f.name)
        kw[f.name] = _torch_cfg(v) if dataclasses.is_dataclass(v) else v
    return getattr(tcfg, type(jax_cfg).__name__)(**kw)


def _rounded(f, *args):
    """f(*args) jitted with every bf16 op's result rounded."""
    return jax.jit(f).lower(*args).compile(compiler_options=NOEX)(*args)


def _default(f, *args):
    return jax.jit(f)(*args)


@contextlib.contextmanager
def _jax_flash():
    from jax.experimental.pallas import tpu as pltpu

    from megatts2_tpu.nn import transformer as jtr

    jtr.FLASH_ON_CPU = True
    try:
        with pltpu.force_tpu_interpret_mode():
            yield
    finally:
        jtr.FLASH_ON_CPU = False


@pytest.fixture(scope="module")
def models():
    from megatts2_tpu import config as jcfg
    from megatts2_tpu.models import MegaADM, MegaG, MegaPLM

    g_cfg = jcfg.MegaGConfig(
        mrte=jcfg.MRTEConfig(mel_n_layer=2, mel_n_stack=1, mel_n_block=1, content_ff_dim=32,
                             content_n_heads=2, content_n_layers=2, hidden_size=16,
                             phone_vocab_size=40, dropout=0.0, use_flash=True),
        vqpe=jcfg.VQPEConfig(hidden_size=16, kernel_size=3, n_layers=1, n_stacks=1, n_blocks=1,
                             vq_bins=32, vq_dim=8),
        kernel_size=3, hidden_size=16, decoder_n_stack=1, decoder_n_block=1)
    plm_cfg = jcfg.MegaPLMConfig(n_layers=2, n_heads=2, vq_dim=8, tc_latent_dim=16, vq_bins=32,
                                 dropout=0.0)
    adm_cfg = jcfg.MegaADMConfig(n_layers=2, n_heads=2, emb_dim=8, tc_latent_dim=16,
                                 tc_emb_dim=8, dropout=0.0)
    gv = jax.jit(MegaG(g_cfg).init)(
        {"params": KEY, "vq": KEY}, jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32),
        jnp.asarray([4]), jnp.zeros((1, 32, 80)), jnp.zeros((1, 16, 80)))
    g_vars = {"params": _perturbed(gv["params"], 1), "vq_stats": _perturbed(gv["vq_stats"], 2)}
    plm_p = _perturbed(MegaPLM(plm_cfg).init(
        KEY, jnp.zeros((1, 4, 16)), jnp.zeros((1, 5), jnp.int32), jnp.asarray([4]))["params"], 3)
    adm_p = _perturbed(MegaADM(adm_cfg).init(
        KEY, jnp.zeros((1, 4, 16)), jnp.zeros((1, 5, 1)), jnp.asarray([4]))["params"], 12)
    adm_p["predict_layer"]["kernel"] = adm_p["predict_layer"]["kernel"] * 30.0
    adm_p["dt_linear_emb"]["kernel"] = adm_p["dt_linear_emb"]["kernel"] * 0.005

    def bf16(tree):  # JAX's Megatts(cast_params=True)
        return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), tree)

    jax_side = dict(g=({"params": bf16(g_vars["params"]), "vq_stats": g_vars["vq_stats"]}, g_cfg),
                    plm=(bf16(plm_p), plm_cfg), adm=(bf16(adm_p), adm_cfg))
    return jax_side, (g_vars, plm_p, adm_p)


def _port(models, dtype):
    """The port's modules cast as ``Megatts(dtype=...)`` casts them."""
    from megatts2_tpu_torch import models as tm
    from megatts2_tpu_torch.models.megatts import _cast_
    from megatts2_tpu_torch.quantization.weight_only import cast_float_

    (_, g_cfg), (_, plm_cfg), (_, adm_cfg) = (models[0][k] for k in ("g", "plm", "adm"))
    g_vars, plm_p, adm_p = models[1]
    g = load_flax_params(tm.MegaG(_torch_cfg(g_cfg)), g_vars).eval()
    plm = load_flax_params(tm.MegaPLM(_torch_cfg(plm_cfg)), plm_p).eval()
    adm = load_flax_params(tm.MegaADM(_torch_cfg(adm_cfg)), adm_p).eval()
    _cast_(g, dtype, keep=("vqpe.vq",))
    cast_float_(plm, dtype)
    adm.to(dtype)
    return g, plm, adm


def _phones(seed=7):
    rng = np.random.RandomState(seed)
    lens = np.array([24, 17, 9, 24], np.int32)
    phone = rng.randint(1, 40, (B, TP)).astype(np.int32)
    for b in range(B):
        phone[b, lens[b]:] = 0
    return phone, lens, rng.randn(B, 40, 80).astype(np.float32)


def _gaps(port_fn, want):
    """{dtype: max |port - want|} for the bf16 port and its fp32 control."""
    return {name: float(np.abs(port_fn(dtype) - want).max())
            for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32))}


def _assert_bit_equal_and_controls_miss(gaps, default_gap):
    assert gaps["bf16"] == 0.0, gaps
    assert gaps["fp32"] > 0.0 and default_gap > 0.0, (gaps, default_gap)


def _jax_tc(models, jit):
    from megatts2_tpu.models import MegaG

    g_vars, g_cfg = models[0]["g"]
    phone, lens, mels = _phones()
    jg = MegaG(g_cfg, dtype=jnp.bfloat16)

    def f(v, p, ln, m):
        return jg.apply(v, p, m, ln, method=lambda mm, a, b, c: mm.mrte.tc_latent(a, b, c))

    with _jax_flash():
        out = jit(f, g_vars, jnp.asarray(phone), jnp.asarray(lens), jnp.asarray(mels))
    return np.array(out.astype(jnp.float32))


def test_mrte_tc_latent_bf16_rounds_as_flax(models):
    phone, lens, mels = _phones()
    want = _jax_tc(models, _rounded)
    keep = (np.arange(TP)[None] < lens[:, None])[..., None]

    def port(dtype):
        g = _port(models, dtype)[0]
        with torch.inference_mode():
            tc = g.mrte.tc_latent(torch.from_numpy(phone).long(), torch.from_numpy(mels).to(dtype),
                                  torch.from_numpy(lens).long())
        return tc.float().numpy() * keep

    default = float(np.abs((_jax_tc(models, _default) - want) * keep).max())
    _assert_bit_equal_and_controls_miss(_gaps(port, want * keep), default)


def _jax_decode(module_cls, params, cfg, T, first, jit):
    """A flax decode loop, each step one call of ``jit`` (step 0 too)."""
    model = module_cls(cfg, dtype=jnp.bfloat16, decode=True, max_decode_len=T)

    def step0(p, a, b, t):
        return model.apply({"params": p}, a, b, t, method=module_cls.decode_step, mutable=["cache"])

    def step(p, c, a, b, t):
        return model.apply({"params": p, **c}, a, b, t, method=module_cls.decode_step,
                           mutable=["cache"])

    out, cache = jit(step0, params, *first(0, None), jnp.asarray(0, jnp.int32))
    outs = [out]
    for t in range(1, T):
        out, cache = jit(step, params, cache, *first(t, out), jnp.asarray(t, jnp.int32))
        outs.append(out)
    return np.stack([np.asarray(o) for o in outs], 1)


def test_adm_raw_durations_bf16_round_as_flax(models):
    """The ADM decode from the same bf16 tc_latent: each step feeds back its
    own raw prediction, so one differing rounding would show downstream."""
    from megatts2_tpu.models.adm import MegaADM as JADM
    from megatts2_tpu_torch.models.fast_decode import adm_decode_raw

    adm_p, adm_cfg = models[0]["adm"]
    tc = _jax_tc(models, _rounded)

    def first(t, prev):
        return jnp.asarray(tc[:, t:t + 1]), (jnp.zeros((B,), jnp.float32) if prev is None else prev)

    want = _jax_decode(JADM, adm_p, adm_cfg, TP, first, _rounded)
    default = _jax_decode(JADM, adm_p, adm_cfg, TP, first, _default)

    def port(dtype):
        adm = _port(models, dtype)[2]
        with torch.inference_mode():
            return adm_decode_raw(adm, torch.from_numpy(tc)).numpy()

    assert np.abs(want).max() > 10  # durations of several frames
    _assert_bit_equal_and_controls_miss(_gaps(port, want), float(np.abs(default - want).max()))


def test_plm_decode_logits_bf16_round_as_flax(models):
    """Every step's logits, both sides fed the same previous codes."""
    from megatts2_tpu.models.plm import MegaPLM as JPLM
    from megatts2_tpu_torch.models.fast_decode import plm_decode_step

    plm_p, plm_cfg = models[0]["plm"]
    T = 12
    rng = np.random.RandomState(8)
    tcp = rng.randn(B, T, 16).astype(np.float32)
    codes = rng.randint(0, 32, (B, T)).astype(np.int32)
    prev = np.concatenate([np.full((B, 1), plm_cfg.bos_id, np.int32), codes[:, :-1]], 1)

    def first(t, _):
        return jnp.asarray(tcp[:, t:t + 1]), jnp.asarray(prev[:, t])

    want = _jax_decode(JPLM, plm_p, plm_cfg, T, first, _rounded)
    default = _jax_decode(JPLM, plm_p, plm_cfg, T, first, _default)

    def port(dtype):
        plm = _port(models, dtype)[1]
        with torch.inference_mode():
            caches = plm.plm.new_cache(B, T, torch.zeros(1, dtype=plm.plm.dtype))
            return np.stack([plm_decode_step(plm, torch.from_numpy(tcp[:, t]),
                                             torch.from_numpy(prev[:, t]).long(), caches, t).numpy()
                             for t in range(T)], 1)

    _assert_bit_equal_and_controls_miss(_gaps(port, want), float(np.abs(default - want).max()))


def test_decode_latents_bf16_rounds_as_flax(models):
    from megatts2_tpu.models import MegaG

    g_vars, g_cfg = models[0]["g"]
    rng = np.random.RandomState(9)
    tce = rng.randn(B, 32, 16).astype(np.float32)
    zq = rng.randn(B, 32, 8).astype(np.float32)
    jg = MegaG(g_cfg, dtype=jnp.bfloat16)

    def f(v, a, b):
        return jg.apply(v, a, b, method=lambda m, x, z: m.decode_latents(x, z)).astype(jnp.float32)

    args = (g_vars, jnp.asarray(tce, jnp.bfloat16), jnp.asarray(zq, jnp.bfloat16))
    want = np.asarray(_rounded(f, *args))
    default = float(np.abs(np.asarray(_default(f, *args)) - want).max())

    def port(dtype):
        g = _port(models, dtype)[0]
        x, z = (torch.from_numpy(a).to(torch.bfloat16).to(dtype) for a in (tce, zq))
        with torch.inference_mode():
            return g.decode_latents(x, z).float().numpy()

    _assert_bit_equal_and_controls_miss(_gaps(port, want), default)


# ------------------------------------------------------------- train steps


def _jax_grads(create, make_step, cfg, batch, flash, **kw):
    """(initial params, gradients, metrics) of one bf16 step, every op rounded."""
    from jax.experimental.pallas import tpu as pltpu

    from megatts2_tpu.config import TrainConfig
    from megatts2_tpu.nn import transformer as tr

    jtc = TrainConfig(max_steps=100, warmup_steps=1, initial_learning_rate=LR,
                      train_dtype="bfloat16")
    state, _ = create(KEY, cfg, jtc, batch)
    params0 = jax.tree_util.tree_map(np.asarray, state.params)
    tr.FLASH_ON_CPU = flash
    try:
        with pltpu.force_tpu_interpret_mode():
            grab = make_step(cfg, jtc, _grab_grads(), **kw)[0]
            grabbed, m = _rounded(grab, state.replace(opt=_grab_grads().init(state.params)),
                                  jax.tree_util.tree_map(jnp.asarray, batch))
    finally:
        tr.FLASH_ON_CPU = False
    return params0, jax.tree_util.tree_map(np.asarray, grabbed.opt), {k: float(v) for k, v in m.items()}


def _step_gaps(create, make, cfg, params0, grads, jm, batch, template):
    """{dtype: (largest relative metric gap, largest gradient gap over the
    largest gradient)} for the port's bf16 step and its fp32 control."""
    want = dict(load_flax_params(template, grads).named_parameters())
    scale = max(w.abs().max().item() for w in want.values())
    out = {}
    for dtype in ("bfloat16", "float32"):
        t = tcfg.TrainConfig(max_steps=100, warmup_steps=1, initial_learning_rate=LR,
                             train_dtype=dtype)
        st = create(_torch_cfg(cfg), t, device="cpu")
        load_flax_params(st.model, params0)
        m = {k: float(v) for k, v in make(_torch_cfg(cfg), t)[0](st, batch).items()}
        metric = max(abs(m[k] - jm[k]) / max(abs(jm[k]), 1e-12) for k in jm)
        grad = max((p.grad - want[n]).abs().max().item() for n, p in st.model.named_parameters())
        out[dtype] = (metric, grad / scale)
    return out


@pytest.mark.parametrize("stage", ["plm", "adm"])
def test_train_step_bf16_close_to_flax(stage):
    from megatts2_tpu import training as jtr
    from megatts2_tpu_torch import training as ttr
    from megatts2_tpu_torch.models import MegaADM, MegaPLM

    if stage == "plm":
        cfg, batch, flash, tol = _plm_cfg(), _plm_batch(_plm_cfg()), True, (1e-6, 1e-2)
        jc, jm_, tc_, tm_, tmpl = (jtr.create_plm_state, jtr.make_plm_train_step,
                                   ttr.create_plm_state, ttr.make_plm_train_step, MegaPLM)
    else:
        cfg, batch, flash, tol = _adm_cfg(), _adm_batch(), False, (1e-6, 5e-3)
        jc, jm_, tc_, tm_, tmpl = (jtr.create_adm_state, jtr.make_adm_train_step,
                                   ttr.create_adm_state, ttr.make_adm_train_step, MegaADM)
    params0, grads, jm = _jax_grads(jc, jm_, cfg, batch, flash)
    gaps = _step_gaps(tc_, tm_, cfg, params0, grads, jm, batch, tmpl(_torch_cfg(cfg)))
    assert gaps["bfloat16"][0] <= tol[0] and gaps["bfloat16"][1] <= tol[1], gaps
    assert gaps["float32"][0] > tol[0] and gaps["float32"][1] > tol[1], gaps
