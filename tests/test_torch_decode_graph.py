"""The PLM and ADM decode steps that the card replays as CUDA graphs
(``fast_decode.PLMStepGraph``, ``fast_decode.ADMStepGraph``), run eagerly on
the CPU: every row at one position held on the device, the whole cache
attended with the positions above it masked (``DecoderLayer.step_slots``).
Held against the eager loops (``plm_fast_decode`` and ``adm_decode_raw`` on
the CPU, one sliced ``DecoderLayer.step`` a layer) and against JAX's
``plm_fast_decode`` and ``adm_fast_decode``, in fp32 at tiny widths: codes
and rounded durations equal; the PLM's logits, teacher-forced on the codes,
and the ADM's raw predictions within 1e-5 of the largest (fp32 sums over a
longer, masked row).  The card's own replay is held in
``tests/test_torch_cuda_graph.py``."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from megatts2_tpu_torch import config as tcfg
from megatts2_tpu_torch.bridge import load_flax_params
from megatts2_tpu_torch.quantization.weight_only import quantize_

KEY = jax.random.PRNGKey(0)
B, T, P = 3, 10, 6
TEMPERATURE = 0.8


def _torch_cfg(jax_cfg):
    return getattr(tcfg, type(jax_cfg).__name__)(
        **{f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)})


@pytest.fixture(scope="module")
def plm_pair():
    from megatts2_tpu import config as jcfg
    from megatts2_tpu.models import MegaPLM as JPLM
    from megatts2_tpu.quantization.weight_only import quantize_tree
    from megatts2_tpu_torch.models import MegaPLM

    jc = jcfg.MegaPLMConfig(n_layers=2, n_heads=2, vq_dim=8, tc_latent_dim=16, vq_bins=32,
                            dropout=0.0)
    params = JPLM(jc).init(KEY, jnp.zeros((1, 4, 16)), jnp.zeros((1, 5), jnp.int32),
                           jnp.asarray([4]))["params"]
    rng = np.random.RandomState(21)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + np.float32(0.1) * rng.randn(*np.shape(x)).astype(np.float32),
        params)
    qparams = jax.tree_util.tree_map(np.asarray, quantize_tree(params, 8))
    return {"cfg": jc,
            "float": (params, load_flax_params(MegaPLM(_torch_cfg(jc)), params)),
            "int8": (qparams, load_flax_params(quantize_(MegaPLM(_torch_cfg(jc)), 8), qparams))}


def _decode_inputs(case, model, jc):
    """Keyword arguments of the port's decode and of JAX's for one case."""
    r = np.random.RandomState(22)
    tc = r.randn(B, T, 16).astype(np.float32)
    port, jax_kw = {}, {}
    if case == "sampled":
        rng = jax.random.PRNGKey(23)
        port = {"temperature": TEMPERATURE, "top_k": 8, "gumbel": torch.from_numpy(np.stack([
            np.asarray(jax.random.gumbel(jax.random.fold_in(rng, t), (B, jc.vq_bins)))
            for t in range(T)]))}
        jax_kw = {"temperature": TEMPERATURE, "top_k": 8, "rng": rng}
    elif case == "prompted":
        ptc = torch.from_numpy(r.randn(B, P, 16).astype(np.float32))
        pcodes = torch.from_numpy(r.randint(0, jc.vq_bins, (B, P)))
        prev = torch.cat([torch.full((B, 1), jc.bos_id), pcodes[:, :-1]], dim=1)
        with torch.inference_mode():
            caches = model.plm.new_cache(B, P + T, torch.from_numpy(tc))
            model.prefill(ptc, prev, caches)
        D = jc.vq_dim + jc.tc_latent_dim
        stack = torch.stack(caches).numpy()
        port = {"init_cache": caches, "start_pos": P, "prev0": pcodes[:, -1]}
        jax_kw = {"init_cache": (jnp.asarray(stack[..., :D]), jnp.asarray(stack[..., D:])),
                  "start_pos": P, "prev0": jnp.asarray(pcodes[:, -1].numpy(), jnp.int32)}
    return tc, port, jax_kw


def _static_decode(model, tc, kw):
    """The captured step's function, run eagerly: codes, and each step's
    logits teacher-forced on them."""
    from megatts2_tpu_torch.models.fast_decode import PLMStepGraph

    start = kw.get("start_pos", 0)
    g = PLMStepGraph(model, B, start + T, tc.device)
    with torch.inference_mode():
        codes = g.decode(model, tc, kw.get("temperature", 0.0), kw.get("top_k", 0), None,
                         kw.get("gumbel"), kw.get("init_cache"), start, kw.get("prev0"))
    assert g.graph is None and int(g.pos[0]) == start + T
    return codes, g


def _teacher_forced(model, tc, kw, codes, step):
    """Each step's logits (B, T, V) with ``codes`` fed back: ``step(t, prev)``."""
    prev = kw.get("prev0", torch.full((B,), model.cfg.bos_id))
    out = []
    with torch.inference_mode():
        for t in range(T):
            out.append(step(t, prev))
            prev = codes[:, t]
    return torch.stack(out, dim=1).numpy()


@pytest.mark.parametrize("case", ["greedy", "sampled", "prompted", "int8"])
def test_static_step_matches_eager_loop_and_jax(plm_pair, case):
    """Codes of the static step == the eager loop's == JAX's
    ``plm_fast_decode``'s; logits teacher-forced on them agree."""
    from megatts2_tpu.models.fast_decode import plm_fast_decode as jax_decode
    from megatts2_tpu_torch.models.fast_decode import plm_decode_step, plm_fast_decode

    jc = plm_pair["cfg"]
    params, model = plm_pair["int8" if case == "int8" else "float"]
    tc_np, kw, jax_kw = _decode_inputs(case, model, jc)
    tc = torch.from_numpy(tc_np)
    ref = np.asarray(jax_decode(params, jc, jnp.asarray(tc_np), dtype=jnp.float32,
                                quant=case == "int8", **jax_kw))
    eager_kw = dict(kw)
    if case == "prompted":  # the eager loop writes into the caches it is given
        eager_kw["init_cache"] = [c.clone() for c in kw["init_cache"]]
    eager = plm_fast_decode(model, tc, **eager_kw)
    got, g = _static_decode(model, tc, kw)
    np.testing.assert_array_equal(eager.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref)) > 2

    start = kw.get("start_pos", 0)
    caches = [c.clone() for c in kw["init_cache"]] if case == "prompted" else \
        model.plm.new_cache(B, start + T, tc)
    want = _teacher_forced(model, tc, kw, got, lambda t, prev: plm_decode_step(
        model, tc[:, t], prev, caches, start + t))
    if case == "prompted":
        for dst, src in zip(g.caches, kw["init_cache"]):
            dst.copy_(src)
    else:
        g.cache.zero_()
    g.pos.fill_(start)

    def static_step(t, prev):
        g.tc_t.copy_(tc[:, t])
        g.prev.copy_(prev)
        g.step(model)
        return g.logits

    have = _teacher_forced(model, tc, kw, got, static_step)
    np.testing.assert_allclose(have, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_cpu_decode_stays_eager(plm_pair):
    """On the CPU ``plm_fast_decode`` captures and replays nothing."""
    from megatts2_tpu_torch.models import fast_decode

    model = plm_pair["float"][1]
    before = (fast_decode.plm_fast_decode.graph_captures,
              fast_decode.plm_fast_decode.graph_replays)
    fast_decode.plm_fast_decode(model, torch.randn(B, T, 16))
    assert (fast_decode.plm_fast_decode.graph_captures,
            fast_decode.plm_fast_decode.graph_replays) == before
    assert model not in fast_decode._graphs


@pytest.fixture(scope="module")
def adm_pair():
    from megatts2_tpu import config as jcfg
    from megatts2_tpu.models import MegaADM as JADM
    from megatts2_tpu.quantization.weight_only import quantize_tree
    from megatts2_tpu_torch.models import MegaADM

    jc = jcfg.MegaADMConfig(n_layers=2, n_heads=2, emb_dim=8, tc_latent_dim=16, tc_emb_dim=8,
                            dropout=0.0)
    params = JADM(jc).init(KEY, jnp.zeros((1, 4, 16)), jnp.zeros((1, 5, 1)),
                           jnp.asarray([4]))["params"]
    rng = np.random.RandomState(24)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + np.float32(0.1) * rng.randn(*np.shape(x)).astype(np.float32),
        params)
    # spread the durations over several frames, and keep the raw feedback
    # loop from growing geometrically (as tests/test_torch_decode.py)
    params["predict_layer"]["kernel"] = params["predict_layer"]["kernel"] * 10.0
    params["dt_linear_emb"]["kernel"] = params["dt_linear_emb"]["kernel"] * 0.02
    qparams = jax.tree_util.tree_map(np.asarray, quantize_tree(params, 8))
    return {"cfg": jc,
            "float": (params, load_flax_params(MegaADM(_torch_cfg(jc)), params)),
            "int8": (qparams, load_flax_params(quantize_(MegaADM(_torch_cfg(jc)), 8), qparams))}


@pytest.mark.parametrize("case", ["float", "int8"])
def test_adm_static_step_matches_eager_loop_and_jax(adm_pair, case):
    """Raw predictions of the ADM's static step, run eagerly, within 1e-5 of
    the largest of the eager loop's; rounded durations == the eager loop's
    == JAX's ``adm_fast_decode``'s."""
    from megatts2_tpu.models.fast_decode import adm_fast_decode as jax_decode
    from megatts2_tpu_torch.models.fast_decode import (ADMStepGraph, adm_decode_raw,
                                                       adm_fast_decode)

    jc = adm_pair["cfg"]
    params, model = adm_pair[case]
    tc_np = np.random.RandomState(25).randn(B, 12, 16).astype(np.float32)
    tc = torch.from_numpy(tc_np)
    ref = np.asarray(jax_decode(params, jc, jnp.asarray(tc_np), dtype=jnp.float32,
                                quant=case == "int8"))
    eager = adm_decode_raw(model, tc).numpy()
    g = ADMStepGraph(model, B, 12, tc.device)
    with torch.inference_mode():
        got = g.decode(model, tc)
    assert g.graph is None and int(g.pos[0]) == 12
    assert got.data_ptr() != g.out.data_ptr()
    got = got.numpy()
    np.testing.assert_allclose(got, eager, rtol=0, atol=1e-5 * np.abs(eager).max())
    max_dt = jc.max_duration_token
    rounded = np.clip((got + 0.5).astype(np.int32), 1, max_dt)
    np.testing.assert_array_equal(rounded, np.clip((eager + 0.5).astype(np.int32), 1, max_dt))
    np.testing.assert_array_equal(adm_fast_decode(model, tc).numpy(), ref)
    np.testing.assert_array_equal(rounded, ref)
    assert len(np.unique(ref)) > 3, ref  # the test exercises real rounding


def test_adm_cpu_decode_stays_eager(adm_pair):
    """On the CPU ``adm_decode_raw`` captures and replays nothing."""
    from megatts2_tpu_torch.models import fast_decode

    model = adm_pair["float"][1]
    before = (fast_decode.adm_decode_raw.graph_captures,
              fast_decode.adm_decode_raw.graph_replays)
    fast_decode.adm_decode_raw(model, torch.randn(B, T, 16))
    assert (fast_decode.adm_decode_raw.graph_captures,
            fast_decode.adm_decode_raw.graph_replays) == before
    assert model not in fast_decode._graphs
