"""The port's continuous slot engine (``megatts2_tpu_torch/continuous.py``)
and its per-slot PLM decode, on the CPU at tiny widths, fp32, on the tiny
cascade of ``test_torch_streaming.py``.

* The per-slot decode with every slot at one position gives the scalar
  decode's codes (equal).
* Each request's output equals the port's one-shot ``synthesize`` at the
  engine's frame budget, with a request admitted mid-flight, unprompted
  and prompted, and with ``admit_tp_bucket`` (same length; atol 1e-4, as
  ``tests/test_continuous.py``).
* The port's engine equals JAX's ``ContinuousEngine`` (lengths equal, atol
  1e-3: fp32 through the cascade, as ``tests/test_torch_slice.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_streaming import build_cascade, padded_phones, port_synthesize

F_CHUNK = 32
MAX_FRAMES = 96


@pytest.fixture(scope="module")
def cascade():
    return build_cascade()


def _requests(seed=0, tps=(40, 64, 24)):
    rng = np.random.RandomState(seed)
    return [{"id": f"r{i}", "phone": rng.randint(1, 40, (1, tp)).astype(np.int64),
             "lens": np.full((1,), tp, np.int64),
             "mels_prompt": rng.randn(1, 64, 80).astype(np.float32)}
            for i, tp in enumerate(tps)]


def _engine(cascade, **kw):
    from megatts2_tpu_torch.continuous import ContinuousEngine

    return ContinuousEngine(*cascade["port"](), slots=2, max_frames=MAX_FRAMES,
                            chunk_frames=F_CHUNK, device="cpu", **kw)


def test_per_slot_decode_equals_scalar_decode_when_aligned(cascade):
    from megatts2_tpu_torch.models.fast_decode import plm_fast_decode, plm_fast_tick

    plm = cascade["port"]()[1]
    rng = np.random.RandomState(0)
    tc = torch.from_numpy(rng.randn(3, 10, 16).astype(np.float32))
    ref = plm_fast_decode(plm, tc)
    S, T = 3, 10
    caches = plm.plm.new_cache(S, T, tc)
    codes = torch.zeros((S, T), dtype=torch.long)
    prev = torch.full((S,), plm.cfg.bos_id, dtype=torch.long)
    zeros = torch.zeros((S,), dtype=torch.long)
    with torch.inference_mode():
        plm_fast_tick(plm, tc, caches, codes, prev, zeros, zeros, torch.full((S,), T), T)
    torch.testing.assert_close(codes, ref, rtol=0, atol=0)
    assert len(torch.unique(ref)) > 2


def test_per_slot_decode_freezes_finished_slots(cascade):
    """A slot past its total keeps its codes; the others run on."""
    from megatts2_tpu_torch.models.fast_decode import plm_fast_tick

    plm = cascade["port"]()[1]
    tc = torch.from_numpy(np.random.RandomState(1).randn(2, 8, 16).astype(np.float32))
    caches = plm.plm.new_cache(2, 8, tc)
    codes = torch.full((2, 8), -1, dtype=torch.long)
    prev = torch.full((2,), plm.cfg.bos_id, dtype=torch.long)
    with torch.inference_mode():
        prev, pos = plm_fast_tick(plm, tc, caches, codes, prev, torch.zeros(2, dtype=torch.long),
                                  torch.zeros(2, dtype=torch.long), torch.tensor([3, 8]), 8)
    assert pos.tolist() == [3, 8]
    assert (codes[0, 3:] == -1).all() and (codes[0, :3] >= 0).all() and (codes[1] >= 0).all()


def _assert_engine_equals_synthesize(cascade, eng, reqs, got, prompts=None):
    assert set(got) == {r["id"] for r in reqs}
    for r in reqs:
        kw = {}
        if prompts and r["id"] in prompts:
            tc, codes = prompts[r["id"]]
            kw = dict(plm_prompt_tc=torch.from_numpy(tc[None]),
                      plm_prompt_codes=torch.from_numpy(codes[None]).long())
        want, n = port_synthesize(cascade, padded_phones(r["phone"]), r["lens"], r["mels_prompt"],
                                  eng.Tmax, **kw)
        assert got[r["id"]].shape == want.shape, r["id"]
        np.testing.assert_allclose(got[r["id"]], want, rtol=1e-4, atol=1e-4, err_msg=r["id"])


def test_engine_equals_synthesize_with_a_mid_flight_admission(cascade):
    reqs = _requests()
    eng = _engine(cascade)
    got = dict(eng.run(reqs))
    assert eng.n_ticks > 0
    _assert_engine_equals_synthesize(cascade, eng, reqs, got)
    assert len({v.shape[0] for v in got.values()}) == 3  # three lengths


def test_engine_spans_each_request_and_each_tick(cascade):
    """With the tracer on, a run records one ``engine.queue_wait`` and one
    ``engine.first_chunk`` a request, an ``engine.tick`` a tick, and waves
    whose ``engine.admit`` counts sum to the requests."""
    from megatts2_tpu_torch.utils import tracing

    reqs = _requests(seed=2)
    eng = _engine(cascade)
    tracing.drain()
    tracing.enable()
    try:
        got = dict(eng.run(reqs))
    finally:
        tracing.disable()
    spans = tracing.drain()
    by = {}
    for name, t0, t1, n in spans:
        by.setdefault(name, []).append((t0, t1, n))
    assert set(got) == {r["id"] for r in reqs} and "t_submit_ns" not in reqs[0]
    assert len(by["engine.queue_wait"]) == len(by["engine.first_chunk"]) == len(reqs)
    assert len(by["engine.tick"]) == eng.n_ticks > 0
    assert all(n == F_CHUNK // 8 for _, _, n in by["engine.tick"])
    assert sum(n for _, _, n in by["engine.admit"]) == len(reqs)
    assert len(by["engine.emit"]) <= eng.n_ticks
    assert all(t1 >= t0 for v in by.values() for t0, t1, _ in v)
    # a list's requests are submitted when the run starts; chunks follow admissions
    assert len({t0 for k in ("engine.queue_wait", "engine.first_chunk") for t0, _, _ in by[k]}) == 1
    assert min(t1 for _, t1, _ in by["engine.first_chunk"]) > \
        min(t1 for _, t1, _ in by["engine.queue_wait"])


def test_admit_tp_bucket_pads_and_gives_the_same_output(cascade):
    reqs = _requests(seed=4, tps=(20, 31, 9))
    got = dict(_engine(cascade, admit_tp_bucket=32).run(reqs))
    eng = _engine(cascade)
    want = dict(eng.run(reqs))
    for r in reqs:
        assert got[r["id"]].shape == want[r["id"]].shape
    with pytest.raises(ValueError, match="admit_tp_bucket"):
        list(_engine(cascade, admit_tp_bucket=16).run(reqs))


def test_prompted_request_equals_synthesize(cascade):
    """One request with an in-context prompt, one without, sharing the
    engine; the prompt changes the output."""
    rng = np.random.RandomState(2)
    Pe = 16
    prompt = (rng.randn(Pe, 16).astype(np.float32), rng.randint(0, 32, (Pe,)).astype(np.int64))
    reqs = _requests(seed=2, tps=(40, 24))
    reqs[0]["prompt_tc"], reqs[0]["prompt_codes"] = prompt
    eng = _engine(cascade, prompt_tokens=Pe)
    got = dict(eng.run(reqs))
    _assert_engine_equals_synthesize(cascade, eng, reqs, got, prompts={"r0": prompt})
    plain = dict(_engine(cascade, prompt_tokens=Pe).run([{k: v for k, v in reqs[0].items()
                                                          if not k.startswith("prompt")}]))
    assert np.abs(plain["r0"] - got["r0"]).max() > 1e-3
    with pytest.raises(ValueError, match="prompt_tokens=0"):
        list(_engine(cascade).run(reqs))


def test_engine_equals_jax_engine(cascade):
    from megatts2_tpu.continuous import ContinuousEngine as JEngine

    reqs = _requests(seed=5)
    got = dict(_engine(cascade).run(reqs))
    jreqs = [{**r, "phone": r["phone"].astype(np.int32), "lens": r["lens"].astype(np.int32)}
             for r in reqs]
    jeng = JEngine(*cascade["vars"], *cascade["jcfgs"], slots=2, max_frames=MAX_FRAMES,
                   chunk_frames=F_CHUNK, dtype=jnp.float32)
    want = dict(jeng.run(jreqs))
    for r in reqs:
        assert got[r["id"]].shape == want[r["id"]].shape, r["id"]
        np.testing.assert_allclose(got[r["id"]], want[r["id"]], atol=1e-3, err_msg=r["id"])
