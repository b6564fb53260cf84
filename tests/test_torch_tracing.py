"""The port's tracer (``megatts2_tpu_torch/utils/tracing.py``) and the spans
the port takes with it, on the CPU at tiny widths.

* Off, nothing is recorded, and a span and a record each cost a fraction
  of a microsecond (``timeit`` over 10^5 calls, printed).
* On: nested spans with their ``n``, the bounded buffer, ``drain``, and
  tallies (their prefixes, ``keep``, ``summary``), neither reader clearing
  the other; a span is an event of a CPU-activity ``torch.profiler`` trace.
* ``synthesize`` takes the five ``synth.*`` spans, ``adm.decode`` and
  ``plm.decode`` with ``n`` = T, and ``plm.prefill`` with a prompt; its
  outputs are bitwise equal with the tracer on and off, and ``stage_times``
  is still filled.
* A PLM train step takes the four ``train.*`` spans, ``n`` of
  ``train.batch_to_device`` the batch's bytes; ``run_training``'s ``loop/``
  row is read from its ``loop.*`` spans, and the tracer and its buffer are
  left as found; a ``trace_dir`` profile holds each profiled step's loop
  and step spans.
"""
import collections
import json
import sys
import timeit

import numpy as np
import pytest
import torch

from megatts2_tpu_torch.config import (MegaADMConfig, MegaGConfig, MegaPLMConfig, MRTEConfig,
                                       TrainConfig, VocosConfig, VQPEConfig)
from megatts2_tpu_torch.utils import tracing


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _names(spans):
    return collections.Counter(s[0] for s in spans)


def test_off_records_nothing_and_costs_under_two_microseconds():
    def with_span():
        with tracing.span("off.span", 3):
            pass

    cost = {}
    with tracing.tally("") as every:
        for label, fn in (("span", with_span),
                          ("record", lambda: tracing.record("off.record", 0, 1, 2))):
            cost[label] = timeit.timeit(fn, number=100_000) / 100_000 * 1e6
    print("tracer off, µs a call:", {k: round(v, 3) for k, v in cost.items()})
    assert tracing.drain() == []
    assert every.summary() == {}
    # a loose bound: the suite shares the host's cores with other workers
    assert all(v < 10.0 for v in cost.values()), cost


def test_on_nested_spans_counters_drain_and_summary():
    tracing.enable()
    with tracing.span("outer", 2):
        with tracing.span("inner", 5):
            pass
    tracing.record("wait", 1_000_000, 4_000_000, 1)
    spans = tracing.drain()
    assert [(s[0], s[3]) for s in spans] == [("inner", 5), ("outer", 2), ("wait", 1)]
    inner, outer = spans[0], spans[1]
    assert outer[1] <= inner[1] <= inner[2] <= outer[2]
    assert tracing.drain() == []

    tracing.record("q.early", 0, 1)  # before the tally opens
    with tracing.tally(("q.", "r.wait")) as q:
        for ms in (1, 2, 3, 4, 100):
            tracing.record("q.wait", 0, ms * 1_000_000)
        tracing.record("r.wait", 0, 1_000_000)
        tracing.record("other", 0, 1)
        assert len(tracing.drain()) == 8  # draining the buffer leaves the tally whole
    tracing.record("q.wait", 0, 1)  # after it closed
    s = q.summary()
    assert list(s) == ["q.wait", "r.wait"]
    assert s["q.wait"]["count"] == 5 and s["r.wait"]["count"] == 1
    assert s["q.wait"]["p50_ms"] == pytest.approx(np.percentile([1, 2, 3, 4, 100], 50))
    assert s["q.wait"]["p95_ms"] == pytest.approx(np.percentile([1, 2, 3, 4, 100], 95))
    assert s["q.wait"]["mean_ms"] == pytest.approx(22.0)
    assert q.durations_ms("q.wait") == [1.0, 2.0, 3.0, 4.0, 100.0]
    assert q.durations_ms("q.wait", 2) == [4.0, 100.0] and q.durations_ms("none") == []
    assert tracing._tallies == []


def test_the_buffer_and_the_summary_are_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "_spans", collections.deque(maxlen=4))
    tracing.enable()
    with tracing.tally("b", keep=3) as last, tracing.tally("b", keep=None) as every:
        for k in range(6):
            tracing.record("b", 0, (k + 1) * 1_000_000, k)
    s = last.summary()["b"]
    assert s["count"] == 6 and s["p50_ms"] == pytest.approx(5.0)  # of the last 3: 4, 5, 6 ms
    assert every.durations_ms("b") == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    with tracing.tally("x") as default:
        assert default.keep == tracing.RECENT == 1024
    assert [sp[3] for sp in tracing.drain()] == [2, 3, 4, 5]


def test_records_from_many_threads_are_all_kept():
    import threading

    tracing.enable()

    def work():
        for _ in range(500):
            with tracing.span("t.span"):
                tracing.record("t.record", 0, 1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often, so a lost update would show
    try:
        with tracing.tally("t.") as t_spans:
            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    s = t_spans.summary()
    assert s["t.span"]["count"] == s["t.record"]["count"] == 4000
    assert len(tracing.drain()) == 8000


def test_a_span_is_an_event_of_a_cpu_profiler_trace():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("off.not.traced"):
            torch.ones(4).sum()
        tracing.enable()
        with tracing.span("on.traced", 1):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "on.traced" in names and "off.not.traced" not in names
    assert _names(tracing.drain()) == {"on.traced": 1}


# ---------------------------------------------------------------- synthesis


def _tiny_stack():
    from megatts2_tpu_torch.models import MegaADM, MegaG, MegaPLM, Vocos, init_random_

    g = MegaG(MegaGConfig(
        mrte=MRTEConfig(mel_n_layer=2, mel_n_stack=1, mel_n_block=1, content_ff_dim=64,
                        content_n_heads=2, content_n_layers=2, hidden_size=32),
        vqpe=VQPEConfig(hidden_size=16, n_layers=1, n_stacks=1, n_blocks=1, vq_bins=64, vq_dim=16),
        hidden_size=32, decoder_n_stack=1, decoder_n_block=2))
    plm = MegaPLM(MegaPLMConfig(n_layers=2, n_heads=2, vq_dim=16, tc_latent_dim=32, vq_bins=64,
                                use_flash=False))
    adm = MegaADM(MegaADMConfig(n_layers=2, n_heads=2, emb_dim=16, tc_latent_dim=32,
                                tc_emb_dim=16))
    voc = Vocos(VocosConfig(dim=32, intermediate_dim=48, num_layers=2))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        return [init_random_(m, gen).eval() for m in (g, plm, adm, voc)]


@pytest.fixture(scope="module")
def stack():
    return _tiny_stack()


def _synth(stack, **kw):
    from megatts2_tpu_torch.models import synthesize

    rng = np.random.RandomState(0)
    phones = torch.from_numpy(rng.randint(1, 300, (2, 12)))
    mels = torch.from_numpy(rng.randn(2, 48, 80).astype(np.float32))
    return synthesize(*stack, phones, torch.tensor([12, 9]), mels, 64, **kw)


def test_synthesize_takes_its_spans_and_gives_the_same_bits(stack):
    off = _synth(stack)
    assert tracing.drain() == []
    tracing.enable()
    times = {}
    on = _synth(stack, stage_times=times)
    spans = tracing.drain()
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    stages = ("mrte", "adm", "plm", "decoder", "vocoder")
    assert set(times) == set(stages) and all(v >= 0 for v in times.values())
    got = {s[0]: s for s in spans}
    assert _names(spans) == {**{f"synth.{k}": 1 for k in stages}, "adm.decode": 1,
                             "plm.decode": 1}
    assert got["adm.decode"][3] == 12  # T phones
    assert got["plm.decode"][3] == 64 // 8  # T codes: the frame budget / 8
    # the stages tile the call in order; the decodes sit inside theirs
    marks = [got[f"synth.{k}"] for k in stages]
    assert all(a[2] <= b[1] for a, b in zip(marks, marks[1:]))
    for dec in ("adm", "plm"):
        assert got[f"synth.{dec}"][1] <= got[f"{dec}.decode"][1] <= got[f"{dec}.decode"][2] \
            <= got[f"synth.{dec}"][2]


def test_a_prompted_decode_takes_the_prefill_span(stack):
    from megatts2_tpu_torch.models import plm_infer

    plm = stack[1]
    rng = np.random.RandomState(1)
    tc = torch.from_numpy(rng.randn(2, 5, 32).astype(np.float32))
    ptc = torch.from_numpy(rng.randn(2, 7, 32).astype(np.float32))
    pcodes = torch.from_numpy(rng.randint(0, 64, (2, 7)))
    off = plm_infer(plm, tc, prompt_tc=ptc, prompt_codes=pcodes)
    tracing.enable()
    on = plm_infer(plm, tc, prompt_tc=ptc, prompt_codes=pcodes)
    spans = tracing.drain()
    assert torch.equal(off, on)
    assert [(s[0], s[3]) for s in spans] == [("plm.prefill", 7), ("plm.decode", 5)]


# ---------------------------------------------------------------- training


def _plm_train(device="cpu"):
    from megatts2_tpu_torch.training import create_plm_state, make_plm_train_step

    cfg = MegaPLMConfig(n_layers=1, n_heads=2, vq_dim=16, tc_latent_dim=16, vq_bins=32,
                        dropout=0.0, use_flash=False)
    tcfg = TrainConfig(warmup_steps=2, max_steps=100)
    state = create_plm_state(cfg, tcfg, device=device)
    rng = np.random.RandomState(0)
    B, L = 3, 10
    batch = {"p_codes": rng.randint(0, 32, (B, L + 1)).astype(np.int32),
             "tc_latents": rng.randn(B, L, 16).astype(np.float16),
             "lens": np.array([10, 7, 4], np.int32)}
    return make_plm_train_step(cfg, tcfg)[0], state, batch


def test_a_train_step_takes_its_four_spans():
    step, state, batch = _plm_train()
    tracing.enable()
    step(state, batch)
    spans = tracing.drain()
    names = ["train.batch_to_device", "train.forward", "train.backward", "train.optimizer"]
    assert [s[0] for s in spans] == names
    assert spans[0][3] == sum(v.nbytes for v in batch.values())
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("was_on", [False, True])
def test_run_training_reads_its_loop_row_from_the_loop_spans(tmp_path, was_on):
    from megatts2_tpu_torch.training import run_training

    step, state, batch = _plm_train()
    if was_on:
        tracing.enable()
        tracing.record("caller.span", 0, 1)
    run_training("plm", state, step, lambda epoch: [batch] * 3, max_steps=5,
                 log_dir=str(tmp_path), log_every=2, val_every=0)
    assert tracing.enabled() == was_on and tracing._tallies == []  # left as found
    with open(tmp_path / "plm_metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    loop = [r for r in rows if "loop/steps" in r]
    assert len(loop) == 1 and loop[0]["loop/steps"] == 5
    assert set(loop[0]) == {"step", "time", "loop/steps", "loop/step_ms_median",
                            "loop/loader_wait_ms_median", "loop/loader_wait_ms_mean"}
    assert loop[0]["loop/step_ms_median"] > 0 and loop[0]["loop/loader_wait_ms_median"] >= 0
    train = [r for r in rows if "train/steps_per_sec" in r]
    assert [r["step"] for r in train] == [2, 4] and all(r["train/steps_per_sec"] > 0 for r in train)
    spans = tracing.drain()
    names = _names(spans)
    assert names["loop.loader_wait"] == 5 and names["loop.step"] == 5
    assert names["train.forward"] == 5 and names["caller.span"] == int(was_on)
    # the row is the run's spans, every one of them
    walls = [(t1 - t0) / 1e6 for n, t0, t1, _ in spans if n == "loop.step"]
    waits = [(t1 - t0) / 1e6 for n, t0, t1, _ in spans if n == "loop.loader_wait"]
    assert loop[0]["loop/step_ms_median"] == pytest.approx(np.median(walls[1:]))
    assert loop[0]["loop/loader_wait_ms_mean"] == pytest.approx(np.mean(waits))


def test_a_trace_dir_profile_holds_the_loop_and_step_spans(tmp_path):
    from megatts2_tpu_torch.training import run_training

    step, state, batch = _plm_train()
    run_training("plm", state, step, lambda epoch: [batch] * 20, max_steps=14,
                 log_dir=str(tmp_path), log_every=100, val_every=0,
                 trace_dir=str(tmp_path / "trace"))
    with open(tmp_path / "trace" / "trace_steps_10-13.json") as f:
        names = collections.Counter(ev.get("name") for ev in json.load(f)["traceEvents"])
    assert names["loop.step"] == 3  # steps 10, 11 and 12, each whole
    for name in ("train.batch_to_device", "train.forward", "train.backward", "train.optimizer"):
        assert names[name] == 3, name
